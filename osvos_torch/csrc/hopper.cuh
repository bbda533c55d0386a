// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (csrc/wgrad.cu, csrc/flatconv.cu, csrc/stem.cu, csrc/stem_wgrad.cu):
// mbarriers, TMA tile loads and stores, cp.async, wgmma shared-memory
// descriptors and products, and the tensor-map encoder.
//
// Each source that includes this header is its own shared library, so the
// helpers live in an anonymous namespace.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the phase of parity `parity` of `bar` to complete. A wait of
// more than about 10 s traps, so a fault in the ring ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 20000000000LL) {
      __trap();
    }
  }
}

// Initialise `stages` full barriers (one arrival: the producer's expect_tx)
// and empty barriers (`consumers` arrivals) and make them visible to TMA.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int stages, uint32_t consumers) {
  for (int i = 0; i < stages; ++i) {
    mbar_init(&full[i], 1);
    mbar_init(&empty[i], consumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait at named barrier `id` (1..15; 0 is __syncthreads) for `threads`
// threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA) accesses of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Lane 0 of a warp releases a stage once the whole warp is done with it.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// One 4-D box of `map` at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at `dst`; completion counts bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// The same for a 3-D map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// A TMA store of the 3-D box at `src` in shared memory to `map` at
// coordinates (c0, c1, c2), innermost first; elements outside the map are
// not written. It joins this thread's next bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The TMA stores a thread issued since its last commit form one group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's store groups still read shared
// memory (their sources may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's store groups are unfinished.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from global `src` (16-byte aligned) to shared `dst`, of which
// only the first `src_bytes` are read; the rest of `dst` is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wgmma shared-memory descriptor: start address, leading byte offset 16
// (one 64-channel block in M or N, so unused), stride byte offset `sbo`
// between groups of 8 rows, base offset 0, and the swizzle mode (1:
// 128-byte, 2: 64-byte, 3: 32-byte). The swizzle is taken on the absolute address bits,
// as TMA writes it, so a start some 128-byte rows into a 1024-byte aligned
// box needs no base offset (an offset of (addr >> 7) & 7 reads the wrong
// rows: H100).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}

// acc (64 x N, float32) += A . B for a 64 x 16 A and a 16 x N B, bf16, both
// from shared memory. kTA / kTB are the transpose bits: 1 for an MN-major
// operand (M or N contiguous), 0 for a K-major one (K contiguous).
template <int N, int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_16(float (&d)[8], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

#define OSVOS_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_32(float (&d)[16], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : OSVOS_F8(0), OSVOS_F8(8)
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_48(float (&d)[24], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : OSVOS_F8(0), OSVOS_F8(8), OSVOS_F8(16)
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_64(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : OSVOS_F8(0), OSVOS_F8(8), OSVOS_F8(16), OSVOS_F8(24)
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_128(float (&d)[64], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : OSVOS_F8(0), OSVOS_F8(8), OSVOS_F8(16), OSVOS_F8(24), OSVOS_F8(32),
        OSVOS_F8(40), OSVOS_F8(48), OSVOS_F8(56)
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

#undef OSVOS_F8

template <>
__device__ __forceinline__ void wgmma_bf16<16, 1, 1>(float (&d)[8], uint64_t a,
                                                     uint64_t b) {
  wgmma_bf16_16<1, 1>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<32, 1, 1>(float (&d)[16], uint64_t a,
                                                     uint64_t b) {
  wgmma_bf16_32<1, 1>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<48, 0, 0>(float (&d)[24], uint64_t a,
                                                     uint64_t b) {
  wgmma_bf16_48<0, 0>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<64, 1, 1>(float (&d)[32], uint64_t a,
                                                     uint64_t b) {
  wgmma_bf16_64<1, 1>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<64, 0, 0>(float (&d)[32], uint64_t a,
                                                     uint64_t b) {
  wgmma_bf16_64<0, 0>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_bf16<128, 0, 0>(float (&d)[64], uint64_t a,
                                                      uint64_t b) {
  wgmma_bf16_128<0, 0>(d, a, b);
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// kernel and device (the first 32 devices), not per launch: each launch
// function keeps one static SmemOnce per kernel it launches.
struct SmemOnce {
  std::atomic<unsigned> done{0};

  template <typename Kernel>
  int set(Kernel* kernel, int bytes) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 32)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (done.load(std::memory_order_acquire) & (1u << dev)) return 0;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done.fetch_or(1u << dev, std::memory_order_release);
    return 0;
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so that a library
// needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, nullptr);
    return e == cudaSuccess && p != nullptr ? reinterpret_cast<EncodeTiled>(p)
                                             : nullptr;
  }();
  return fn;
}

// A packed bf16 map of `rank` dimensions (innermost first) with box `box`,
// zero fill out of bounds. Returns 0 or an error code.
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint32_t* box,
                           CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// A 4-D bf16 map over (N, H, W, ch) with a (box_ch, box_w, box_h, 1) box,
// zero fill out of bounds. Returns 0 or an error code.
inline int encode_map(CUtensorMap* map, const void* base, int N, int H, int W,
                      int ch, int box_ch, int box_w, CUtensorMapSwizzle swizzle,
                      int box_h = 1) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ch),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_ch),
                             static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  return encode_bf16_map(map, base, 4, dims, box, swizzle);
}

}  // namespace
