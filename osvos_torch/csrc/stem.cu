// Forward of the 3x3 SAME stem conv (at most 3 input channels), NHWC, for
// Hopper (sm_90a).
//
// Replaces the stem variant of the TPU kernel
// osvos_tpu/ops/pallas/flatconv.py `_fwd_kernel` (B2, reached through
// `flat_conv3x3_input_packed`). For the image x (N, H, W, C <= 3) bf16, the
// float32 OIHW weight K (D, C, 3, 3) and bias b (D,) it computes
//
//   y[n, h, w, d] = bf16(relu(sum_{kh, kw, c} x[n, h + kh - 1, w + kw - 1, c]
//                                * bf16(K[d, c, kh, kw]) + b[d]))
//
// with x outside the image taken as zero, the bf16 products summed in
// float32, the bias added in float32 and one rounding at the end.
//
// Bound. At batch 5 on 480x854 with D = 64 it must read the image (12.3
// MB) and write y (262.3 MB): 0.082 ms at 3.35 TB/s, against 7.1 GFLOP on
// the tensor cores (0.007 ms). It is bound by the bytes of y, so the design
// keeps the stores streaming and stages the narrow image cheaply beside
// them.
//
// Design (csrc/stem.cuh has the parts it shares with B16):
// - A persistent grid: one block per SM, or one per image row where there
//   are fewer; block b takes a contiguous run of image rows (n, h).
// - The image rows come through a rolling strip of eight slots: each step
//   of three output rows (one a consumer warpgroup) reads rows r - 1 ..
//   r + 3 while the copies of rows r + 4 .. r + 6 are in flight. Three
//   warpgroups keep the stores streaming while each waits on its barriers
//   (H100: 0.117 ms with two, 0.105 with three, 0.101 with four, which
//   leaves room in shared memory for rows of at most about 900 pixels).
// - The block packs its bf16 weight operand (D_p x 32: [out][t * C + c], t
//   = 3 kh + kw, zero past 9 C and D, 64-byte swizzle) from the float32
//   OIHW weight itself and keeps it for its life: no pack launch.
// - A segment is 128 pixels of one image row. Each thread builds one
//   pixel's stacked row into the warpgroup's im2col tile (128 x 32, 64-byte
//   swizzle); two m64n64k16 wgmma steps per 64 pixels and 64 output
//   channels multiply it by the resident weights.
// - The epilogue adds the bias and applies the ReLU in registers, rounds to
//   bf16 once, and writes a 128-byte-swizzled staging tile (128 pixels x 64
//   channels) that one thread stores by TMA (cp.async.bulk.tensor). Two
//   staging tiles a warpgroup: the store of one segment drains while the
//   next is built and multiplied. TMA does not write a box's pixels past W
//   or channels past D.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "stem.cuh"

namespace {

constexpr int kNumSMs = 132;
constexpr int kWGs = 3;                        // consumer warpgroups, a row each
constexpr int kThreads = 128 * kWGs;
constexpr int kSlots = 2 * kWGs + 2;           // rows r - 1 .. r + 2 kWGs
constexpr int kMaxD = 256;
constexpr int kABytes = kStemSeg * kStemRowBytes;          // 8 KB im2col tile
constexpr int kStoreBytes = kStemSeg * kStemTileD * 2;     // 16 KB staging tile
constexpr int kStoreBufs = 2;                              // staging tiles a warpgroup
constexpr int kWGBytes = kABytes + kStoreBufs * kStoreBytes;
constexpr int kSmemLimit = 227 * 1024;

// Dynamic shared memory of a launch: the warpgroups' tiles, the weights,
// the strip and the zero row (ops/kernels/flatconv.py `stem_smem`).
inline int smem_bytes(const StemShape& s, int Dp) {
  return 1024 + kWGs * kWGBytes + Dp * kStemRowBytes + (kSlots + 1) * s.slot_bytes;
}

__device__ __forceinline__ float relu_bias(float v, float b) {
  const float t = v + b;
  return t > 0.f ? t : 0.f;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) stem_fwd_kernel(
    const __grid_constant__ CUtensorMap ymap, const uint8_t* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ bias,
    const StemShape s, int D, int Dp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  uint8_t* A = smem + wg * kWGBytes;
  uint8_t* wsm = smem + kWGs * kWGBytes;
  uint8_t* strip = wsm + Dp * kStemRowBytes;
  uint8_t* zero_row = strip + kSlots * s.slot_bytes;
  const long long r_lo = run_start(s.rows, blockIdx.x, gridDim.x);
  const long long r_hi = run_start(s.rows, blockIdx.x + 1, gridDim.x);

  // the strip and the zero row zeroed once; the resident weight operand
  for (int i = threadIdx.x; i < (kSlots + 1) * s.slot_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(strip)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < Dp * kStemK; e += kThreads) {
    const int d = e / kStemK, k = e % kStemK;
    const float v = d < D && k < 9 * C ? w[(d * C + k % C) * 9 + k / C] : 0.f;
    *reinterpret_cast<__nv_bfloat16*>(wsm + swz64(d, k >> 3) + (k & 7) * 2) =
        __float2bfloat16(v);
  }
  fence_proxy_async();
  __syncthreads();
  for (long long rr = r_lo - 1; rr <= r_lo + kWGs; ++rr)
    if (rr >= 0 && rr < s.rows)
      strip_load(strip_slot(strip, s, rr, kSlots), x, s, rr, threadIdx.x, kThreads);
  cp_async_commit();

  const uint32_t a_addr = smem_u32(A), w_addr = smem_u32(wsm);
  int sb = 0;  // this warpgroup's next staging tile
  for (long long r0 = r_lo; r0 < r_hi; r0 += kWGs) {
    // rows r0 - 1 .. r0 + kWGs have landed; zero their halo columns
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x < (kWGs + 2) * 2 * C) {
      const long long rr = r0 - 1 + threadIdx.x / (2 * C);
      if (rr >= 0 && rr < s.rows && rr <= r_hi)
        strip_halo(strip_slot(strip, s, rr, kSlots), s, rr, threadIdx.x % (2 * C));
    }
    __syncthreads();
    // the next step's new rows, into the slots of rows no step reads again
    for (long long rr = r0 + kWGs + 1; rr <= r0 + 2 * kWGs; ++rr)
      if (rr < s.rows && rr <= r_hi)
        strip_load(strip_slot(strip, s, rr, kSlots), x, s, rr, threadIdx.x, kThreads);
    cp_async_commit();

    const long long r = r0 + wg;
    if (r >= r_hi) continue;
    const int h = static_cast<int>(r % s.H);
    const uint8_t* const rows[3] = {tap_row(strip, zero_row, s, r, h, 0, kSlots),
                                    tap_row(strip, zero_row, s, r, h, 1, kSlots),
                                    tap_row(strip, zero_row, s, r, h, 2, kSlots)};
    for (int seg = 0; seg < s.segs; ++seg) {
      const int w0 = seg * kStemSeg;
      build_stacked<C>(A, rows, w0 + tid, s.W, tid);
      fence_proxy_async();
      named_sync(1 + wg, 128);
      for (int d0 = 0; d0 < Dp; d0 += kStemTileD) {
        float acc[2][kStemTileD / 2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < kStemTileD / 2; ++i) acc[m][i] = 0.f;
#pragma unroll
        for (int m = 0; m < 2; ++m) fence_acc(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int kk = 0; kk < kStemK / 16; ++kk)
            wgmma_bf16<kStemTileD, 0, 0>(
                acc[m], smem_desc(a_addr + m * 64 * kStemRowBytes + kk * 32, 512, 2),
                smem_desc(w_addr + d0 * kStemRowBytes + kk * 32, 512, 2));
        wgmma_commit();
        float2 b[kStemTileD / 8];
#pragma unroll
        for (int j = 0; j < kStemTileD / 8; ++j) {
          const int d = d0 + 8 * j + 2 * q;
          b[j] = d < D ? *reinterpret_cast<const float2*>(bias + d) : make_float2(0.f, 0.f);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < 2; ++m) fence_acc(acc[m]);
        // the store that last read this staging tile has read it
        if (tid == 0) bulk_wait_read<kStoreBufs - 1>();
        named_sync(1 + wg, 128);
        uint8_t* out = A + kABytes + sb * kStoreBytes;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = 64 * m + 16 * warp + lane / 4 + 8 * half;
#pragma unroll
            for (int j = 0; j < kStemTileD / 8; ++j) {
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  relu_bias(acc[m][4 * j + 2 * half], b[j].x),
                  relu_bias(acc[m][4 * j + 2 * half + 1], b[j].y));
              *reinterpret_cast<__nv_bfloat162*>(
                  out + p * 128 + ((j ^ (p & 7)) << 4) + 4 * q) = v;
            }
          }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (tid == 0) {
          tma_store(&ymap, out, d0, w0, static_cast<int>(r));
          bulk_commit();
        }
        sb = (sb + 1) % kStoreBufs;
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

template <int C>
int launch(const void* x, const float* w, const float* bias, void* y,
           const StemShape& s, int D, int blocks, cudaStream_t stream) {
  const int Dp = (D + kStemTileD - 1) / kStemTileD * kStemTileD;
  const int smem = smem_bytes(s, Dp);
  CUtensorMap ymap;
  const int err = encode_rows_map(&ymap, y, s.rows, s.W, s.W, D, kStemSeg);
  if (err != 0) return err;
  // the attribute allows the most a block may take; a launch asks for its own
  static SmemOnce smem_once;
  const int attr = smem_once.set(stem_fwd_kernel<C>, kSmemLimit);
  if (attr != 0) return attr;
  stem_fwd_kernel<C><<<blocks, kThreads, smem, stream>>>(
      ymap, static_cast<const uint8_t*>(x), w, bias, s, D, Dp);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Bound with ctypes. x (N, H, W, C) bf16 with 1 <= C <= 3, w the float32
// OIHW (D, C, 3, 3) weight, bias (D,) float32, y (N, H, W, D) bf16 with D a
// multiple of 8 and at most 256, all contiguous and 16-byte aligned;
// `blocks` at most 132 and at most N * H, each taking a run of image rows
// (ops/kernels/flatconv.py `plan`, mode "stem"). The shared memory
// (`stem_smem` there) must fit in 227 KB. Returns cudaGetLastError() after
// the launch on `stream`, an error code of the tensor-map encoder, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int osvos_stem_fwd(const void* x, const void* w, const void* bias,
                              void* y, int N, int H, int W, int C, int D,
                              int blocks, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kStemMaxC || D < 8 ||
      D % 8 != 0 || D > kMaxD || x == nullptr || w == nullptr ||
      bias == nullptr || y == nullptr || !aligned16(x) || !aligned16(w) ||
      !aligned16(bias) || !aligned16(y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StemShape s = stem_shape(N, H, W, C);
  const int Dp = (D + kStemTileD - 1) / kStemTileD * kStemTileD;
  if (blocks < 1 || blocks > kNumSMs || blocks > s.rows ||
      s.rows > 0x7fffffffLL || smem_bytes(s, Dp) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(x, wf, bf, y, s, D, blocks, st);
    case 2: return launch<2>(x, wf, bf, y, s, D, blocks, st);
    default: return launch<3>(x, wf, bf, y, s, D, blocks, st);
  }
}
