// Class-balanced binary cross-entropy: per-sample statistics and gradient,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of osvos_tpu/ops/pallas/cbbce.py: `_stats_kernel`
// and `_grad_kernel` (whole batch, launched by `_cbbce_stats` /
// `_cbbce_grad`) and the per-sample `kernel`s of `_cbbce_stats_per_sample` /
// `_cbbce_grad_per_sample`. The whole-batch form is the per-sample form with
// the batch viewed as one sample, so one pair of kernels serves all four.
//
// With z = 1{label >= 0.5} and softplus(v) = max(v, 0) + log1p(exp(-|v|)):
//
//   stats[b] = (n_pos, n_neg, sum z * softplus(-x), sum (1 - z) * softplus(x))
//   dx[b, i] = s_b * (w+_b * z * (sigmoid(x) - 1) + w-_b * (1 - z) * sigmoid(x))
//
// over the n elements of each sample b; (w+, w-, s) come from a (B, 4)
// device tensor, so the host never waits for the statistics.
//
// Design. Both kernels move each input byte once and do a few
// transcendentals per element, so they are bound by memory: stats reads 8 B
// per element, grad reads 8 B and writes 4 B. Loads are float4 where the
// addresses allow it. The TPU kernel pads to (rows, 128) tiles with a
// -1e30 logit and corrects the census afterwards; here each block masks its
// own ragged edge, so nothing is padded or corrected.
//
// Determinism. The statistics are reduced in a fixed order: each thread
// sums its elements in index order, each block folds its threads through
// a fixed shuffle tree into one partial per (sample, chunk), and a second
// pass folds the partials of each sample in chunk order. No float atomics,
// so two launches return the same bits. Counts are integers: per thread
// and per block as int, per sample as long long, then stored as float
// (exact below 2^24 elements, which the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ void add_one(float x, float label, int& cnt,
                                        float& sp, float& sn) {
  if (label >= 0.5f) {
    cnt += 1;
    sp += softplus(-x);
  } else {
    sn += softplus(x);
  }
}

// Fixed-order block reduction of (cnt, sp, sn); the result is valid in
// thread 0.
__device__ __forceinline__ void block_reduce(int& cnt, float& sp, float& sn) {
  __shared__ int s_cnt[kWarps];
  __shared__ float s_sp[kWarps], s_sn[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sp += __shfl_down_sync(0xffffffffu, sp, off);
    sn += __shfl_down_sync(0xffffffffu, sn, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_sp[warp] = sp;
    s_sn[warp] = sn;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? s_cnt[lane] : 0;
    sp = lane < kWarps ? s_sp[lane] : 0.f;
    sn = lane < kWarps ? s_sn[lane] : 0.f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      sp += __shfl_down_sync(0xffffffffu, sp, off);
      sn += __shfl_down_sync(0xffffffffu, sn, off);
    }
  }
}

// Pass 1: block (j, b) reduces elements [j * chunk, (j + 1) * chunk) of
// sample b into partial[b, j] = (count, -, sum_pos, sum_neg).
__global__ void __launch_bounds__(kThreads) stats_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    float4* __restrict__ partial, long long n, long long chunk) {
  const int b = blockIdx.y;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  const float* xr = x + b * n;
  const float* zr = z + b * n;
  int cnt = 0;
  float sp = 0.f, sn = 0.f;
  // scalar head up to a 16-byte boundary (rows start unaligned when n % 4)
  const long long mis = (reinterpret_cast<uintptr_t>(xr + lo) / 4) % 4;
  long long head = mis ? 4 - mis : 0;
  if (head > hi - lo) head = hi - lo;
  if (threadIdx.x < head) {
    add_one(__ldg(xr + lo + threadIdx.x), __ldg(zr + lo + threadIdx.x), cnt,
            sp, sn);
  }
  const long long body = lo + head;
  const long long n4 = (hi - body) / 4;
  const float4* x4 = reinterpret_cast<const float4*>(xr + body);
  const float4* z4 = reinterpret_cast<const float4*>(zr + body);
  for (long long i = threadIdx.x; i < n4; i += kThreads) {
    const float4 xv = __ldg(x4 + i);
    const float4 zv = __ldg(z4 + i);
    add_one(xv.x, zv.x, cnt, sp, sn);
    add_one(xv.y, zv.y, cnt, sp, sn);
    add_one(xv.z, zv.z, cnt, sp, sn);
    add_one(xv.w, zv.w, cnt, sp, sn);
  }
  const long long tail = body + 4 * n4 + threadIdx.x;
  if (tail < hi) add_one(__ldg(xr + tail), __ldg(zr + tail), cnt, sp, sn);
  block_reduce(cnt, sp, sn);
  if (threadIdx.x == 0) {
    partial[static_cast<long long>(b) * gridDim.x + blockIdx.x] =
        make_float4(static_cast<float>(cnt), 0.f, sp, sn);
  }
}

// Pass 2: block b folds the `chunks` partials of sample b in chunk order.
__global__ void __launch_bounds__(kThreads) stats_final_kernel(
    const float4* __restrict__ partial, float4* __restrict__ out, long long n,
    int chunks) {
  const int b = blockIdx.x;
  const float4* row = partial + static_cast<long long>(b) * chunks;
  long long cnt = 0;
  float sp = 0.f, sn = 0.f;
  for (int j = threadIdx.x; j < chunks; j += kThreads) {
    const float4 v = row[j];
    cnt += static_cast<long long>(v.x);
    sp += v.z;
    sn += v.w;
  }
  // per-thread counts are at most n < 2^24, so int holds them
  int c32 = static_cast<int>(cnt);
  block_reduce(c32, sp, sn);
  if (threadIdx.x == 0) {
    out[b] = make_float4(static_cast<float>(c32),
                         static_cast<float>(n - c32), sp, sn);
  }
}

__device__ __forceinline__ float grad_one(float x, float label, float wp,
                                          float wn, float s) {
  const float sig = 1.f / (1.f + expf(-x));
  const float zv = label >= 0.5f ? 1.f : 0.f;
  return s * (wp * zv * (sig - 1.f) + wn * (1.f - zv) * sig);
}

// One thread per element (kVec = false) or per float4 (kVec = true, which
// needs n % 4 == 0 so that a float4 never straddles two samples).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) grad_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    const float4* __restrict__ w, float* __restrict__ dx, long long n,
    long long total) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      (kVec ? 4 : 1);
  if (i >= total) return;
  const float4 wb = __ldg(w + i / n);  // (w_pos, w_neg, scale, -)
  if (kVec) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 zv = __ldg(reinterpret_cast<const float4*>(z + i));
    float4 o;
    o.x = grad_one(xv.x, zv.x, wb.x, wb.y, wb.z);
    o.y = grad_one(xv.y, zv.y, wb.x, wb.y, wb.z);
    o.z = grad_one(xv.z, zv.z, wb.x, wb.y, wb.z);
    o.w = grad_one(xv.w, zv.w, wb.x, wb.y, wb.z);
    *reinterpret_cast<float4*>(dx + i) = o;
  } else {
    dx[i] = grad_one(__ldg(x + i), __ldg(z + i), wb.x, wb.y, wb.z);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry points, bound with ctypes. All tensors are contiguous
// float32 on the device with 16-byte aligned bases: x and z (B, n), partial
// (B, chunks, 4) scratch with chunks = ceil(n / chunk), out (B, 4). Launches
// go on `stream`; each returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int osvos_cbbce_stats(const void* x, const void* z, void* partial,
                                 void* out, long long n, int B,
                                 long long chunk, void* stream) {
  if (n < 1 || n >= (1LL << 24) || B < 1 || B > 65535 || chunk < 4 ||
      chunk % 4 != 0 || !aligned16(x) || !aligned16(z) ||
      !aligned16(partial) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (n + chunk - 1) / chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_partial_kernel<<<dim3(static_cast<unsigned>(chunks), B), kThreads, 0,
                         s>>>(static_cast<const float*>(x),
                              static_cast<const float*>(z),
                              static_cast<float4*>(partial), n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_final_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(out), n,
      static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

// w: (B, 4) rows of (w_pos, w_neg, scale, unused); dx: (B, n).
extern "C" int osvos_cbbce_grad(const void* x, const void* z, const void* w,
                                void* dx, long long n, int B, void* stream) {
  if (n < 1 || B < 1 || !aligned16(x) || !aligned16(z) || !aligned16(w) ||
      !aligned16(dx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = n * B;
  const bool vec = n % 4 == 0;
  const long long items = vec ? total / 4 : total;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* zf = static_cast<const float*>(z);
  const float4* wf = static_cast<const float4*>(w);
  float* out = static_cast<float*>(dx);
  if (vec) {
    grad_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xf, zf, wf, out, n, total);
  } else {
    grad_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xf, zf, wf, out, n, total);
  }
  return static_cast<int>(cudaGetLastError());
}
