// Ceil-mode 2x2 stride-2 max pool and its backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of osvos_tpu/ops/pallas/flatpool.py: the flat
// pool `_fwd_kernel` / `_bwd_kernel` (launched by `pool_flat_fwd_pallas` /
// `pool_flat_bwd_pallas`) and the pixel-pair-packed pool `_pp_fwd_kernel` /
// `_pp_bwd_kernel` (`pool_packed_fwd_pallas` / `pool_packed_bwd_pallas`).
// All four compute one function; the flat buffers and the pair packing are
// TPU layouts, so here both directions work on contiguous NHWC tensors.
//
// For x (N, H, W, C) the output y is (N, ceil(H/2), ceil(W/2), C):
//
//   y[n, i, j, c] = max over the in-image taps of the window
//                   (2i, 2j), (2i, 2j+1), (2i+1, 2j), (2i+1, 2j+1)
//
// in that order, a later tap replacing the running max if it is greater or
// NaN (PyTorch's rule, so a window with a NaN gives NaN). The value is one
// of the inputs, so the result is exact in the input's dtype. A ragged
// window at an odd H or W takes only its in-image taps.
//
// Backward, for the cotangent g of y: each window's g goes to the first of
// its taps, in the order above, that equals y; the other taps get 0. This
// is the reference chain's routing (osvos_tpu/ops/pool.py:_mp_bwd), which
// PyTorch's own max-pool backward does not follow on ties.
//
// Design. Both directions are bound by memory: the forward reads x once and
// writes y; the backward reads x, y and g once and writes dx. One thread
// takes one output pixel and one 16-byte vector of channels (8 bf16 or 4
// float32) when C and the addresses allow it, else one channel. At
// k = s = 2 the windows tile the input without overlap, so the backward
// writes every element of dx exactly once: no atomics, no memset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float f32(uint16_t v) {  // bf16 bits -> float
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float f32(float v) { return v; }

template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Vec {
  S v[VEC];
};

template <typename S, int VEC>
__device__ __forceinline__ Vec<S, VEC> load(const S* p) {
  return *reinterpret_cast<const Vec<S, VEC>*>(p);
}

template <typename S, int VEC>
__device__ __forceinline__ void store(S* p, const Vec<S, VEC>& v) {
  *reinterpret_cast<Vec<S, VEC>*>(p) = v;
}

// The window of output element `i` (pixel and channel vector): the offset
// of its top-left tap and whether the right column and the bottom row lie
// in the image.
struct Window {
  long long tap0;   // element offset of tap (2i, 2j), channel vector start
  long long out;    // element offset in y / g
  long long row;    // elements from one input row to the next (W * C)
  int c;            // elements from one input column to the next
  bool right, down;
};

__device__ __forceinline__ Window window(long long i, int h, int w, int c,
                                         int ho, int wo, int vec) {
  const int cv = c / vec;
  const int ch = static_cast<int>(i % cv) * vec;
  long long p = i / cv;
  const int oj = static_cast<int>(p % wo);
  p /= wo;
  const int oi = static_cast<int>(p % ho);
  const long long n = p / ho;
  Window win;
  win.row = static_cast<long long>(w) * c;
  win.c = c;
  win.tap0 = ((n * h + 2 * oi) * w + 2 * oj) * c + ch;
  win.out = ((n * ho + oi) * wo + oj) * c + ch;
  win.right = 2 * oj + 1 < w;
  win.down = 2 * oi + 1 < h;
  return win;
}

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
    pool_fwd_kernel(const S* __restrict__ x, S* __restrict__ y, int h, int w,
                    int c, int ho, int wo, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const Window win = window(i, h, w, c, ho, wo, VEC);
  Vec<S, VEC> m = load<S, VEC>(x + win.tap0);
  const long long taps[3] = {win.c, win.row, win.row + win.c};
  const bool in[3] = {win.right, win.down, win.right && win.down};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (!in[t]) continue;
    const Vec<S, VEC> v = load<S, VEC>(x + win.tap0 + taps[t]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float fv = f32(v.v[e]);
      if (fv > f32(m.v[e]) || isnan(fv)) m.v[e] = v.v[e];
    }
  }
  store<S, VEC>(y + win.out, m);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_kernel(const S* __restrict__ x, const S* __restrict__ y,
                    const S* __restrict__ g, S* __restrict__ dx, int h, int w,
                    int c, int ho, int wo, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const Window win = window(i, h, w, c, ho, wo, VEC);
  const Vec<S, VEC> m = load<S, VEC>(y + win.out);
  const Vec<S, VEC> gv = load<S, VEC>(g + win.out);
  bool taken[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) taken[e] = false;
  const long long taps[4] = {0, win.c, win.row, win.row + win.c};
  const bool in[4] = {true, win.right, win.down, win.right && win.down};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!in[t]) continue;
    const Vec<S, VEC> v = load<S, VEC>(x + win.tap0 + taps[t]);
    Vec<S, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const bool wins = !taken[e] && f32(v.v[e]) == f32(m.v[e]);
      o.v[e] = wins ? gv.v[e] : S(0);
      taken[e] = taken[e] || wins;
    }
    store<S, VEC>(dx + win.tap0 + taps[t], o);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch the forward (g == dx == nullptr) or the backward over one dtype.
template <typename S>
int launch(const void* x, const void* y, const void* g, void* out, int n,
           int h, int w, int c, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(S);
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const bool vec = c % kVec == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(out) && (g == nullptr || aligned16(g));
  const long long total =
      static_cast<long long>(n) * ho * wo * (vec ? c / kVec : c);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const S* xs = static_cast<const S*>(x);
  if (g == nullptr) {
    S* ys = static_cast<S*>(out);
    if (vec) {
      pool_fwd_kernel<S, kVec><<<grid, kThreads, 0, s>>>(xs, ys, h, w, c, ho,
                                                          wo, total);
    } else {
      pool_fwd_kernel<S, 1><<<grid, kThreads, 0, s>>>(xs, ys, h, w, c, ho, wo,
                                                       total);
    }
  } else {
    const S* ys = static_cast<const S*>(y);
    const S* gs = static_cast<const S*>(g);
    S* dxs = static_cast<S*>(out);
    if (vec) {
      pool_bwd_kernel<S, kVec><<<grid, kThreads, 0, s>>>(xs, ys, gs, dxs, h, w,
                                                          c, ho, wo, total);
    } else {
      pool_bwd_kernel<S, 1><<<grid, kThreads, 0, s>>>(xs, ys, gs, dxs, h, w, c,
                                                       ho, wo, total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* y, const void* g, void* out, int n,
             int h, int w, int c, int dtype, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<uint16_t>(x, y, g, out, n, h, w, c, s);
  if (dtype == 1) return launch<float>(x, y, g, out, n, h, w, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, bound with ctypes. Tensors are contiguous NHWC on
// the device, all of one dtype: 0 = bfloat16, 1 = float32. x (N, H, W, C);
// y, g (N, ceil(H/2), ceil(W/2), C); dx like x. Launches go on `stream`;
// each returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int osvos_max_pool_fwd(const void* x, void* y, int n, int h, int w,
                                  int c, int dtype, void* stream) {
  return dispatch(x, y, nullptr, y, n, h, w, c, dtype, stream);
}

extern "C" int osvos_max_pool_bwd(const void* x, const void* y, const void* g,
                                  void* dx, int n, int h, int w, int c,
                                  int dtype, void* stream) {
  if (g == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, y, g, dx, n, h, w, c, dtype, stream);
}
