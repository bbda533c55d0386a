// Weight gradient of a 3x3 SAME convolution, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel osvos_tpu/ops/pallas/wgrad.py `_kernel` (launched
// by `wgrad3x3`). It computes
//
//   dK[kh, kw, c, d] = sum_{n, h, w} x[n, h + kh - 1, w + kw - 1, c] * g[n, h, w, d]
//
// with x outside the image taken as zero; x (N, H, W, C) and g (N, H, W, D)
// are bf16, dK (3, 3, C, D) is float32. Every product of two bf16 values is
// exact in float32, and the sums are taken in float32, as the JAX package's
// `_wgrad_einsum` (preferred_element_type=float32) takes them.
//
// Design. For one tap the function is a matrix product
// dK[kh, kw] = X_tap^T . G over K = N*H*W pixels, with X_tap the (K, C)
// matrix of shifted input rows and G the (K, D) cotangent. NHWC keeps each
// pixel's C and D values contiguous, so a pixel is one row of each operand.
// A block owns one tap, one TC x TD tile of (C, D) and one chunk of pixels
// (split-K): it stages 32 pixel rows of x (shifted by the tap, zero outside
// the image) and of g in shared memory, then four warps run
// nvcuda::wmma bf16 16x16x16 products into float32 accumulators. The
// pixel chunks exist because the shapes swing from 64x64 outputs per tap
// over 2 M pixels (stage 1 at 480x854, batch 5) to 512x512 outputs over
// 8 100 pixels (stage 5); the wrapper picks the number of chunks so that
// the grid fills the card. A second pass adds the chunks' partial tiles in
// chunk order, so the result does not depend on block scheduling.
//
// The TPU kernel's flat padded layout, 16-aligned tap offsets and u32
// pair-shifts exist for the TPU's tiling; here the shift is an index
// computation per staged row.
//
// With `with_db` the same launch also gives the bias gradient
// db[d] = sum_{n, h, w} g[n, h, w, d] (float32 sums of the bf16 values): the
// centre-tap blocks of the first C tile add up the g rows they stage, and
// the second pass folds their partial sums with the dK partials. This is
// the dK + db half of the flat trunk's backward kernels (B3's second
// launch, which is also B4's function; osvos_tpu/ops/pallas/flatconv.py
// `_bwd_fused_kernel`, `_wgrad_kernel`). The stem takes the tap-stacked
// csrc/stem_wgrad.cu (B16) instead.
//
// Bound. Per conv it does 2 * 9 * C * D * N * H * W operations on the
// tensor cores and must read x and g once: at stage 1 (C = D = 64) 151
// GFLOP against 0.5 GB, at stage 5 (512 x 512) 38 GFLOP against 17 MB, so
// at the card's bf16 rate against its 3.35 TB/s it is bound by operations
// everywhere but the 3-channel stem (B16's). This first version reads each operand
// once per tap from L2 (the nine taps of a chunk are neighbours in the
// grid) and has no copy pipeline (TMA, cp.async) and no wgmma; those come
// with the speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTK = 32;  // pixel rows staged per step
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Shape {
  int N, H, W, C, D;
  long long P;      // N * H * W
  long long chunk;  // pixels per split
};

// Stage the rows [p0, p0 + kTK) of one operand, channels [c0, c0 + T), into
// shared memory with row stride LD. For x (kShift), row p reads the input
// pixel shifted by the tap and is zero outside the image; rows past p_hi
// and channels past the extent are zero.
template <int T, int LD, bool kVec, bool kShift>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* __restrict__ dst, const __nv_bfloat16* __restrict__ src,
    const Shape& s, int extent, long long p0, long long p_hi, int c0, int kh,
    int kw) {
  const long long hw = static_cast<long long>(s.H) * s.W;
  constexpr int kPer = kVec ? 8 : 1;  // values per load
  constexpr int kCols = T / kPer;
  for (int i = threadIdx.x; i < kTK * kCols; i += kThreads) {
    const int r = i / kCols;
    const int c = c0 + (i % kCols) * kPer;
    const long long p = p0 + r;
    long long off = -1;
    if (p < p_hi && c < extent) {
      if (kShift) {
        const long long n = p / hw;
        const long long rem = p - n * hw;
        const int h = static_cast<int>(rem / s.W) + kh - 1;
        const int w = static_cast<int>(rem % s.W) + kw - 1;
        if (h >= 0 && h < s.H && w >= 0 && w < s.W) {
          off = ((n * s.H + h) * s.W + w) * extent + c;
        }
      } else {
        off = p * extent + c;
      }
    }
    __nv_bfloat16* d = dst + r * LD + (i % kCols) * kPer;
    if (kVec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) v = __ldg(reinterpret_cast<const uint4*>(src + off));
      *reinterpret_cast<uint4*>(d) = v;
    } else {
      *d = off >= 0 ? src[off] : __float2bfloat16(0.f);
    }
  }
}

// Pass 1. Block (tap + 9 * split, c-tile, d-tile) writes its float32 tile
// of pixel chunk `split` to partial[split, tap, c, d].
template <int WM, int WN, int FM, int FN, bool kVecX, bool kVecG>
__global__ void __launch_bounds__(kThreads) wgrad_partial_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    float* __restrict__ partial, const Shape s, long long stride,
    int with_db) {
  static_assert(WM * WN == kWarps, "one warp per warp tile");
  constexpr int TC = WM * FM * 16;
  constexpr int TD = WN * FN * 16;
  constexpr int LDA = TC + 8;  // bf16 row strides: multiples of 8, and
  constexpr int LDB = TD + 8;  // padded against bank conflicts
  constexpr int LDC = TD + 4;
  __shared__ __align__(128) __nv_bfloat16 As[kTK * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kTK * LDB];
  __shared__ __align__(128) float Cs[TC * LDC];

  const int tap = blockIdx.x % 9;
  const long long split = blockIdx.x / 9;
  const int kh = tap / 3, kw = tap % 3;
  const int c0 = blockIdx.y * TC;
  const int d0 = blockIdx.z * TD;
  const long long p_lo = split * s.chunk;
  const long long p_hi = p_lo + s.chunk < s.P ? p_lo + s.chunk : s.P;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WN, wn = warp % WN;
  const bool db_block = with_db && tap == 4 && blockIdx.y == 0;
  float colsum = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long p0 = p_lo; p0 < p_hi; p0 += kTK) {
    stage_rows<TC, LDA, kVecX, true>(As, x, s, s.C, p0, p_hi, c0, kh, kw);
    stage_rows<TD, LDB, kVecG, false>(Bs, g, s, s.D, p0, p_hi, d0, 0, 0);
    __syncthreads();
    if (db_block && threadIdx.x < TD) {
      for (int r = 0; r < kTK; ++r)
        colsum += __bfloat162float(Bs[r * LDB + threadIdx.x]);
    }
#pragma unroll
    for (int k = 0; k < kTK; k += 16) {
      // A = X_tap^T (TC x kTK): As holds it pixel-major, i.e. column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + k * LDA + (wm * FM + i) * 16, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + k * LDB + (wn * FN + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // through shared memory, so that ragged C and D edges are masked
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM + i) * 16 * LDC + (wn * FN + j) * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  const long long cd = static_cast<long long>(s.C) * s.D;
  float* out = partial + split * stride + tap * cd;
  for (int i = threadIdx.x; i < TC * TD; i += kThreads) {
    const int r = i / TD, col = i % TD;
    const int c = c0 + r, d = d0 + col;
    if (c < s.C && d < s.D) {
      out[static_cast<long long>(c) * s.D + d] = Cs[r * LDC + col];
    }
  }
  if (db_block && threadIdx.x < TD && d0 + threadIdx.x < s.D) {
    partial[split * stride + 9 * cd + d0 + threadIdx.x] = colsum;
  }
}

// Pass 2: out[i] = sum over splits of partial[split, i], in split order.
__global__ void __launch_bounds__(256) wgrad_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, long long n,
    long long splits) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (long long k = 0; k < splits; ++k) acc += partial[k * n + i];
  out[i] = acc;
}

template <int WM, int WN, int FM, int FN, bool kVecX, bool kVecG>
void launch_partial(const __nv_bfloat16* x, const __nv_bfloat16* g,
                    float* partial, const Shape& s, long long splits,
                    long long stride, int with_db, cudaStream_t stream) {
  constexpr int TC = WM * FM * 16;
  constexpr int TD = WN * FN * 16;
  const dim3 grid(static_cast<unsigned>(9 * splits), (s.C + TC - 1) / TC,
                  (s.D + TD - 1) / TD);
  wgrad_partial_kernel<WM, WN, FM, FN, kVecX, kVecG>
      <<<grid, kThreads, 0, stream>>>(x, g, partial, s, stride, with_db);
}

template <int WM, int WN, int FM, int FN>
void dispatch_vec(bool vx, bool vg, const __nv_bfloat16* x,
                  const __nv_bfloat16* g, float* partial, const Shape& s,
                  long long splits, long long stride, int with_db,
                  cudaStream_t stream) {
  if (vx && vg) {
    launch_partial<WM, WN, FM, FN, true, true>(x, g, partial, s, splits, stride, with_db, stream);
  } else if (vg) {
    launch_partial<WM, WN, FM, FN, false, true>(x, g, partial, s, splits, stride, with_db, stream);
  } else if (vx) {
    launch_partial<WM, WN, FM, FN, true, false>(x, g, partial, s, splits, stride, with_db, stream);
  } else {
    launch_partial<WM, WN, FM, FN, false, false>(x, g, partial, s, splits, stride, with_db, stream);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. x (N, H, W, C) and g (N, H, W, D)
// contiguous bf16; partial (splits, 9 * C * D + with_db * D) float32
// scratch; out (9 * C * D + with_db * D) float32, dK (3, 3, C, D) followed
// by db (D) when `with_db` is 1; every base 16-byte aligned. `tile_c` is 64 (a
// 64x64 block tile) or 16 (16x64, for narrow inputs such as the 3-channel
// stem). `chunk` pixels per split, a multiple of 32, with
// splits * chunk >= N * H * W. Returns cudaGetLastError() after the two
// launches on `stream`, or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int osvos_wgrad3x3(const void* x, const void* g, void* partial,
                              void* out, int N, int H, int W, int C, int D,
                              int tile_c, long long splits, long long chunk,
                              int with_db, void* stream) {
  const long long P = static_cast<long long>(N) * H * W;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (N < 1 || H < 1 || W < 1 || C < 1 || D < 1 || splits < 1 ||
      chunk < kTK || chunk % kTK != 0 || splits * chunk < P ||
      (splits - 1) * chunk >= P || 9 * splits > 0x7fffffffLL ||
      (tile_c != 64 && tile_c != 16) || (with_db != 0 && with_db != 1) ||
      !aligned(x) || !aligned(g) ||
      !aligned(partial) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{N, H, W, C, D, P, chunk};
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  float* part = static_cast<float*>(partial);
  const bool vx = C % 8 == 0, vg = D % 8 == 0;
  const long long n = 9LL * C * D + with_db * D;
  if (tile_c == 64) {
    dispatch_vec<2, 2, 2, 2>(vx, vg, xb, gb, part, s, splits, n, with_db,
                             stream_);
  } else {
    dispatch_vec<1, 4, 1, 1>(vx, vg, xb, gb, part, s, splits, n, with_db,
                             stream_);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        stream_>>>(part, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
