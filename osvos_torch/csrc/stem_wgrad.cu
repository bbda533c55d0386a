// Weight and bias gradient of the 3x3 SAME stem conv (at most 3 input
// channels), NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel osvos_tpu/ops/pallas/flatconv.py
// `_stem_wgrad_kernel` (B16, launched by `_stem_wgrad_stacked_impl`). For
// the image x (N, H, W, C <= 3) and the cotangent g (N, H, W, D), both bf16,
// it computes
//
//   dK[kh, kw, c, d] = sum_{n, h, w} x[n, h + kh - 1, w + kw - 1, c] * g[n, h, w, d]
//   db[d]            = sum_{n, h, w} g[n, h, w, d]
//
// with x outside the image taken as zero, in float32: every product of two
// bf16 values is exact in float32 and the sums are taken in float32.
//
// Design. The pixels are the reduction dimension. Each pixel's nine taps x
// C channels are stacked into one row of K = 32 values, row index
// t * C + c (t = 3 * kh + kw), followed by a column of ones (index 9 * C)
// and zeros; the whole function is then ONE product Out = A^T . G over the
// pixels, (32 x P) . (P x D), and db is row 9 * C of it, so g is read once
// for both. This is the TPU kernel's tap stacking; its packed pixel pairs,
// u32 shifts and lane rolls do not carry over. A block walks over row
// segments of 64 pixels (one image row, 64 columns): it stages the haloed
// strip of three image rows (the segment's row and its neighbours, 66
// columns, zero off the image) and the segment's g rows (16-byte loads) in
// shared memory, builds the stacked operand from the strip, and four warps,
// each owning 16 output channels, run mma.sync m16n8k16 bf16 products into
// float32 accumulators. Blocks take contiguous runs of segments (split-K);
// a second pass adds their partial outputs in a fixed order, so repeat
// launches give the same bits.
//
// Bound. At batch 5 on 480x854 with D = 64 it must read g (262 MB) and the
// image (12 MB) once: 0.082 ms at 3.35 TB/s, against 7.1 GFLOP (2 x 27 x
// 64 per pixel), 0.007 ms at the bf16 tensor-core rate. It is bound by
// bytes. The K = 32 operand keeps the tensor cores' share small: float32
// FMAs on the CUDA cores alone would take about 0.11 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTW = 64;       // pixels of a row segment, one staged step
constexpr int kRows = 32;     // rows of the stacked operand
constexpr int kTD = 64;       // output channels of a block
constexpr int kWarps = kTD / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 3;
constexpr int kStrip = kTW + 2;  // staged columns of a strip row
constexpr int kLDA = kTW + 8;    // bf16 row strides: 16-byte multiples,
constexpr int kLDG = kTD + 8;    // padded against bank conflicts

struct Shape {
  int N, H, W, C, D;
  int segs_w;           // segments per image row
  long long segs;       // N * H * segs_w
  long long per_block;  // segments of one split
  int rows;             // 9 * C + 1 rows of the output
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p,
                                            bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 1. Block (split, d-tile) writes the (rows, D) float32 output of its
// run of segments, channels [d0, d0 + kTD), to partial[split].
template <bool kVecG>
__global__ void __launch_bounds__(kThreads) stem_wgrad_partial_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g,
    float* __restrict__ partial, const Shape s) {
  __shared__ __align__(16) bf16 xs[3 * kStrip * kMaxC];
  __shared__ __align__(16) bf16 As[kRows * kLDA];
  __shared__ __align__(16) bf16 Gs[kTW * kLDG];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.y * kTD;
  const long long split = blockIdx.x;
  const long long seg_lo = split * s.per_block;
  const long long seg_hi =
      seg_lo + s.per_block < s.segs ? seg_lo + s.per_block : s.segs;
  const bf16 zero = __float2bfloat16(0.f), one = __float2bfloat16(1.f);
  const int taps = 9 * s.C;

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (long long seg = seg_lo; seg < seg_hi; ++seg) {
    const long long row = seg / s.segs_w;  // n * H + h
    const int w0 = static_cast<int>(seg % s.segs_w) * kTW;
    const int h = static_cast<int>(row % s.H);
    const long long n = row / s.H;
    const int tw = s.W - w0 < kTW ? s.W - w0 : kTW;  // valid pixels

    // the haloed strip, xs[r][col][c]: image row h + r - 1, column
    // w0 + col - 1
    for (int i = threadIdx.x; i < 3 * kStrip * s.C; i += kThreads) {
      const int c = i % s.C;
      const int col = (i / s.C) % kStrip;
      const int r = i / (s.C * kStrip);
      const int hh = h + r - 1, ww = w0 + col - 1;
      bf16 v = zero;
      if (hh >= 0 && hh < s.H && ww >= 0 && ww < s.W) {
        v = x[((n * s.H + hh) * s.W + ww) * s.C + c];
      }
      xs[(r * kStrip + col) * kMaxC + c] = v;
    }
    // the segment's g rows, Gs[j][d - d0], zero past the row and past D
    const long long p0 = row * s.W + w0;
    if (kVecG) {
      for (int i = threadIdx.x; i < kTW * (kTD / 8); i += kThreads) {
        const int j = i / (kTD / 8), dv = (i % (kTD / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (j < tw && d0 + dv < s.D) {
          v = __ldg(reinterpret_cast<const uint4*>(g + (p0 + j) * s.D + d0 + dv));
        }
        *reinterpret_cast<uint4*>(Gs + j * kLDG + dv) = v;
      }
    } else {
      for (int i = threadIdx.x; i < kTW * kTD; i += kThreads) {
        const int j = i / kTD, dd = i % kTD;
        Gs[j * kLDG + dd] =
            j < tw && d0 + dd < s.D ? g[(p0 + j) * s.D + d0 + dd] : zero;
      }
    }
    __syncthreads();
    // the stacked operand, As[k][j]: tap t = k / C, channel c = k % C of
    // pixel j for k < 9 C; ones at k = 9 C; zero elsewhere and past the row
    for (int i = threadIdx.x; i < kRows * kTW; i += kThreads) {
      const int k = i / kTW, j = i % kTW;
      bf16 v = zero;
      if (j < tw) {
        if (k < taps) {
          const int t = k / s.C, c = k % s.C;
          v = xs[((t / 3) * kStrip + j + t % 3) * kMaxC + c];
        } else if (k == taps) {
          v = one;
        }
      }
      As[k * kLDA + j] = v;
    }
    __syncthreads();
    // Out[k, d] += sum over the segment's pixels; warp owns 16 channels
#pragma unroll
    for (int kk = 0; kk < kTW; kk += 16) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(a[i], As + (i * 16 + (lane & 15)) * kLDA + kk + (lane >> 4) * 8,
                    false);
      }
      ldmatrix_x4(b, Gs + (kk + (lane & 15)) * kLDG + warp * 16 + (lane >> 4) * 8,
                  true);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][0], a[i], b[0], b[1]);
        mma_bf16(acc[i][1], a[i], b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // accumulator element e of tile (i, j): row i * 16 + lane / 4 (+ 8 for
  // e >= 2), column 16 * warp + 8 * j + 2 * (lane % 4) + e % 2
  float* out = partial + split * s.rows * s.D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i * 16 + lane / 4 + (e >= 2 ? 8 : 0);
        const int d = d0 + warp * 16 + j * 8 + 2 * (lane % 4) + e % 2;
        if (r < s.rows && d < s.D) out[r * s.D + d] = acc[i][j][e];
      }
}

// Pass 2: out[i] = sum over splits of partial[split, i]. A block owns 32
// consecutive outputs; warp w adds splits w, w + 8, ... in order, then one
// warp adds the eight warps' sums in order.
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(32 * kReduceWarps) stem_wgrad_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n,
    long long splits) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < n) {
    for (long long k = warp; k < splits; k += kReduceWarps) {
      acc += partial[k * n + i];
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) total += sums[w][lane];
    out[i] = total;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. x (N, H, W, C) and g (N, H, W, D)
// contiguous bf16, 1 <= C <= 3; partial (splits, 9 * C + 1, D) float32
// scratch; out (9 * C + 1, D) float32: rows t * C + c (t = 3 * kh + kw) are
// dK, row 9 * C is db. `per_block` segments of 64 pixels of one image row
// per split, with splits = ceil(N * H * ceil(W / 64) / per_block). Every
// base 16-byte aligned. Returns cudaGetLastError() after the two launches
// on `stream`, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int osvos_stem_wgrad(const void* x, const void* g, void* partial,
                                void* out, int N, int H, int W, int C, int D,
                                long long per_block, long long splits,
                                void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxC || D < 1 ||
      per_block < 1 || !aligned(x) || !aligned(g) || !aligned(partial) ||
      !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int segs_w = (W + kTW - 1) / kTW;
  const long long segs = static_cast<long long>(N) * H * segs_w;
  if (splits != (segs + per_block - 1) / per_block || splits > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{N, H, W, C, D, segs_w, segs, per_block, 9 * C + 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(g);
  float* part = static_cast<float*>(partial);
  const dim3 grid(static_cast<unsigned>(splits), (D + kTD - 1) / kTD);
  if (D % 8 == 0) {
    stem_wgrad_partial_kernel<true><<<grid, kThreads, 0, st>>>(xb, gb, part, s);
  } else {
    stem_wgrad_partial_kernel<false><<<grid, kThreads, 0, st>>>(xb, gb, part, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = s.rows * D;
  stem_wgrad_reduce_kernel<<<(n + 31) / 32, 32 * kReduceWarps, 0, st>>>(
      part, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
