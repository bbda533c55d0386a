// Flat-trunk 3x3 convolutions of the online fine-tune, NHWC, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of osvos_tpu/ops/pallas/flatconv.py:
//   B2 `_fwd_kernel` (flat_conv3x3 forward: conv + f32 bias + ReLU, the
//      3-channel stem, and the stage-boundary pool in the epilogue, the
//      function of flatpool.packed_conv_pool);
//   B3 `_bwd_fused_kernel`, its input-gradient half: dz = conv_T(g, K) *
//      (z_in > 0), with the pool backward routing d_pooled into g in the
//      prologue;
//   B5 `_side_fwd_kernel` (side_prep 3x3 C -> 16, no bias or ReLU, and the
//      next stage's pool of the same input);
//   B6 `_side_bwd_kernel`, its input-gradient half: conv_T(g_side, K) *
//      (z > 0) plus the routed pool cotangent, summed in f32 before the one
//      bf16 rounding.
// The weight and bias gradients of B3, B4 (the stem) and B6 come from
// osvos_torch/csrc/wgrad.cu, so each backward is two launches.
//
// Function. Tensors are NHWC bf16, contiguous; the trunk's buffers hold
// post-ReLU activations. A forward computes
//   y[n, h, w, d] = epi( sum_{kh, kw, c} x[n, h + kh - 1, w + kw - 1, c] * K[kh, kw, c, d] )
// with x outside the image taken as zero, bf16 products summed in f32 and
// one bf16 rounding at the end. The input gradient is the same product of
// the cotangent with the flipped, transposed kernel, so one kernel template
// serves all four rows; they differ in the prologue (how the input tile is
// staged) and the epilogue.
//
// Design: an implicit GEMM. M = output pixels, N = output channels,
// K = 9 x input channels. A block owns a 4 x 32 pixel tile of one image
// (both even-aligned, so every 2x2 pool window lies inside one block) and
// TN output channels. For each chunk of TC input channels it stages the
// haloed input tile (rows h0-1 .. h0+4, columns w0-1 .. w0+32; zero off the
// image) and the nine taps' weights in shared memory once; the nine taps
// are then offsets into the staged tile (the TPU kernel's "tap = row
// offset"), read by ldmatrix with per-lane addresses, and multiplied with
// mma.sync m16n8k16 bf16 into f32 accumulators. The epilogue goes through
// shared memory, 2x2 window by window, so the pool (max of the rounded
// outputs, or the routing of a pooled cotangent) needs no other pass. The
// 3-channel stem stages an im2col tile instead (K = 27, padded to 32), so
// it does not pad each tap's 3 channels to a chunk.
//
// Bound. Per trunk conv 2 * 9 * C * D * N * H * W operations on the tensor
// cores against reading x and writing y once: at stage 1 (C = D = 64,
// batch 5, 480x854) 151 GFLOP against 0.5 GB, so operations bound it. This
// first version has no copy pipeline (cp.async, TMA) and no wgmma; the
// staging and the products alternate, separated by barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 4;                         // pixel rows per block tile
constexpr int kTW = 32;                        // pixel columns per block tile
constexpr int kTP = kTH * kTW;                 // 128 pixels
constexpr int kHW = kTW + 2;                   // haloed tile width
constexpr int kHP = (kTH + 2) * kHW;           // haloed tile pixels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStemK = 32;                     // im2col depth of the stem

enum Epi { kBiasRelu = 0, kPlain = 1, kMask = 2 };
enum Extra { kNone = 0, kPoolOut = 1, kPoolIn = 2, kRouteIn = 3, kPoolAdd = 4,
             kIm2col = 5 };

struct Args {
  const bf16* x;      // (N, H, W, Cin) the product's input; kRouteIn: the
                      // pooled conv output whose cotangent is routed
  const bf16* w;      // (9, Cout_p, Cin_p) bf16 [tap][out][in]; kIm2col:
                      // (Cout_p, 32) [out][tap * Cin + c]
  const float* bias;  // (Cout), kBiasRelu
  bf16* y;            // (N, H, W, Cout)
  bf16* pooled;       // kPoolOut: pool of y; kPoolIn: pool of x
  const bf16* z;      // kMask: (N, H, W, Cout), the mask (z > 0) and, with
                      // kPoolAdd, the pool's input
  const bf16* zp;     // kRouteIn / kPoolAdd: the pooled map (its max values)
  const bf16* dzp;    // and its cotangent
  bf16* g_out;        // kRouteIn: the routed cotangent (N, H, W, Cin)
  int N, H, W, Cin, Cout, Cin_p, Cout_p, tiles_h, tiles_w;
};

struct __align__(16) V8 {
  bf16 v[8];
};

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ V8 zero8() {
  V8 r;
  *reinterpret_cast<uint4*>(r.v) = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

// Values [0, count) of p, zero beyond; one 16-byte load where it can.
__device__ __forceinline__ V8 load8(const bf16* p, int count) {
  V8 r;
  if (count >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(r.v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r.v[e] = e < count ? p[e] : __float2bfloat16(0.f);
  }
  return r;
}

__device__ __forceinline__ void store8(bf16* p, const V8& v, int count) {
  if (count >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v.v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < count) p[e] = v.v[e];
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The cotangent that the pool backward routes to pixel (h, w), channels
// [c, c + count): the pooled cotangent of its 2x2 window if (h, w) is the
// first in-image pixel of the window, in row-major order, whose value
// equals the window's max; else zero. Only pixels up to (h, w) are read.
__device__ V8 routed8(const Args& a, long long n, int h, int w, int c,
                      int count) {
  const int C = a.Cin;
  const int H2 = (a.H + 1) >> 1, W2 = (a.W + 1) >> 1;
  const int ph = h >> 1, pw = w >> 1;
  const long long pp = ((n * H2 + ph) * W2 + pw) * C + c;
  const V8 m = load8(a.zp + pp, count);
  const V8 dp = load8(a.dzp + pp, count);
  const int me = ((h & 1) << 1) | (w & 1);
  bool taken[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) taken[e] = false;
  V8 r = zero8();
  for (int q = 0; q <= me; ++q) {
    const int hh = 2 * ph + (q >> 1), ww = 2 * pw + (q & 1);
    if (hh >= a.H || ww >= a.W) continue;
    const V8 s = load8(a.x + ((n * a.H + hh) * a.W + ww) * C + c, count);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (!taken[e] && f32(s.v[e]) == f32(m.v[e])) {
        taken[e] = true;
        if (q == me) r.v[e] = dp.v[e];
      }
    }
  }
  return r;
}

// kPoolIn: the ceil-mode 2x2/2 max pool of the staged input chunk's
// in-image pixels (never of the zero halo), written for channels
// [c0, c0 + TC).
template <int TC, int LDA>
__device__ void pool_staged_input(const Args& a, const bf16* Xs, long long n,
                                  int h0, int w0, int c0) {
  const int H2 = (a.H + 1) >> 1, W2 = (a.W + 1) >> 1;
  for (int u = threadIdx.x; u < (kTP / 4) * (TC / 8); u += kThreads) {
    const int win = u / (TC / 8), g = u % (TC / 8);
    const int wr = win / (kTW / 2), wc = win % (kTW / 2);
    const int hb = h0 + 2 * wr, wb = w0 + 2 * wc, c = c0 + g * 8;
    if (hb >= a.H || wb >= a.W || c >= a.Cin) continue;
    float m[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (hb + (q >> 1) >= a.H || wb + (q & 1) >= a.W) continue;
      const bf16* s =
          Xs + ((2 * wr + (q >> 1) + 1) * kHW + 2 * wc + (q & 1) + 1) * LDA + g * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = q == 0 ? f32(s[e]) : fmaxf(m[e], f32(s[e]));
    }
    V8 out;
#pragma unroll
    for (int e = 0; e < 8; ++e) out.v[e] = __float2bfloat16(m[e]);
    store8(a.pooled + ((n * H2 + (hb >> 1)) * W2 + (wb >> 1)) * a.Cin + c, out,
           min(8, a.Cin - c));
  }
}

template <int TN, int TC, int kExtra>
struct Tile {
  static constexpr bool kStem = kExtra == kIm2col;
  static constexpr int LDA = TC + 8;  // 16-byte rows at an odd multiple of
                                      // 16 bytes: ldmatrix without conflicts
  static constexpr int kARows = kStem ? kTP : kHP;
  static constexpr int kTaps = kStem ? 1 : 9;
  static constexpr int LDC = TN + 4;
  static constexpr int kStageBytes = (kARows + kTaps * TN) * LDA * 2;
  static constexpr int kEpiBytes = kTP * LDC * 4;
  static constexpr int kSmem = kStageBytes > kEpiBytes ? kStageBytes : kEpiBytes;
};

template <int TN, int TC, int kEpi, int kExtra>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(const Args a) {
  using T = Tile<TN, TC, kExtra>;
  constexpr bool kStem = T::kStem;
  constexpr int LDA = T::LDA, LDC = T::LDC;
  constexpr int WN = TN >= 32 ? 2 : 1;      // warps across channels
  constexpr int WM = kWarps / WN;           // warps across pixels
  constexpr int MT = (kTP / 16) / WM;       // 16-pixel tiles per warp
  constexpr int NT8 = TN / WN / 8;          // 8-channel tiles per warp
  static_assert(NT8 % 2 == 0 && MT >= 1, "warp tiling");
  static_assert(!kStem || TC == kStemK, "the stem stages 32 columns");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + T::kARows * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x;
  const long long n = tile / (a.tiles_h * a.tiles_w);
  const int h0 = ((tile / a.tiles_w) % a.tiles_h) * kTH;
  const int w0 = (tile % a.tiles_w) * kTW;
  const int n0 = blockIdx.y * TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_ext = kStem ? kStemK : a.Cin_p;
  for (int c0 = 0; c0 < k_ext; c0 += TC) {
    // A: the input tile of this channel chunk
    if constexpr (kStem) {
      for (int i = threadIdx.x; i < kTP * kStemK; i += kThreads) {
        const int p = i / kStemK, k = i % kStemK;
        bf16 v = __float2bfloat16(0.f);
        if (k < 9 * a.Cin) {
          const int tap = k / a.Cin, c = k - tap * a.Cin;
          const int h = h0 + p / kTW + tap / 3 - 1;
          const int w = w0 + p % kTW + tap % 3 - 1;
          if (h >= 0 && h < a.H && w >= 0 && w < a.W)
            v = a.x[((n * a.H + h) * a.W + w) * a.Cin + c];
        }
        Xs[p * LDA + k] = v;
      }
    } else {
      for (int i = threadIdx.x; i < kHP * (TC / 8); i += kThreads) {
        const int hp = i / (TC / 8), g = i % (TC / 8);
        const int hr = hp / kHW, hc = hp % kHW;
        const int h = h0 + hr - 1, w = w0 + hc - 1, c = c0 + g * 8;
        V8 v = zero8();
        if (h >= 0 && h < a.H && w >= 0 && w < a.W && c < a.Cin) {
          const int cnt = min(8, a.Cin - c);
          const long long off = ((n * a.H + h) * a.W + w) * a.Cin + c;
          if constexpr (kExtra == kRouteIn) {
            v = routed8(a, n, h, w, c, cnt);
            // the weight gradient needs the routed cotangent too: the
            // first channel block writes the tile's own pixels of it
            if (blockIdx.y == 0 && hr >= 1 && hr <= kTH && hc >= 1 && hc <= kTW)
              store8(a.g_out + off, v, cnt);
          } else {
            v = load8(a.x + off, cnt);
          }
        }
        *reinterpret_cast<uint4*>(Xs + hp * LDA + g * 8) =
            *reinterpret_cast<const uint4*>(v.v);
      }
    }
    // B: the nine taps' weights of this chunk, [tap][out][in]
    for (int i = threadIdx.x; i < T::kTaps * TN * (TC / 8); i += kThreads) {
      const int row = i / (TC / 8), g = i % (TC / 8);
      const int tap = row / TN, o = row % TN;
      const bf16* src =
          kStem ? a.w + static_cast<long long>(n0 + o) * kStemK + g * 8
                : a.w + (static_cast<long long>(tap) * a.Cout_p + n0 + o) * a.Cin_p +
                      c0 + g * 8;
      *reinterpret_cast<uint4*>(Ws + row * LDA + g * 8) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
    __syncthreads();
    if constexpr (kExtra == kPoolIn) {
      if (blockIdx.y == 0) pool_staged_input<TC, LDA>(a, Xs, n, h0, w0, c0);
    }

#pragma unroll 1
    for (int tap = 0; tap < T::kTaps; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
#pragma unroll
      for (int kk = 0; kk < TC; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int mt = wm * MT + i;  // 16 pixels: tile row mt/2, columns
          const int j = lane & 15;     // (mt%2)*16 .. +15
          const int arow = kStem ? mt * 16 + j
                                 : ((mt >> 1) + kh) * kHW + (mt & 1) * 16 + j + kw;
          ldmatrix_x4(af[i], Xs + arow * LDA + kk + (lane >> 4) * 8);
        }
        uint32_t bfr[NT8][2];
#pragma unroll
        for (int jn = 0; jn < NT8 / 2; ++jn) {
          const int nb = wn * (NT8 * 8) + jn * 16;
          uint32_t r4[4];
          ldmatrix_x4(r4, Ws + (tap * TN + nb + (lane & 7) + ((lane >> 4) << 3)) * LDA +
                              kk + ((lane >> 3) & 1) * 8);
          bfr[2 * jn][0] = r4[0];
          bfr[2 * jn][1] = r4[1];
          bfr[2 * jn + 1][0] = r4[2];
          bfr[2 * jn + 1][1] = r4[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jt = 0; jt < NT8; ++jt) mma_bf16(acc[i][jt], af[i], bfr[jt][0], bfr[jt][1]);
      }
    }
    __syncthreads();
  }

  // epilogue, through shared memory: f32 accumulators per (pixel, channel)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = (wm * MT + i) * 16 + (lane >> 2);
#pragma unroll
    for (int jt = 0; jt < NT8; ++jt) {
      const int col = wn * (NT8 * 8) + jt * 8 + (lane & 3) * 2;
      Cs[p * LDC + col] = acc[i][jt][0];
      Cs[p * LDC + col + 1] = acc[i][jt][1];
      Cs[(p + 8) * LDC + col] = acc[i][jt][2];
      Cs[(p + 8) * LDC + col + 1] = acc[i][jt][3];
    }
  }
  __syncthreads();

  const int H2 = (a.H + 1) >> 1, W2 = (a.W + 1) >> 1;
  for (int u = threadIdx.x; u < (kTP / 4) * (TN / 8); u += kThreads) {
    const int win = u / (TN / 8), g = u % (TN / 8);
    const int wr = win / (kTW / 2), wc = win % (kTW / 2);
    const int d = n0 + g * 8;
    const int hb = h0 + 2 * wr, wb = w0 + 2 * wc;
    if (d >= a.Cout || hb >= a.H || wb >= a.W) continue;
    const int cnt = min(8, a.Cout - d);
    const long long pp = ((n * H2 + (hb >> 1)) * W2 + (wb >> 1)) * a.Cout + d;
    V8 m, dp;
    bool taken[8];
    if constexpr (kExtra == kPoolAdd) {
      m = load8(a.zp + pp, cnt);
      dp = load8(a.dzp + pp, cnt);
#pragma unroll
      for (int e = 0; e < 8; ++e) taken[e] = false;
    }
    float pmax[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the window's pixels in row-major order
      const int h = hb + (q >> 1), w = wb + (q & 1);
      if (h >= a.H || w >= a.W) continue;
      const int p = (2 * wr + (q >> 1)) * kTW + 2 * wc + (q & 1);
      const long long off = ((n * a.H + h) * a.W + w) * a.Cout + d;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[p * LDC + g * 8 + e];
      if constexpr (kEpi == kBiasRelu) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = v[e] + (e < cnt ? a.bias[d + e] : 0.f);
          v[e] = t > 0.f ? t : 0.f;
        }
      }
      if constexpr (kEpi == kMask) {
        const V8 zz = load8(a.z + off, cnt);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float zv = f32(zz.v[e]);
          v[e] = zv > 0.f ? v[e] : 0.f;
          if constexpr (kExtra == kPoolAdd) {
            if (!taken[e] && zv == f32(m.v[e])) {
              taken[e] = true;
              v[e] += f32(dp.v[e]);
            }
          }
        }
      }
      V8 out;
#pragma unroll
      for (int e = 0; e < 8; ++e) out.v[e] = __float2bfloat16(v[e]);
      store8(a.y + off, out, cnt);
      if constexpr (kExtra == kPoolOut) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          pmax[e] = q == 0 ? f32(out.v[e]) : fmaxf(pmax[e], f32(out.v[e]));
      }
    }
    if constexpr (kExtra == kPoolOut) {
      V8 pm;
#pragma unroll
      for (int e = 0; e < 8; ++e) pm.v[e] = __float2bfloat16(pmax[e]);
      store8(a.pooled + pp, pm, cnt);
    }
  }
}

template <int TN, int TC, int kEpi, int kExtra>
int launch(const Args& a, cudaStream_t stream) {
  using T = Tile<TN, TC, kExtra>;
  if (a.Cout_p % TN != 0 || a.Cout_p < a.Cout) return cudaErrorInvalidValue;
  if (T::kStem ? (a.Cin_p != kStemK || 9 * a.Cin > kStemK)
               : (a.Cin_p % TC != 0 || a.Cin_p < a.Cin)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = conv3x3_kernel<TN, TC, kEpi, kExtra>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.N * a.tiles_h * a.tiles_w), a.Cout_p / TN);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. `mode` picks the variant; the
// wrapper (osvos_torch/ops/kernels/flatconv.py) lays the weights out as
// (9, Cout_p, Cin_p) bf16 with the mode's channel tiles (TN, TC):
//   0 B2 conv + bias + ReLU               (TN 64, TC 32)
//   1 B2 the same, and the pool of y      (TN 64, TC 32)
//   2 B2 the stem, im2col of C <= 3       (TN 64, (Cout_p, 32) weights)
//   3 B5 side conv, no bias or ReLU       (TN 16, TC 32)
//   4 B5 the same, and the pool of x      (TN 16, TC 32)
//   5 B3 dz = conv_T(g) * (z > 0)         (TN 64, TC 32)
//   6 B3 the same with g routed from the pooled cotangent (TN 64, TC 32)
//   7 B6 dz = conv_T(g_side) * (z > 0)    (TN 64, TC 16)
//   8 B6 the same plus the routed pool cotangent of z (TN 64, TC 16)
// Every pointer that a mode reads or writes is 16-byte aligned. Returns
// cudaGetLastError() after the launch on `stream`, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int osvos_flat_conv3x3(int mode, const void* x, const void* w,
                                  const void* bias, void* y, void* pooled,
                                  const void* z, const void* zp, const void* dzp,
                                  void* g_out, int N, int H, int W, int Cin,
                                  int Cout, int Cin_p, int Cout_p, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || x == nullptr ||
      w == nullptr || y == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* p : {x, w, static_cast<const void*>(bias),
                        static_cast<const void*>(y),
                        static_cast<const void*>(pooled), z, zp, dzp,
                        static_cast<const void*>(g_out)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool need_bias = mode <= 2, need_pool = mode == 1 || mode == 4;
  const bool need_z = mode >= 5, need_route = mode == 6 || mode == 8;
  if ((need_bias && bias == nullptr) || (need_pool && pooled == nullptr) ||
      (need_z && z == nullptr) ||
      (need_route && (zp == nullptr || dzp == nullptr)) ||
      (mode == 6 && g_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.pooled = static_cast<bf16*>(pooled);
  a.z = static_cast<const bf16*>(z);
  a.zp = static_cast<const bf16*>(zp);
  a.dzp = static_cast<const bf16*>(dzp);
  a.g_out = static_cast<bf16*>(g_out);
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.Cin_p = Cin_p;
  a.Cout_p = Cout_p;
  a.tiles_h = (H + kTH - 1) / kTH;
  a.tiles_w = (W + kTW - 1) / kTW;
  if (static_cast<long long>(N) * a.tiles_h * a.tiles_w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<64, 32, kBiasRelu, kNone>(a, s);
    case 1: return launch<64, 32, kBiasRelu, kPoolOut>(a, s);
    case 2: return launch<64, kStemK, kBiasRelu, kIm2col>(a, s);
    case 3: return launch<16, 32, kPlain, kNone>(a, s);
    case 4: return launch<16, 32, kPlain, kPoolIn>(a, s);
    case 5: return launch<64, 32, kMask, kNone>(a, s);
    case 6: return launch<64, 32, kMask, kRouteIn>(a, s);
    case 7: return launch<64, 16, kMask, kNone>(a, s);
    case 8: return launch<64, 16, kMask, kPoolAdd>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
