// Flat-trunk 3x3 convolutions of the online fine-tune, NHWC, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of osvos_tpu/ops/pallas/flatconv.py:
//   B2 `_fwd_kernel` (flat_conv3x3 forward: conv + f32 bias + ReLU, the
//      3-channel stem, and the stage-boundary pool in the epilogue, the
//      function of flatpool.packed_conv_pool);
//   B3 `_bwd_fused_kernel`, its input-gradient half: dz = conv_T(g, K) *
//      (z_in > 0), the function of B15 `_dgrad_kernel`. The pool backward
//      that B3 runs in its prologue at a pooled conv is csrc/pool.cu's
//      backward (B10's kernel) here, launched before this one, so dz takes
//      the routed cotangent like any other;
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
// the cotangent with the flipped, transposed kernel, so one implicit GEMM
// serves all four rows: M = output pixels, N = output channels, K = 9 x
// input channels; the rows differ in how the input is staged and in the
// epilogue.
//
// Bound. Per trunk conv 2 * 9 * C * D * N * H * W operations on the tensor
// cores against reading x and writing y once: at stage 1 (C = D = 64,
// batch 5, 480x854) 151 GFLOP against 0.5 GB, 0.153 ms at the card's 989
// TFLOP/s, so operations bound it. The side convs (C -> 16 and back) do
// 2 * 9 * C * 16 * N * H * W operations against x read once (and, for
// B6, z read and dz written): at side_prep1 (C = 128, 240x427) 19 GFLOP
// against 0.18 GB (B5) or 0.34 GB (B6), so bytes bound them.
//
// Two paths; the mode and the shape pick one (ops/kernels/flatconv.py
// `plan`), a failure never does. Every launch reads its weight operand
// as bf16 [tap][out][in] rows, zero-padded to the tiles, from the pack
// kernel (`osvos_flat_pack_weight`), one launch a call; B6's dz on the
// Hopper path packs its blocks' tiles itself.
//
// The Hopper path (`osvos_flat_conv3x3_tma`: modes 0, 1 and 5 with C and D
// multiples of 8, which TMA's 16-byte strides need: every trunk conv after
// the stem, forward and dz). A tile is R image rows of one 64-pixel row
// segment (w0 a multiple of 64, h0 of R) and TN output channels: R x TN =
// 4 x 64 for D <= 64, else 2 x 128, which is R m64 x TN float32
// accumulators, 128 registers a thread either way. A producer warpgroup
// (one thread issues the loads; setmaxnreg gives its registers away) feeds
// two consumer warpgroups through a ring of stages with full and empty
// mbarriers.
// - A stage is one K-step: a 64-channel chunk c0 and a kernel row kh. TMA
//   loads the input box of 64 channels x 66 pixels x R rows at (c0, w0 - 1,
//   h0 + kh - 1, n) with the 128-byte swizzle; its zero fill outside the
//   image and past C gives the SAME padding and the ragged edges with no
//   code of its own. The three taps (kh, kw) read that box through wgmma
//   descriptors started kw pixel rows (128 bytes each) into the image row,
//   K-major (the channels contiguous), so the box is loaded once for three
//   taps (the TPU kernel's "tap = row offset"). The stage also holds the
//   three taps' weights, TN x 64 channels each, one TMA box of the (9,
//   Cout_p, Cin_p) [tap][out][in] operand, which is K-major as it is.
// - Why a K-step is (chunk, kh) and not a chunk with all nine taps: nine
//   taps' weights are 9 * TN * 128 bytes, 147 KB at TN = 128, which leaves
//   no room for a second stage; a kh's three taps are 24 or 48 KB, and
//   stages of 57 KB (4 x 64) or 65 KB (2 x 128) keep 3 in flight within the
//   227 KB. The input box is then read three times from L2 per tile, once
//   a kh; at the 128-channel tiles the weights are most of what a stage
//   reads, and L2 bandwidth bounds the deep stages (PERF.md).
// - The consumers take turns ("ping-pong"): warpgroup wg multiplies the
//   block's tiles wg, wg + 2, ... and writes one tile while the other
//   multiplies the next; a turn barrier hands over the tensor cores.
// - No split-K: every K-step of a tile is summed in one warpgroup's
//   registers in one order, so two launches give the same bits.
// - The grid is at most one block per SM; block b takes tiles b, b + grid,
//   ... (output-channel tile fastest, so the blocks in flight share input
//   boxes in L2), and the producer runs on into the next tiles while a
//   consumer writes the last one.
// - The epilogue works on the accumulator registers, with what it reads (z
//   or the bias) loaded into registers before the tile's products: mode 0
//   adds the f32 bias before the ReLU and rounds once; mode 1 also pools
//   the rounded y, each 2x2 window lying in one tile (R even, h0 even): the
//   thread holds both rows of its pixel, and the pixel to its right is in
//   lane + 4; mode 5 masks with z > 0 at the output pixel. Pixels past H or
//   W and channels past D are not stored.
// - Mode 6 is the fast trunk's forward (ops/fastconv.py
//   `conv3x3_bias_relu_seq`), relu(bf16(bf16(conv) + b)) with b in bf16:
//   the accumulator rounded to bf16, the bias added and rounded again, as
//   the fast mode's separate bias add does, then the ReLU. Where mode 0
//   rounds once, mode 6 keeps both roundings; it differs from a library
//   conv followed by the bias add and the ReLU only in the order of the
//   float32 sums.
//
// S sequences in one launch (B2-seq, the packed schedule's trunk forward,
// ops/kernels/flatconv.py `conv_fwd_seq`; mode 6 only). x is (N, H, W,
// S * Cin) and y (N, H, W, S * Cout), sequence s the channels [s * Cin,
// (s + 1) * Cin) and [s * Cout, (s + 1) * Cout); the weight operand is S
// packs, (S, 9, Cout_p, Cin_p), one pack launch for all. x is a 5-D map
// (Cin, S, W, H, N), so a box at sequence s reads its channels in place and
// the zero fill stops at its own Cin (csrc/wgrad.cu's sequence launch does
// the same). Each sequence runs the lone launch's plan: its blocks, tiles
// and tile order, every K-step of a tile in one warpgroup in one order, so
// its output is bit for bit a lone launch's on its slice. The lone launch
// is S = 1. The grid is S lone grids one after another, the sequence the
// slowest index: grid block i runs block i % blocks of sequence i / blocks.
// - Why sequence-major, against hopper.cuh's `seq_block` (the sequence
//   fastest, as B17-seq dispatches): with the S blocks of one rank side by
//   side, the weights of every sequence are in use at once, at C = D = 512
//   20 x 4.7 MB against the 50 MB L2, and the stage-4 and stage-5 convs
//   took twice as long; at C = 64, where a sequence's slice of a pixel is
//   half of the maps' 256-byte L2 promotion, the side by side order gained
//   nothing measurable. Over the 12 convs of a packed step at S = 20 the
//   sequence-major order took 49.5 ms, groups of 2 or 4 sequences side by
//   side 50.0 and 50.8, all 20 side by side 70.6 (H100 80GB HBM3, 700 W).
//
// The side convs' Hopper path (`osvos_flat_side_tma`: modes 3, 4, 7 and 8
// with C a multiple of 8 and 8 or 16 side channels) is laid out further
// down, beside its kernels: B5 at N = 48 (three taps side by side, the kw
// shift in the epilogue), B6's dz with its weight tile resident and z
// staged by TMA.
//
// The mma path (`osvos_flat_conv3x3`: the stem, and C or D off a multiple
// of 8, the side convs' included), the first design: a block owns a 4 x 32
// pixel tile of one image (both even-aligned, so every 2x2 pool window lies
// inside one block) and TN output channels. For each chunk of TC input
// channels it stages the haloed input tile (rows h0-1 .. h0+4, columns
// w0-1 .. w0+32; zero off the image) and the nine taps' weights in shared
// memory with ordinary loads; the nine taps are then offsets into the
// staged tile, read by ldmatrix with per-lane addresses, and multiplied
// with mma.sync m16n8k16 bf16 into f32 accumulators. The epilogue goes
// through shared memory, 2x2 window by window, so the pool (max of the
// rounded outputs, or the routing of a pooled cotangent) needs no other
// pass. The 3-channel stem stages an im2col tile instead (K = 27, padded to
// 32), so it does not pad each tap's 3 channels to a chunk. Staging and
// products alternate between barriers, with no copy pipeline.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

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
enum Extra { kNone = 0, kPoolOut = 1, kPoolIn = 2, kPoolAdd = 3, kIm2col = 4 };

struct Args {
  const bf16* x;      // (N, H, W, Cin) the product's input
  const bf16* w;      // (9, Cout_p, Cin_p) bf16 [tap][out][in]; kIm2col:
                      // (Cout_p, 32) [out][tap * Cin + c]
  const float* bias;  // (Cout), kBiasRelu
  bf16* y;            // (N, H, W, Cout)
  bf16* pooled;       // kPoolOut: pool of y; kPoolIn: pool of x
  const bf16* z;      // kMask: (N, H, W, Cout), the mask (z > 0) and, with
                      // kPoolAdd, the pool's input
  const bf16* zp;     // kPoolAdd: the pooled map (its max values)
  const bf16* dzp;    // and its cotangent
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
          v = load8(a.x + ((n * a.H + h) * a.W + w) * a.Cin + c, cnt);
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
  static SmemOnce smem_once;
  const int err = smem_once.set(kernel, T::kSmem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(a.N * a.tiles_h * a.tiles_w), a.Cout_p / TN);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The Hopper path: TMA, an mbarrier ring, wgmma (modes 0, 1 and 5)
// ---------------------------------------------------------------------------

constexpr int kNumSMs = 132;
constexpr int kSeg = 64;                     // pixels of an m64 tile
constexpr int kBoxW = kSeg + 2;              // a segment and its two halo pixels
constexpr int kChunk = 64;                   // input channels of a K-step
constexpr int kRowBytes = kChunk * 2;        // a pixel's 128-byte swizzled row
constexpr int kConsumerWGs = 2;
constexpr int kConsumerThreads = 128 * kConsumerWGs;
// + the producer warpgroup: one thread issues the loads, and the four warps
// give their registers to the consumers (setmaxnreg: 40 and 232 a thread)
constexpr int kHopperThreads = kConsumerThreads + 128;
constexpr int kSmemLimit = 227 * 1024;

enum HEpi { kHBiasRelu = 0, kHBiasReluPool = 1, kHMask = 2, kHBiasReluFast = 3 };

template <int TN, int R>
struct HCfg {
  static constexpr int kABytes = R * kBoxW * kRowBytes;
  static constexpr int kASlot = (kABytes + 1023) / 1024 * 1024;
  static constexpr int kBBytes = 3 * TN * kRowBytes;  // a kh's three taps
  static constexpr int kStage = kASlot + kBBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - 256) / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr uint32_t kTx = kABytes + kBBytes;  // bytes a stage
  // the ring, its full and empty barriers and the two turn barriers
  static constexpr int kSmem = 1024 + kStages * kStage + (2 * kStages + 2) * 8;
  static_assert(kBBytes % 1024 == 0 && kStages >= 2, "the stage ring");
  static_assert(R % 2 == 0, "2x2 pool windows lie in one tile");
};

struct HShape {
  int N, H, W, Cout;
  int seg_w;        // output pixels of a row segment
  int segs;         // row segments of an image row
  int groups;       // groups of R image rows
  int n_tiles;      // output-channel tiles
  int chunks;       // 64-channel chunks of the input
  long long tiles;  // N * groups * segs * n_tiles
  // the sequence launch: S sequences, channels interleaved (S * Cout a
  // pixel of y), each a lone grid of `blocks`
  int S = 1, blocks = 0;
};

struct HArgs {
  const float* bias;  // (Cout), modes 0 and 1
  const bf16* bias16; // (S * Cout), mode 6
  bf16* y;            // (N, H, W, Cout)
  bf16* pooled;       // mode 1: (N, ceil(H/2), ceil(W/2), Cout)
  const bf16* z;      // mode 5: (N, H, W, Cout), the mask z > 0
};

struct HTile {
  int n, h0, w0, d0;
  int seq = 0;
};

// Tile t (of sequence `seq`): output-channel tile fastest, then the row
// segment, the row group and the image (ops/kernels/flatconv.py Plan.tile).
__device__ __forceinline__ HTile tile_at(const HShape& s, long long t, int rows,
                                         int tn, int seq = 0) {
  HTile r;
  r.seq = seq;
  r.d0 = static_cast<int>(t % s.n_tiles) * tn;
  long long m = t / s.n_tiles;
  r.w0 = static_cast<int>(m % s.segs) * s.seg_w;
  m /= s.segs;
  r.h0 = static_cast<int>(m % s.groups) * rows;
  r.n = static_cast<int>(m / s.groups);
  return r;
}

// K-steps of a tile: one per (64-channel chunk, kh), kh fastest.
__device__ __forceinline__ int k_steps(const HShape& s) { return 3 * s.chunks; }

// Grid block i runs the lone block sb.block = i % blocks of sequence
// sb.seq = i / blocks (a lone launch: block i). The block's l-th tile is
// sb.block + l * s.blocks of its sequence; its K-steps take the ring's
// slots l * k_steps .. in order, stage slot % kStages.
template <int TN, int R>
__device__ void hopper_produce(const CUtensorMap* amap, const CUtensorMap* bmap,
                               uint8_t* smem, uint64_t* full, uint64_t* empty,
                               const HShape& s, const SeqBlock sb) {
  using K = HCfg<TN, R>;
  const int steps = k_steps(s);
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = sb.block; t < s.tiles; t += s.blocks) {
    const HTile tl = tile_at(s, t, R, TN, sb.seq);
    for (int k = 0; k < steps; ++k) {
      const int c0 = k / 3 * kChunk, kh = k % 3;
      uint8_t* st = smem + stage * K::kStage;
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], K::kTx);
      // image rows h0 + kh - 1 .., pixels w0 - 1 .. w0 + 64 (zeros outside)
      tma_load(st, amap, &full[stage], c0, tl.seq, tl.w0 - 1, tl.h0 + kh - 1, tl.n);
      // the weights of taps (kh, 0..2), TN output rows of 64 input channels
      tma_load(st + K::kASlot, bmap, &full[stage], c0, tl.d0, 3 * kh, tl.seq);
      if (++stage == K::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

__device__ __forceinline__ float bias_relu(float v, float b) {
  const float t = v + b;
  return t > 0.f ? t : 0.f;
}

// Mode 6: the accumulator rounded to bf16, the bf16 bias added and the sum
// rounded again, then the ReLU.
__device__ __forceinline__ float bias_relu_fast(float v, float b) {
  const float c = __bfloat162float(__float2bfloat16_rn(v));
  const float t = __bfloat162float(__float2bfloat16_rn(c + b));
  return t > 0.f ? t : 0.f;
}

__device__ __forceinline__ float masked(float v, bf16 z) {
  return __bfloat162float(z) > 0.f ? v : 0.f;
}

// The larger of this lane's value and that of the pixel to its right in
// the 2x2 window (lane + 4 holds pixel row + 1 of the accumulator).
__device__ __forceinline__ float pair_max(float m) {
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
}

// Thread `tid` of the warpgroup holds, of image row h0 + i, pixels w0 + 16 *
// warp + lane / 4 (+ 8) and channels d0 + 8 * j + 2 * (lane % 4) (+ 1):
// acc[i][4 j + 2 half + e], the wgmma accumulator layout. What the epilogue
// reads (z or the bias) the warpgroup loads into registers before the
// tile's products, so the loads wait behind them.
template <int TN, int R, int kEpi>
struct EpiIn {
  __nv_bfloat162 z[kEpi == kHMask ? R : 1][TN / 8][2];  // kHMask
  float2 bias[kEpi == kHMask ? 1 : TN / 8];             // the others
};

// Channel d of pixel (h, w) of the tile's image and sequence in y (or z).
__device__ __forceinline__ long long pixel(const HShape& s, const HTile& tl,
                                           int h, int w, int d) {
  return ((static_cast<long long>(tl.n) * s.H + h) * s.W + w) * s.S * s.Cout +
         tl.seq * s.Cout + d;
}

template <int TN, int R, int kEpi>
__device__ __forceinline__ void epilogue_loads(EpiIn<TN, R, kEpi>& in,
                                               const HArgs& a, const HShape& s,
                                               const HTile& tl, int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int d = tl.d0 + 8 * j + 2 * (lane % 4);
    if constexpr (kEpi == kHMask) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = tl.h0 + i, w = tl.w0 + 16 * warp + lane / 4 + 8 * half;
          in.z[i][j][half] =
              d < s.Cout && h < s.H && w < s.W
                  ? *reinterpret_cast<const __nv_bfloat162*>(a.z + pixel(s, tl, h, w, d))
                  : __floats2bfloat162_rn(0.f, 0.f);
        }
    } else if constexpr (kEpi == kHBiasReluFast) {
      in.bias[j] = d < s.Cout ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                    a.bias16 + tl.seq * s.Cout + d))
                              : make_float2(0.f, 0.f);
    } else {
      in.bias[j] = d < s.Cout ? *reinterpret_cast<const float2*>(a.bias + d)
                              : make_float2(0.f, 0.f);
    }
  }
}

template <int TN, int R, int kEpi>
__device__ __forceinline__ void hopper_epilogue(float (&acc)[R][TN / 2],
                                                const EpiIn<TN, R, kEpi>& in,
                                                const HArgs& a, const HShape& s,
                                                const HTile& tl, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int H2 = (s.H + 1) >> 1, W2 = (s.W + 1) >> 1;
  const float kNegInf = __int_as_float(0xff800000);
  float pm[TN / 8][2][2];  // kHBiasReluPool: the max of the window's upper row
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = tl.h0 + i;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int d = tl.d0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = tl.w0 + 16 * warp + lane / 4 + 8 * half;
        const bool inside = d < s.Cout && h < s.H && w < s.W;
        float v0 = acc[i][4 * j + 2 * half], v1 = acc[i][4 * j + 2 * half + 1];
        if constexpr (kEpi == kHMask) {
          v0 = masked(v0, in.z[i][j][half].x);
          v1 = masked(v1, in.z[i][j][half].y);
        } else if constexpr (kEpi == kHBiasReluFast) {
          v0 = bias_relu_fast(v0, in.bias[j].x);
          v1 = bias_relu_fast(v1, in.bias[j].y);
        } else {
          v0 = bias_relu(v0, in.bias[j].x);
          v1 = bias_relu(v1, in.bias[j].y);
        }
        const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
        if (inside) *reinterpret_cast<__nv_bfloat162*>(a.y + pixel(s, tl, h, w, d)) = out;
        if constexpr (kEpi == kHBiasReluPool) {
          const float o0 = inside ? __bfloat162float(out.x) : kNegInf;
          const float o1 = inside ? __bfloat162float(out.y) : kNegInf;
          if (i % 2 == 0) {
            pm[j][half][0] = o0;
            pm[j][half][1] = o1;
          } else {  // rows h - 1 and h: the window at (h - 1, w & ~1)
            const float m0 = pair_max(fmaxf(pm[j][half][0], o0));
            const float m1 = pair_max(fmaxf(pm[j][half][1], o1));
            if ((lane & 4) == 0 && d < s.Cout && h - 1 < s.H && w < s.W) {
              const long long po =
                  ((static_cast<long long>(tl.n) * H2 + (h - 1) / 2) * W2 + w / 2) *
                      s.Cout + d;
              *reinterpret_cast<__nv_bfloat162*>(a.pooled + po) =
                  __floats2bfloat162_rn(m0, m1);
            }
          }
        }
      }
    }
  }
}

// Two consumer warpgroups take turns ("ping-pong"): warpgroup wg takes the
// block's tiles l = wg, wg + 2, ..., all R rows of each, so one writes its
// tile while the other multiplies. turn[wg] hands it the tensor cores: the
// other warpgroup arrives there when its products are done. This also keeps
// a warpgroup from waiting on a ring slot a whole tile ahead of the slots in
// use, whose barrier parity would still be that of an earlier phase.
template <int TN, int R, int kEpi>
__device__ void hopper_consume(uint8_t* smem, uint64_t* full, uint64_t* empty,
                               uint64_t* turn, const HArgs& a, const HShape& s,
                               const SeqBlock sb) {
  using K = HCfg<TN, R>;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const uint32_t base = smem_u32(smem);
  const int steps = k_steps(s);
  float acc[R][TN / 2];
  int j = 0;  // this warpgroup's tiles so far
  for (long long l = wg; sb.block + l * s.blocks < s.tiles;
       l += kConsumerWGs, ++j) {
    const HTile tl = tile_at(s, sb.block + l * s.blocks, R, TN, sb.seq);
    EpiIn<TN, R, kEpi> in;
    epilogue_loads<TN, R, kEpi>(in, a, s, tl, tid);
    // the other warpgroup's previous tile has been multiplied: turn[1]
    // completes phase j with warpgroup 0's tile j, turn[0] phase j - 1 with
    // warpgroup 1's tile j - 1
    if (l > 0) mbar_wait(&turn[wg], static_cast<uint32_t>(j - 1 + wg) & 1);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc[i][e] = 0.f;
    int pending = -1;
    for (int k = 0; k < steps; ++k) {
      const long long slot = l * steps + k;
      const int stage = static_cast<int>(slot % K::kStages);
      mbar_wait(&full[stage], static_cast<uint32_t>(slot / K::kStages) & 1);
      const uint32_t as = base + stage * K::kStage;
      const uint32_t bs = as + K::kASlot;
#pragma unroll
      for (int i = 0; i < R; ++i) fence_acc(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          const uint64_t b =
              smem_desc(bs + kw * TN * kRowBytes + kk * 32, 1024, 1);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            // tap (kh, kw) of image row h0 + i: that row of the box from
            // pixel kw on
            const int row = i * kBoxW + kw;
            wgmma_bf16<TN, 0, 0>(
                acc[i], smem_desc(as + row * kRowBytes + kk * 32, 1024, 1), b);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int i = 0; i < R; ++i) fence_acc(acc[i]);
      if (pending >= 0) release(&empty[pending], lane);
      pending = stage;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < R; ++i) fence_acc(acc[i]);
    if (pending >= 0) release(&empty[pending], lane);
    release(&turn[wg ^ 1], lane);
    hopper_epilogue<TN, R, kEpi>(acc, in, a, s, tl, tid);
  }
}

template <int TN, int R, int kEpi>
__global__ void __launch_bounds__(kHopperThreads, 1) conv3x3_tma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap, const HArgs a, const HShape s) {
  using K = HCfg<TN, R>;
  extern __shared__ uint8_t hsmem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(hsmem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::kStages * K::kStage);
  uint64_t* empty = full + K::kStages;
  uint64_t* turn = empty + K::kStages;
  if (threadIdx.x == 0) {
    // a stage or a turn is one warpgroup's: one arrival per warp
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    ring_init(full, empty, K::kStages, 4);
  }
  __syncthreads();
  const SeqBlock sb{static_cast<int>(blockIdx.x / s.blocks),
                    static_cast<int>(blockIdx.x % s.blocks)};
  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumerThreads) {
      hopper_produce<TN, R>(&amap, &bmap, smem, full, empty, s, sb);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  hopper_consume<TN, R, kEpi>(smem, full, empty, turn, a, s, sb);
}

// x a 5-D map (Cin, S, W, H, N) with an R-row box, the weights a 4-D map
// (Cin_p, Cout_p, 9, S); the grid is s.S lone grids of s.blocks.
template <int TN, int R, int kEpi>
int launch_hopper(const void* x, const void* w, const HArgs& a,
                  const HShape& s, int Cin, int Cin_p, int Cout_p,
                  cudaStream_t stream) {
  using K = HCfg<TN, R>;
  CUtensorMap amap, bmap;
  int err = encode_map5(&amap, x, s.N, s.H, s.W, s.S, Cin, kChunk, kBoxW,
                        CU_TENSOR_MAP_SWIZZLE_128B, R);
  if (err == 0) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cin_p),
                                static_cast<cuuint64_t>(Cout_p), 9,
                                static_cast<cuuint64_t>(s.S)};
    const cuuint32_t box[4] = {kChunk, TN, 3, 1};
    err = encode_bf16_map(&bmap, w, 4, dims, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  static SmemOnce smem_once;
  const int attr = smem_once.set(conv3x3_tma_kernel<TN, R, kEpi>, K::kSmem);
  if (attr != 0) return attr;
  conv3x3_tma_kernel<TN, R, kEpi>
      <<<s.blocks * s.S, kHopperThreads, K::kSmem, stream>>>(amap, bmap, a, s);
  return static_cast<int>(cudaGetLastError());
}

template <int TN, int R>
int dispatch_epi(int mode, const void* x, const void* w, const HArgs& a,
                 const HShape& s, int Cin, int Cin_p, int Cout_p,
                 cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch_hopper<TN, R, kHBiasRelu>(x, w, a, s, Cin, Cin_p, Cout_p,
                                              stream);
    case 1:
      return launch_hopper<TN, R, kHBiasReluPool>(x, w, a, s, Cin, Cin_p,
                                                  Cout_p, stream);
    case 5:
      return launch_hopper<TN, R, kHMask>(x, w, a, s, Cin, Cin_p, Cout_p,
                                          stream);
    case 6:
      return launch_hopper<TN, R, kHBiasReluFast>(x, w, a, s, Cin, Cin_p,
                                                  Cout_p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The Hopper path of the side convs: B5 (modes 3, 4) and B6's dz (modes 7,
// 8), C -> 16 and 16 -> C
// ---------------------------------------------------------------------------

constexpr int kSideD = 16;        // side channels
// image rows of a B6 tile (B5: 2 or 4). Two rows keep the stage (g, z and
// the pool boxes) at 33 KB, so six fit: with both consumer warpgroups in
// their epilogues, four are still loading (4 rows left one).
constexpr int kDzRows = 2;
constexpr int kGRowBytes = kSideD * 2;  // a pixel of g: one 32-byte row
// B5: a tile row is kFwdSeg output pixels read from a box of kFwdBox
// pixels, [w0 - 1, w0 + kFwdSeg + 1)
constexpr int kFwdBox = 64;
constexpr int kFwdSeg = kFwdBox - 2;

// B5's product at N = 48, not 16 (one tap's 16 outputs): a third of the
// wgmma instructions, each reading its 64 x 16 A tile from shared memory
// once for three taps. For output row i and kernel row kh, one wgmma
// multiplies the box row
// i + kh from its first pixel by the three kw taps' weights side by side,
// Q[p][16 kw + d] = sum_c box[i + kh][p][c] K[kh, kw, c, d], summed over
// kh and the chunks in the accumulator; then out[p][d] = Q[p][d] +
// Q[p + 1][16 + d] + Q[p + 2][32 + d], the kw shift taken in the epilogue
// through shared memory. A 64-pixel box row so gives 62 outputs.
// A stage is one 64-channel chunk: the (R + 2) x 64 pixel box and the
// nine taps' 16 x 64 weights, which the (9, 16, Cin_p) operand holds as
// three 48-row kernel rows, one B operand each. Two consumer warpgroups
// share each stage, warpgroup wg taking rows [wg R / 2, (wg + 1) R / 2)
// of the product and half of the input pool: one warpgroup alone spent
// about as long on the pool as on issuing the products (H100).
template <int R>
struct SFCfg {
  static constexpr int kRows = R / 2;  // a warpgroup's image rows
  static constexpr int kABytes = (R + 2) * kFwdBox * kRowBytes;
  static constexpr int kBBytes = 9 * kSideD * kRowBytes;
  static constexpr int kStage = kABytes + kBBytes;
  // each warpgroup's epilogue buffer: Q[p][16..47] of one row, rows of
  // kQStride floats
  static constexpr int kQStride = 36;
  static constexpr int kQBytes = kFwdBox * kQStride * 4;
  static constexpr int kFit = (kSmemLimit - 1024 - 2 * kQBytes - 256) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr uint32_t kTx = kABytes + kBBytes;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kQBytes + 2 * kStages * 8;
  static constexpr int kThreads = 256 + 32;  // two consumer warpgroups, a producer warp
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0 && kStages >= 2,
                "the stage ring");
  static_assert(R % 2 == 0 && kFwdSeg % 2 == 0, "2x2 pool windows lie in one tile");
};

// B5 mode 4: the ceil-mode 2x2/2 max pool of the staged chunk's in-image
// pixels (rows 1..R, pixels 1..62 of the box; never the zero fill), read
// through the 128-byte swizzle, 16-byte stores.
template <int R>
__device__ __forceinline__ void pool_box(const uint8_t* box, bf16* pooled,
                                         const HShape& s, const HTile& tl,
                                         int c0, int Cin, int tid) {
  const int H2 = (s.H + 1) >> 1, W2 = (s.W + 1) >> 1;
  constexpr int kUnits = (R / 2) * (kFwdSeg / 2) * (kChunk / 8);
  for (int u = tid; u < kUnits; u += 256) {
    const int q = u % 8, win = u / 8;
    const int pc = win % (kFwdSeg / 2), pr = win / (kFwdSeg / 2);
    const int hb = tl.h0 + 2 * pr, wb = tl.w0 + 2 * pc, c = c0 + 8 * q;
    if (hb >= s.H || wb >= s.W || c >= Cin) continue;
    float m[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // the window's pixels in row-major order
      if (hb + (e >> 1) >= s.H || wb + (e & 1) >= s.W) continue;
      const int row = (2 * pr + (e >> 1) + 1) * kFwdBox + 2 * pc + (e & 1) + 1;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          box + row * kRowBytes + ((q ^ (row & 7)) << 4));
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = e == 0 ? f32(v[k]) : fmaxf(m[k], f32(v[k]));
    }
    V8 out;
#pragma unroll
    for (int k = 0; k < 8; ++k) out.v[k] = __float2bfloat16(m[k]);
    *reinterpret_cast<uint4*>(
        pooled + ((static_cast<long long>(tl.n) * H2 + (hb >> 1)) * W2 + (wb >> 1)) * Cin + c) =
        *reinterpret_cast<const uint4*>(out.v);
  }
}

template <int R, bool kPool>
__global__ void __launch_bounds__(SFCfg<R>::kThreads, 1) side_fwd_tma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap, bf16* y, bf16* pooled,
    const HShape s, int Cin) {
  using K = SFCfg<R>;
  constexpr int kN = 3 * kSideD;  // the product's N: three kw taps
  extern __shared__ uint8_t hsmem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(hsmem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + K::kStages * K::kStage + 2 * K::kQBytes);
  uint64_t* empty = full + K::kStages;
  if (threadIdx.x == 0) ring_init(full, empty, K::kStages, 8);
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer
    if (threadIdx.x != 256) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      const HTile tl = tile_at(s, t, R, kSideD);
      for (int k = 0; k < s.chunks; ++k) {
        uint8_t* st = smem + stage * K::kStage;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], K::kTx);
        // rows h0 - 1 .. h0 + R, pixels w0 - 1 .. w0 + 62 (zeros outside)
        tma_load(st, &amap, &full[stage], k * kChunk, tl.w0 - 1, tl.h0 - 1, tl.n);
        // the nine taps' 16 x 64 weights of this chunk
        tma_load(st + K::kABytes, &bmap, &full[stage], k * kChunk, 0, 0);
        if (++stage == K::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  constexpr int kRows = K::kRows;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int row0 = wg * kRows;  // this warpgroup's first row of the tile
  float* qs = reinterpret_cast<float*>(smem + K::kStages * K::kStage + wg * K::kQBytes);
  const uint32_t base = smem_u32(smem);
  long long slot = 0;
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const HTile tl = tile_at(s, t, R, kSideD);
    float acc[kRows][kN / 2];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[i][e] = 0.f;
    int pending = -1;
    for (int k = 0; k < s.chunks; ++k, ++slot) {
      const int stage = static_cast<int>(slot % K::kStages);
      mbar_wait(&full[stage], static_cast<uint32_t>(slot / K::kStages) & 1);
      const uint32_t as = base + stage * K::kStage;
      const uint32_t bs = as + K::kABytes;
#pragma unroll
      for (int i = 0; i < kRows; ++i) fence_acc(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          // taps (kh, 0..2): 48 rows of the operand
          const uint64_t b = smem_desc(bs + kh * kN * kRowBytes + kk * 32, 1024, 1);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            // image row h0 + row0 + i, kernel row kh: box row row0 + i +
            // kh from pixel 0
            wgmma_bf16<kN, 0, 0>(
                acc[i],
                smem_desc(as + (row0 + i + kh) * kFwdBox * kRowBytes + kk * 32, 1024, 1),
                b);
          }
        }
      }
      wgmma_commit();
      if constexpr (kPool) {
        pool_box<R>(smem + stage * K::kStage, pooled, s, tl, k * kChunk, Cin,
                    threadIdx.x);
      }
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int i = 0; i < kRows; ++i) fence_acc(acc[i]);
      if (pending >= 0) release(&empty[pending], lane);
      pending = stage;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kRows; ++i) fence_acc(acc[i]);
    if (pending >= 0) release(&empty[pending], lane);
    // Epilogue, row by row: Q[.][16..47] through shared memory, the kw
    // shift, one bf16 rounding; lane pairs (q, q ^ 1) trade channel pairs
    // so each thread stores 4 channels (8 bytes) of its pixel.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * warp + lane / 4 + 8 * half;
#pragma unroll
        for (int j = 2; j < 6; ++j)
          *reinterpret_cast<float2*>(qs + p * K::kQStride + 8 * (j - 2) + 2 * q) =
              make_float2(acc[i][4 * j + 2 * half], acc[i][4 * j + 2 * half + 1]);
      }
      named_sync(1 + wg, 128);
      const int h = tl.h0 + row0 + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * warp + lane / 4 + 8 * half;
        float v[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // kw = 1 from pixel p + 1, kw = 2 from pixel p + 2 (rows past
          // the box only feed pixels past the tile's 62)
          const int c = 8 * j + 2 * q;
          const float2 t1 = p + 1 < kFwdBox
              ? *reinterpret_cast<const float2*>(qs + (p + 1) * K::kQStride + c)
              : make_float2(0.f, 0.f);
          const float2 t2 = p + 2 < kFwdBox
              ? *reinterpret_cast<const float2*>(qs + (p + 2) * K::kQStride + 16 + c)
              : make_float2(0.f, 0.f);
          v[j][0] = acc[i][4 * j + 2 * half] + t1.x + t2.x;
          v[j][1] = acc[i][4 * j + 2 * half + 1] + t1.y + t2.y;
        }
        const __nv_bfloat162 a0 = __floats2bfloat162_rn(v[0][0], v[0][1]);
        const __nv_bfloat162 a1 = __floats2bfloat162_rn(v[1][0], v[1][1]);
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(&a0);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(&a1);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, (q & 1) ? u0 : u1, 1);
        // even q: channels 2q .. 2q + 3; odd q: 8 + 2(q - 1) .. 8 + 2q + 1
        const uint2 out = (q & 1) ? make_uint2(got, u1) : make_uint2(u0, got);
        const int d = (q & 1) ? 8 + 2 * (q - 1) : 2 * q;
        const int w = tl.w0 + p;
        if (p < kFwdSeg && h < s.H && w < s.W && d < s.Cout)
          *reinterpret_cast<uint2*>(y + pixel(s, tl, h, w, d)) = out;
      }
      named_sync(1 + wg, 128);  // the next row overwrites Q
    }
  }
}

// B6's dz: a tile is R image rows x 64 pixels x 64 channels of dz. The
// block keeps its channel tile's nine taps of the flipped weight resident
// (9 x 64 rows of 16 channels, 18 KB), packed from the float32 OIHW weight
// by the block itself, so the launch needs no operand of its own; a stage
// is one tile's g box ((R + 2) x 66 pixels of 16 channels, 32-byte
// swizzle), its z box (R x 64 pixels x 64 channels, the mask, 128-byte
// swizzle) and, with the route, the pooled map's and its cotangent's
// boxes (R / 2 x 32 pixels). The product is nine m64n64k16 a row; the
// bytes are the epilogue's: z is read from the stage, dz written over it
// and copied out with 16-byte stores.
template <int R, bool kRoute>
struct SBCfg {
  static constexpr int kTN = 64;
  static constexpr int kGBytes = (R + 2) * kBoxW * kGRowBytes;
  static constexpr int kGSlot = (kGBytes + 1023) / 1024 * 1024;
  static constexpr int kZBytes = R * kSeg * kRowBytes;
  static constexpr int kPBytes = (R / 2) * (kSeg / 2) * kRowBytes;
  static constexpr int kStage = kGSlot + kZBytes + (kRoute ? 2 * kPBytes : 0);
  static constexpr int kWBytes = 9 * kTN * kGRowBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - kWBytes - 256) / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr uint32_t kTx =
      kGBytes + kZBytes + (kRoute ? 2 * kPBytes : 0);
  static constexpr int kSmem = 1024 + kWBytes + kStages * kStage + 2 * kStages * 8;
  // two consumer warpgroups taking alternate tiles, and a producer
  // warpgroup whose registers (setmaxnreg) go to them
  static constexpr int kThreads = 256 + 128;
  static_assert(kWBytes % 1024 == 0 && kStage % 1024 == 0 && kStages >= 2,
                "the stage ring");
  static_assert(R % 2 == 0, "2x2 pool windows lie in one tile");
};

struct SBArgs {
  const float* w;  // the OIHW (D, C, 3, 3) float32 weight of the forward
  bf16* dz;        // (N, H, W, C)
  int D, C;
};

// The block's channel tile [d0, d0 + 64) of the dz product's operand,
// [tap][c][d] = bf16(w[d, c, 2 - kh, 2 - kw]) (zero past C and D), written
// as TMA would with the 32-byte swizzle (16-byte half ^= row bit 2), by
// the kThreads consumer threads; then made visible to wgmma. Every load is
// issued before the first store, so the block waits out one L2 latency,
// not one a load.
template <int TN, int kThreads>
__device__ __forceinline__ void pack_flipped_tile(uint8_t* wsm, const SBArgs& a,
                                                  int d0, int tid) {
  constexpr int kPer = 9 * TN * kSideD / kThreads;
  static_assert(kPer * kThreads == 9 * TN * kSideD, "whole rounds");
  float v[kPer];
  // e runs over (d, c, t) with t fastest: w[d, d0 .., t] is contiguous
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int t = e % 9, o = (e / 9) % TN, d = e / (9 * TN);
    const int c = d0 + o;
    v[k] = c < a.C && d < a.D
               ? a.w[(static_cast<long long>(d) * a.C + c) * 9 + t]
               : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int t = e % 9, o = (e / 9) % TN, d = e / (9 * TN);
    const int tap = 8 - t;
    *reinterpret_cast<bf16*>(wsm + tap * TN * kGRowBytes + o * kGRowBytes +
                             (((d >> 3) ^ ((o >> 2) & 1)) << 4) + (d & 7) * 2) =
        __float2bfloat16(v[k]);
  }
  fence_proxy_async();
}

// Byte offset of channel pair (8 j + 2 q) of 128-byte row `row` in a box
// written with the 128-byte swizzle.
__device__ __forceinline__ int swz128(int row, int j, int q) {
  return row * kRowBytes + ((j ^ (row & 7)) << 4) + 4 * q;
}

template <int R, bool kRoute>
__global__ void __launch_bounds__(SBCfg<R, kRoute>::kThreads, 1) side_dgrad_tma_kernel(
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap zmap,
    const __grid_constant__ CUtensorMap pmap, const __grid_constant__ CUtensorMap dpmap,
    const SBArgs a, const HShape s) {
  using K = SBCfg<R, kRoute>;
  constexpr int TN = K::kTN;
  extern __shared__ uint8_t hsmem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(hsmem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* wsm = smem;                     // the resident weights
  uint8_t* ring = smem + K::kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::kStages * K::kStage);
  uint64_t* empty = full + K::kStages;
  if (threadIdx.x == 0) ring_init(full, empty, K::kStages, 4);
  __syncthreads();
  // The grid is a multiple of the channel tiles, so a block's tiles share
  // one channel tile.
  const int d0 = static_cast<int>(blockIdx.x % s.n_tiles) * TN;
  if (threadIdx.x >= 256) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      const HTile tl = tile_at(s, t, R, TN);
      uint8_t* st = ring + stage * K::kStage;
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], K::kTx);
      tma_load(st, &gmap, &full[stage], 0, tl.w0 - 1, tl.h0 - 1, tl.n);
      tma_load(st + K::kGSlot, &zmap, &full[stage], tl.d0, tl.w0, tl.h0, tl.n);
      if constexpr (kRoute) {
        uint8_t* ps = st + K::kGSlot + K::kZBytes;
        tma_load(ps, &pmap, &full[stage], tl.d0, tl.w0 / 2, tl.h0 / 2, tl.n);
        tma_load(ps + K::kPBytes, &dpmap, &full[stage], tl.d0, tl.w0 / 2,
                 tl.h0 / 2, tl.n);
      }
      if (++stage == K::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const bool left = ((lane / 4) & 1) == 0;  // the window's left column
  const uint32_t ws = smem_u32(wsm);
  pack_flipped_tile<TN, 256>(wsm, a, d0, threadIdx.x);
  named_sync(3, 256);
  for (long long l = wg; blockIdx.x + l * gridDim.x < s.tiles; l += 2) {
    const HTile tl = tile_at(s, blockIdx.x + l * gridDim.x, R, TN);
    const int stage = static_cast<int>(l % K::kStages);
    mbar_wait(&full[stage], static_cast<uint32_t>(l / K::kStages) & 1);
    uint8_t* st = ring + stage * K::kStage;
    const uint32_t gs = smem_u32(st);
    float acc[R][TN / 2];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) fence_acc(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      const uint64_t b = smem_desc(ws + tap * TN * kGRowBytes, 256, 3);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        // tap (kh, kw) of image row h0 + i: g box row i + kh from pixel kw
        const int row = (i + kh) * kBoxW + kw;
        wgmma_bf16<TN, 0, 0>(acc[i], smem_desc(gs + row * kGRowBytes, 256, 3), b);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < R; ++i) fence_acc(acc[i]);

    // Epilogue in the z box: dz = bf16(acc * (z > 0) [+ routed cotangent])
    // written over z, then copied out with 16-byte stores.
    uint8_t* zs = st + K::kGSlot;
    const uint8_t* ps = zs + K::kZBytes;
#pragma unroll
    for (int i = 0; i < R; i += 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * warp + lane / 4 + 8 * half;
        const int h = tl.h0 + i, w = tl.w0 + col;
        const bool in_t = h < s.H && w < s.W, in_b = h + 1 < s.H && w < s.W;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int ot = swz128(i * kSeg + col, j, q);
          const int ob = swz128((i + 1) * kSeg + col, j, q);
          const __nv_bfloat162 zt = *reinterpret_cast<const __nv_bfloat162*>(zs + ot);
          const __nv_bfloat162 zb = *reinterpret_cast<const __nv_bfloat162*>(zs + ob);
          float t0 = masked(acc[i][4 * j + 2 * half], zt.x);
          float t1 = masked(acc[i][4 * j + 2 * half + 1], zt.y);
          float b0 = masked(acc[i + 1][4 * j + 2 * half], zb.x);
          float b1 = masked(acc[i + 1][4 * j + 2 * half + 1], zb.y);
          if constexpr (kRoute) {
            // The window (rows i, i + 1; columns col & ~1, col | 1): its
            // cotangent goes to the first pixel in row-major order whose z
            // equals the pooled max; the other column is lane ^ 4.
            const int op = swz128((i / 2) * (kSeg / 2) + col / 2, j, q);
            const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(ps + op);
            const __nv_bfloat162 dp =
                *reinterpret_cast<const __nv_bfloat162*>(ps + K::kPBytes + op);
            const unsigned mine =
                (in_t && f32(zt.x) == f32(m.x) ? 1u : 0u) |
                (in_t && f32(zt.y) == f32(m.y) ? 2u : 0u) |
                (in_b && f32(zb.x) == f32(m.x) ? 4u : 0u) |
                (in_b && f32(zb.y) == f32(m.y) ? 8u : 0u);
            const unsigned other = __shfl_xor_sync(0xffffffffu, mine, 4);
            // the top row's pixels precede the bottom row's; in a row the
            // left column precedes the right
            const unsigned top_first = left ? 0u : other & 3u;
            const unsigned take_t = mine & 3u & ~top_first;
            const unsigned before_b = (mine | other) & 3u |
                                      (left ? 0u : (other >> 2) & 3u);
            const unsigned take_b = (mine >> 2) & 3u & ~before_b;
            t0 += (take_t & 1u) ? f32(dp.x) : 0.f;
            t1 += (take_t & 2u) ? f32(dp.y) : 0.f;
            b0 += (take_b & 1u) ? f32(dp.x) : 0.f;
            b1 += (take_b & 2u) ? f32(dp.y) : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(zs + ot) = __floats2bfloat162_rn(t0, t1);
          *reinterpret_cast<__nv_bfloat162*>(zs + ob) = __floats2bfloat162_rn(b0, b1);
        }
      }
    }
    fence_proxy_async();  // the next TMA load into this stage follows
    named_sync(1 + wg, 128);
    for (int u = tid; u < R * kSeg * 8; u += 128) {
      const int row = u >> 3, c8 = u & 7;
      const int h = tl.h0 + row / kSeg, w = tl.w0 + row % kSeg, c = tl.d0 + 8 * c8;
      if (h < s.H && w < s.W && c < a.C) {
        *reinterpret_cast<uint4*>(
            a.dz + ((static_cast<long long>(tl.n) * s.H + h) * s.W + w) * a.C + c) =
            *reinterpret_cast<const uint4*>(zs + row * kRowBytes + ((c8 ^ (row & 7)) << 4));
      }
    }
    release(&empty[stage], lane);
  }
}

template <int R, bool kPool>
int launch_side_fwd(const void* x, const void* w, bf16* y, bf16* pooled,
                    const HShape& s, int Cin, int Cin_p, int blocks,
                    cudaStream_t stream) {
  using K = SFCfg<R>;
  CUtensorMap amap, bmap;
  int err = encode_map(&amap, x, s.N, s.H, s.W, Cin, kChunk, kFwdBox,
                       CU_TENSOR_MAP_SWIZZLE_128B, R + 2);
  if (err == 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cin_p), kSideD, 9};
    const cuuint32_t box[3] = {kChunk, kSideD, 9};
    err = encode_bf16_map(&bmap, w, 3, dims, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  static SmemOnce smem_once;
  err = smem_once.set(side_fwd_tma_kernel<R, kPool>, K::kSmem);
  if (err != 0) return err;
  side_fwd_tma_kernel<R, kPool><<<blocks, K::kThreads, K::kSmem, stream>>>(
      amap, bmap, y, pooled, s, Cin);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRoute>
int launch_side_dgrad(const void* g, const float* w, const void* z,
                      const void* zp, const void* dzp, bf16* dz,
                      const HShape& s, int D, int C, int blocks,
                      cudaStream_t stream) {
  constexpr int R = kDzRows;
  using K = SBCfg<R, kRoute>;
  const int H2 = (s.H + 1) / 2, W2 = (s.W + 1) / 2;
  CUtensorMap gmap, zmap, pmap, dpmap;
  // g (N, H, W, D <= 16): the box's 16 channels read zeros past D
  int err = encode_map(&gmap, g, s.N, s.H, s.W, D, kSideD, kBoxW,
                       CU_TENSOR_MAP_SWIZZLE_32B, R + 2);
  if (err == 0)
    err = encode_map(&zmap, z, s.N, s.H, s.W, C, K::kTN, kSeg,
                     CU_TENSOR_MAP_SWIZZLE_128B, R);
  if (err == 0 && kRoute)
    err = encode_map(&pmap, zp, s.N, H2, W2, C, K::kTN, kSeg / 2,
                     CU_TENSOR_MAP_SWIZZLE_128B, R / 2);
  if (err == 0 && kRoute)
    err = encode_map(&dpmap, dzp, s.N, H2, W2, C, K::kTN, kSeg / 2,
                     CU_TENSOR_MAP_SWIZZLE_128B, R / 2);
  if (err != 0) return err;
  if (!kRoute) pmap = dpmap = zmap;  // unread
  static SmemOnce smem_once;
  err = smem_once.set(side_dgrad_tma_kernel<R, kRoute>, K::kSmem);
  if (err != 0) return err;
  SBArgs a;
  a.w = w;
  a.dz = dz;
  a.D = D;
  a.C = C;
  side_dgrad_tma_kernel<R, kRoute><<<blocks, K::kThreads, K::kSmem, stream>>>(
      gmap, zmap, pmap, dpmap, a, s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The weight operand
// ---------------------------------------------------------------------------

// The bf16 product operand of an OIHW (A, B, 3, 3) float32 weight w, zero-
// padded: layout 0 (9, rows_p, cols_p) [tap][o][i] = w[o, i, kh, kw];
// layout 1, the flipped transpose an input gradient multiplies by,
// [tap][c][d] = w[d, c, 2 - kh, 2 - kw]; layout 2, the stem's im2col
// operand (rows_p, cols_p) [o][tap * B + c] = w[o, c, kh, kw]
// (tap = 3 kh + kw). A thread takes one (row, column) of a tap plane and
// its nine taps, 36 contiguous bytes of w; neighbouring threads take
// neighbouring columns, so the stores of each plane are coalesced. S
// weights (S, A, B, 3, 3) give S operands one after another, each the lone
// operand of its weight: grid row blockIdx.y packs weight blockIdx.y.
__global__ void __launch_bounds__(256) pack_weight_kernel(
    const float* __restrict__ w, bf16* __restrict__ out, int A, int B,
    int rows_p, int cols_p, int layout) {
  const int plane = rows_p * cols_p;
  w += static_cast<long long>(blockIdx.y) * A * B * 9;
  out += static_cast<long long>(blockIdx.y) * (layout == 2 ? 1 : 9) * plane;
  for (int e = blockIdx.x * 256 + threadIdx.x; e < plane; e += gridDim.x * 256) {
    const int row = e / cols_p, col = e % cols_p;
    if (layout == 2) {
      out[e] = __float2bfloat16(
          row < A && col < 9 * B ? w[(row * B + col % B) * 9 + col / B] : 0.f);
      continue;
    }
    const bool inside = layout == 0 ? row < A && col < B : row < B && col < A;
    const float* src = w + (layout == 0 ? row * B + col : col * B + row) * 9;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      float v = 0.f;
      if (inside) v = layout == 0 ? src[tap] : src[8 - tap];
      out[tap * plane + e] = __float2bfloat16(v);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The Hopper path, bound with ctypes: mode 0 (conv + bias + ReLU), 1 (the
// same and the pool of y), 5 (dz = conv_T(g) * (z > 0)) or 6 (the fast
// trunk's relu(bf16(bf16(conv) + b)), b bf16). x (N, H, W, S * Cin) is the
// product's input (the cotangent for mode 5), w the S packs of (9, Cout_p,
// Cin_p) bf16 [tap][out][in] weights zero-padded to Cout_p, a multiple of
// `tile_n` (64 or 128), and Cin_p, Cin rounded up to 64; Cin and Cout
// multiples of 8; y (N, H, W, S * Cout), the bias (S * Cout). `rows` image
// rows a tile (4 with tile_n 64, 2 with 128), `blocks` a sequence's grid,
// at most 132 and at most the tiles, N * ceil(H / rows) * ceil(W / 64) *
// Cout_p / tile_n. S sequences (S > 1 in mode 6 only), each on its lone
// grid, one after another. Every pointer 16-byte aligned. Returns
// cudaGetLastError() after the launch on `stream`, an error code of the
// tensor-map encoder, or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int osvos_flat_conv3x3_tma(int mode, const void* x, const void* w,
                                      const void* bias, void* y, void* pooled,
                                      const void* z, int N, int H, int W,
                                      int Cin, int Cout, int Cin_p, int Cout_p,
                                      int tile_n, int rows, int blocks, int S,
                                      void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 8 || Cout < 8 || Cin % 8 != 0 ||
      Cout % 8 != 0 || x == nullptr || w == nullptr || y == nullptr ||
      (tile_n != 64 && tile_n != 128) || Cout_p % tile_n != 0 ||
      Cout_p < Cout || Cin_p != (Cin + kChunk - 1) / kChunk * kChunk ||
      rows != (tile_n == 64 ? 4 : 2) ||
      (mode != 0 && mode != 1 && mode != 5 && mode != 6) ||
      S < 1 || S > 0x7fffffff / kNumSMs || (S > 1 && mode != 6) ||
      ((mode == 0 || mode == 1 || mode == 6) && bias == nullptr) ||
      (mode == 1 && pooled == nullptr) || (mode == 5 && z == nullptr) ||
      !aligned16(x) || !aligned16(w) || !aligned16(bias) || !aligned16(y) ||
      !aligned16(pooled) || !aligned16(z)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HShape s;
  s.N = N;
  s.H = H;
  s.W = W;
  s.Cout = Cout;
  s.seg_w = kSeg;
  s.segs = (W + kSeg - 1) / kSeg;
  s.groups = (H + rows - 1) / rows;
  s.n_tiles = Cout_p / tile_n;
  s.chunks = Cin_p / kChunk;
  s.tiles = static_cast<long long>(N) * s.groups * s.segs * s.n_tiles;
  s.S = S;
  s.blocks = blocks;
  if (blocks < 1 || blocks > kNumSMs || blocks > s.tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  HArgs a;
  a.bias = mode == 6 ? nullptr : static_cast<const float*>(bias);
  a.bias16 = mode == 6 ? static_cast<const bf16*>(bias) : nullptr;
  a.y = static_cast<bf16*>(y);
  a.pooled = static_cast<bf16*>(pooled);
  a.z = static_cast<const bf16*>(z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tile_n == 64
             ? dispatch_epi<64, 4>(mode, x, w, a, s, Cin, Cin_p, Cout_p, st)
             : dispatch_epi<128, 2>(mode, x, w, a, s, Cin, Cin_p, Cout_p, st);
}


// The side convs' Hopper path, bound with ctypes: mode 3 (B5: side =
// conv(x, K), no bias or ReLU), 4 (the same and the pool of x), 7 (B6's
// dz = conv_T(g, K) * (z > 0)) or 8 (the same plus the cotangent dzp of the
// pool zp of z, routed), on tiles of `rows` image rows. Modes 3 and 4
// (rows 2 or 4): x (N, H, W, Cin) with Cin a
// multiple of 8, w the (9, 16, Cin_p) bf16 [tap][out][in] operand, Cin_p
// Cin rounded up to 64, y (N, H, W, Cout) with Cout 8 or 16 (Cout_p 16),
// pooled (N, ceil(H/2), ceil(W/2), Cin). Modes 7 and 8: x is g (N, H, W,
// Cin) with Cin 8 or 16, w the layer's float32 OIHW (Cin, Cout, 3, 3)
// weight (each block packs its channel tile of the flipped operand), Cin_p
// 16 and Cout_p Cout rounded up to 64, y is dz and z (N, H, W, Cout), zp
// and dzp (N, ceil(H/2), ceil(W/2), Cout), Cout a multiple of 8 (rows 2).
// Tiles of 62 pixels (modes 3, 4) or 64 (7, 8) a row, in the order of
// ops/kernels/flatconv.py Plan.tile; `blocks` at most 132 and at most the
// tiles, and for modes 7 and 8 a multiple of Cout_p / 64. Every pointer
// 16-byte aligned.
// Returns cudaGetLastError() after the launch on `stream`, an error code
// of the tensor-map encoder, or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int osvos_flat_side_tma(int mode, const void* x, const void* w,
                                   void* y, void* pooled, const void* z,
                                   const void* zp, const void* dzp, int N,
                                   int H, int W, int Cin, int Cout, int Cin_p,
                                   int Cout_p, int rows, int blocks,
                                   void* stream) {
  const bool fwd = mode == 3 || mode == 4;
  if (N < 1 || H < 1 || W < 1 || Cin < 8 || Cout < 8 || Cin % 8 != 0 ||
      (fwd ? rows != 2 && rows != 4 : rows != kDzRows) ||
      Cout % 8 != 0 || (mode != 3 && mode != 4 && mode != 7 && mode != 8) ||
      x == nullptr || w == nullptr || y == nullptr ||
      (mode == 4 && pooled == nullptr) || (!fwd && z == nullptr) ||
      (mode == 8 && (zp == nullptr || dzp == nullptr)) ||
      (fwd ? (Cout > kSideD || Cout_p != kSideD ||
              Cin_p != (Cin + kChunk - 1) / kChunk * kChunk)
           : (Cin > kSideD || Cin_p != kSideD ||
              Cout_p != (Cout + 63) / 64 * 64)) ||
      !aligned16(x) || !aligned16(w) || !aligned16(y) || !aligned16(pooled) ||
      !aligned16(z) || !aligned16(zp) || !aligned16(dzp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HShape s;
  s.N = N;
  s.H = H;
  s.W = W;
  s.Cout = Cout;
  s.seg_w = fwd ? kFwdSeg : kSeg;
  s.segs = (W + s.seg_w - 1) / s.seg_w;
  s.groups = (H + rows - 1) / rows;
  s.n_tiles = fwd ? 1 : Cout_p / 64;
  s.chunks = fwd ? Cin_p / kChunk : 1;
  s.tiles = static_cast<long long>(N) * s.groups * s.segs * s.n_tiles;
  if (blocks < 1 || blocks > kNumSMs || blocks > s.tiles || blocks % s.n_tiles != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* out = static_cast<bf16*>(y);
  switch (mode) {
    case 3:
      return rows == 4 ? launch_side_fwd<4, false>(x, w, out, nullptr, s, Cin,
                                                   Cin_p, blocks, st)
                       : launch_side_fwd<2, false>(x, w, out, nullptr, s, Cin,
                                                   Cin_p, blocks, st);
    case 4:
      return rows == 4
                 ? launch_side_fwd<4, true>(x, w, out, static_cast<bf16*>(pooled),
                                            s, Cin, Cin_p, blocks, st)
                 : launch_side_fwd<2, true>(x, w, out, static_cast<bf16*>(pooled),
                                            s, Cin, Cin_p, blocks, st);
    case 7:
      return launch_side_dgrad<false>(x, static_cast<const float*>(w), z,
                                      nullptr, nullptr, out, s, Cin, Cout,
                                      blocks, st);
    default:
      return launch_side_dgrad<true>(x, static_cast<const float*>(w), z, zp,
                                     dzp, out, s, Cin, Cout, blocks, st);
  }
}

// The weight operand, bound with ctypes: w the contiguous OIHW (A, B, 3, 3)
// float32 weight, out (9, rows_p, cols_p) bf16 for layout 0 ([tap][o][i],
// rows_p >= A, cols_p >= B) or 1 (the flipped transpose [tap][c][d],
// rows_p >= B, cols_p >= A), (rows_p, cols_p) for layout 2 (the stem's
// [o][tap * B + c], rows_p >= A, cols_p >= 9 B); for S weights (S, A, B, 3,
// 3) the S operands one after another. Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int osvos_flat_pack_weight(const void* w, void* out, int A, int B,
                                      int rows_p, int cols_p, int layout, int S,
                                      void* stream) {
  if (w == nullptr || out == nullptr || A < 1 || B < 1 || S < 1 || S > 65535 ||
      (layout == 0 && (rows_p < A || cols_p < B)) ||
      (layout == 1 && (rows_p < B || cols_p < A)) ||
      (layout == 2 && (rows_p < A || cols_p < 9 * B)) || layout < 0 || layout > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(rows_p) * cols_p * 9 > 0x7fffffffLL ||
      static_cast<long long>(A) * B * 9 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int want = (rows_p * cols_p + 255) / 256;
  pack_weight_kernel<<<dim3(want < 1024 ? want : 1024, S), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<bf16*>(out), A, B, rows_p,
      cols_p, layout);
  return static_cast<int>(cudaGetLastError());
}

// The mma path, bound with ctypes. `mode` picks the variant; the wrapper
// (osvos_torch/ops/kernels/flatconv.py) lays the weights out as (9, Cout_p,
// Cin_p) bf16 with the mode's channel tiles (TN, TC):
//   0 B2 conv + bias + ReLU               (TN 64, TC 32)
//   1 B2 the same, and the pool of y      (TN 64, TC 32)
//   2 B2 the stem, im2col of C <= 3       (TN 64, (Cout_p, 32) weights)
//   3 B5 side conv, no bias or ReLU       (TN 16, TC 32)
//   4 B5 the same, and the pool of x      (TN 16, TC 32)
//   5 B3 dz = conv_T(g) * (z > 0)         (TN 64, TC 32)
//   7 B6 dz = conv_T(g_side) * (z > 0)    (TN 64, TC 16)
//   8 B6 the same plus the routed pool cotangent of z (TN 64, TC 16)
// Every pointer that a mode reads or writes is 16-byte aligned. Returns
// cudaGetLastError() after the launch on `stream`, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int osvos_flat_conv3x3(int mode, const void* x, const void* w,
                                  const void* bias, void* y, void* pooled,
                                  const void* z, const void* zp, const void* dzp,
                                  int N, int H, int W, int Cin, int Cout,
                                  int Cin_p, int Cout_p, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || x == nullptr ||
      w == nullptr || y == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* p : {x, w, static_cast<const void*>(bias),
                        static_cast<const void*>(y),
                        static_cast<const void*>(pooled), z, zp, dzp}) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool need_bias = mode <= 2, need_pool = mode == 1 || mode == 4;
  const bool need_z = mode >= 5, need_route = mode == 8;
  if ((need_bias && bias == nullptr) || (need_pool && pooled == nullptr) ||
      (need_z && z == nullptr) ||
      (need_route && (zp == nullptr || dzp == nullptr))) {
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
    case 7: return launch<64, 16, kMask, kNone>(a, s);
    case 8: return launch<64, 16, kMask, kPoolAdd>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
