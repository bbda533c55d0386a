// The int8 3x3 SAME convolution of int8 inference, for Hopper (sm_90a).
//
// Kernel I1. It replaces no Pallas kernel: it is the product and the
// epilogue of the JAX package's `_Int8Conv` (osvos_tpu/models/vgg_osvos.py),
// which XLA computes as `lax.conv_general_dilated` on int8 operands with
// `preferred_element_type=int32`. Eager PyTorch has no int8 convolution on
// CUDA; its one library route, im2col + `torch._int_mm`, writes a buffer nine
// times the activation (the plain version, ops/kernels/int8conv.py).
//
// Function. For x (N, H, W, Cin) int8 NHWC, the weight K[d, kh, kw, c]
// int8, and per output channel the float32 scale s[d] (x_scale * w_scale[d])
// and bias b[d]:
//
//   acc[n, h, w, d] = sum_{kh, kw, c} x[n, h + kh - 1, w + kw - 1, c] * K[d, kh, kw, c]
//   y[n, h, w, d]   = bf16( relu( float(acc) * s[d] + b[d] ) )
//
// with x outside the image taken as zero (q(0) = 0, so this is the JAX
// function's zero padding of x_q), products summed exactly in int32
// (|acc| <= 9 * 512 * 127^2 < 2^31), the multiply and the add each rounded
// to float32 (no FMA: PyTorch and XLA round both), one bf16 rounding, and
// the ReLU optional. Any N, H, W, Cin and Cout >= 1.
//
// Bound. 2 * 9 * Cin * Cout operations a pixel on the int8 tensor cores
// against x read once, y (bf16) written once and the weights. On the
// Hopper path x is read as bf16: at stage 1 of a 480x854 frame (Cin = Cout
// = 64) 30 GOP against 105 MB a frame, so bytes bound it (0.031 ms a frame
// at 3.35 TB/s, 0.015 at 1,979 TOP/s), and so they do stage 2's first
// conv; from stage 2's second conv on the operations do.
//
// Two kernels; the shape alone picks one (ops/kernels/int8conv.py
// `hopper_takes`), a failure never does.
//
// The Hopper path (`osvos_int8_conv3x3_q`: Cin a multiple of 32 and Cout of
// 64, every trunk conv after the stem at full width) takes the bf16 x and
// the device scalar x_scale and quantizes x in its operand load:
// q = clip(rint(float(x) / x_scale), -127, 127) is formed in shared memory,
// so x is read from memory once, as bf16, and no int8 copy of it is
// written. An implicit GEMM, M = output pixels, N = output channels, K = 9
// taps x Cin, on wgmma m64nNk32 s8 x s8 -> s32 with both operands K-major.
// - A tile is 4 image rows of one 64-pixel segment and TN = 128 output
//   channels (64 where Cout is not a multiple of 128); a persistent grid of
//   at most one block per SM takes tiles b, b + grid, ... (output-channel
//   tile fastest, so the blocks in flight share input boxes in L2).
// - K goes in chunks of 64 input channels. For each chunk a producer
//   thread loads by TMA the bf16 box of the tile's rows and their one-pixel
//   halo (64 channels x 66 pixels x 6 rows, 128-byte swizzle) into a ring
//   of two; TMA's zero fill outside the image and past Cin is the SAME
//   padding (q(0) = 0). A quantizer warpgroup turns each box once into an
//   int8 tile of 396 pixel rows of 64 bytes in wgmma's 64-byte swizzle (a
//   ring of two), with no division, no rintf and no conversion (q_fast:
//   exact, see there), fences it for the async proxy and hands it over by
//   mbarrier.
// - Another producer thread loads the weights by TMA from the (9, Cout,
//   Cin) [tap][out][in] int8 operand, K-major for each tap, a kernel row's
//   three taps (3 x TN rows of 64 bytes) a stage, in a ring of 3 or 4.
// - Two consumer warpgroups split the tile's rows, two m64 x TN int32
//   accumulators each (128 registers at TN = 128; setmaxnreg moves the
//   producers' and quantizers' registers to them). A stage is multiplied
//   as nine taps x two k32 steps: the taps are descriptors started kw pixel
//   rows and kh box rows into the int8 tile (the 64-byte swizzle is taken
//   on the absolute address bits, as the 128-byte one of flatconv.cu's
//   boxes).
// - Epilogue from the registers: s = x_scale * w_scale[d], then
//   float(acc) * s + b[d], each rounded apart, the ReLU, bf16; the four
//   lanes of a pixel trade pairs so each stores 16 bytes. With `max_out`,
//   one atomicMax a block on the float bits of the block's largest output
//   (all >= 0 after the ReLU; -0.0 counted as +0.0), which the next conv's
//   dynamic scale reads: the max is order-free, so two launches agree.
// - No split-K: every K step of a tile is summed in one warpgroup's
//   registers in one order, so two launches give the same bits.
// What bounds it (PERF.md): the quantizer warpgroup at the deep stages
// (each input element is quantized once per tile that reads it: 1.55x for
// the halo and once per output-channel tile), the epilogue, during which
// the tensor cores idle, and L2 traffic of the weight stream (a tile's 256
// pixels use each weight byte 256 times).
//
// The mma.sync path (`osvos_int8_conv3x3`: any shape, int8 x quantized
// before it in PyTorch), the first design: an implicit GEMM with M =
// output pixels, N = output channels and K = the nine taps x the input
// channels, on mma.sync m16n8k32 s8 x s8 -> s32.
// - K is cut in pieces of 32 bytes: piece p is tap p / cpt and channels
//   32 (p % cpt) .. + 32 of it, cpt = ceil(Cin / 32), P = 9 cpt pieces.
//   The wrapper packs the weight as (Cout_p, Kw) int8 rows, [tap][Cin]
//   from byte 0, zero past 9 Cin and in the rows past Cout (Cout_p is Cout
//   rounded up to the 64 of a tile, Kw is 9 Cin + 32 rounded up to 16). A
//   piece of a row is the 32 bytes from tap * Cin + 32 chunk: past Cin they
//   hold the next tap's weights, so the x side of a piece is zero past Cin
//   (the K tail), and a piece past the last reads the row's zero pad.
// - A block takes 128 consecutive output pixels (flat over N, H, W, so a
//   tile may cross rows and images) and 64 output channels; four warps,
//   2 x 2, each 64 pixels x 32 channels: 4 x 4 accumulators of m16n8.
// - A stage is two pieces (64 bytes of K). Thread t gathers pixel t's 64
//   bytes of the two pieces (the tap's pixel, zero off the image, past Cin
//   and past the last piece) and 32 bytes of a weight row into registers,
//   in units of 16, 4 or 1 bytes as Cin's alignment allows; the next
//   stage's loads are in flight while the warps multiply the current one
//   out of shared memory (two buffers, one barrier a stage).
// - Shared rows are 64 bytes, their 16-byte chunks XOR-swizzled by (row /
//   2) % 4, so ldmatrix reads eight rows without bank conflicts. The s8
//   fragments of m16n8k32 have the byte layout of bf16 m16n8k16's (A: rows
//   g and g + 8, bytes 4 tig .. and 16 + 4 tig ..; B: column g, the same
//   bytes), so ldmatrix.x4 of 8 x 16-byte rows loads them.
// - The epilogue rounds through shared memory and stores 16 bytes a thread
//   where Cout is a multiple of 8, else element by element.
// - Grid: the channel tile fastest, so the blocks of one pixel tile run
//   together and share its input in L2. No split-K and no atomics: two
//   launches give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;               // output pixels a block
constexpr int kBN = 64;                // output channels a block
constexpr int kPiece = 32;             // bytes of K a piece
constexpr int kStageK = 2 * kPiece;    // bytes of K a stage
constexpr int kThreads = 128;
constexpr int kOutLd = 2 * kBN + 16;   // bytes of a staged output row
constexpr int kSmem = 2 * (kBM + kBN) * kStageK;
static_assert(kBM * kOutLd <= kSmem, "the output tile fits the stages");

struct Args {
  const int8_t* x;      // (N, H, W, Cin)
  const int8_t* w;      // (n_tiles * 64, Kw)
  const float* scale;   // (Cout,)
  const float* bias;    // (Cout,)
  __nv_bfloat16* y;     // (N, H, W, Cout)
  long long M;          // N * H * W
  int H, W, Cin, Cout;
  int cpt;              // 32-channel chunks a tap
  int P;                // pieces of K: 9 * cpt
  int Kw;               // bytes of a packed weight row
  int stages;           // ceil(P / 2)
  int n_tiles;          // ceil(Cout / 64)
  int relu;
  int vec_out;          // 16-byte output stores
};

// Byte offset of 16-byte chunk c of shared row r.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kStageK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 32 bytes from src into r, in units of VEC bytes (src and `limit`
// multiples of VEC): zero unless `inside`, and units at or past `limit`
// bytes zero (for x: src is channel cin0 of the tap's pixel and limit is
// Cin - cin0, the K tail).
template <int VEC>
__device__ __forceinline__ void load_piece(uint32_t* r, const int8_t* src,
                                           int limit, bool inside) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = 0u;
  if (!inside) return;
  if constexpr (VEC == 16) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (16 * u < limit) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 16 * u));
        r[4 * u] = v.x;
        r[4 * u + 1] = v.y;
        r[4 * u + 2] = v.z;
        r[4 * u + 3] = v.w;
      }
    }
  } else if constexpr (VEC == 4) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (4 * u < limit)
        r[u] = __ldg(reinterpret_cast<const uint32_t*>(src + 4 * u));
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t v = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * u + e < limit)
          v |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * u + e])) << (8 * e);
      r[u] = v;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
int8_conv3x3_kernel(const Args a) {
  __shared__ __align__(128) uint8_t smem[kSmem];
  uint8_t* const sa = smem;                          // 2 x kBM rows
  uint8_t* const sb = smem + 2 * kBM * kStageK;      // 2 x kBN rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const long long tile_m = static_cast<long long>(blockIdx.x) / a.n_tiles;
  const int n0 = static_cast<int>(blockIdx.x % a.n_tiles) * kBN;
  const long long m0 = tile_m * kBM;

  // the output pixel whose A row this thread gathers
  const long long m = m0 + tid;
  const bool m_ok = m < a.M;
  int h = 0, w = 0;
  if (m_ok) {
    const long long hw = m % (static_cast<long long>(a.H) * a.W);
    h = static_cast<int>(hw / a.W);
    w = static_cast<int>(hw % a.W);
  }
  // the weight row and the piece of the stage this thread loads
  const int b_row = tid >> 1, b_half = tid & 1;
  const int8_t* const b_src = a.w + static_cast<long long>(n0 + b_row) * a.Kw;

  uint32_t ra[16], rb[8];
  auto load = [&](int s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 2 * s + half;
      const int tap = p / a.cpt, chunk = p - tap * a.cpt;
      const int kh = tap / 3, kw = tap - 3 * kh;
      const int hh = h + kh - 1, ww = w + kw - 1;
      const bool inside = p < a.P && m_ok && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
      const int8_t* src = inside
          ? a.x + (m + static_cast<long long>(kh - 1) * a.W + (kw - 1)) * a.Cin + chunk * kPiece
          : a.x;
      load_piece<VEC>(ra + 8 * half, src, a.Cin - chunk * kPiece, inside);
    }
    const int p = 2 * s + b_half, tap = p / a.cpt;
    load_piece<VEC>(rb, b_src + tap * a.Cin + (p - tap * a.cpt) * kPiece, kPiece, true);
  };
  auto store = [&](int buf) {
    uint8_t* const as = sa + buf * kBM * kStageK;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint4*>(as + swz(tid, c)) =
          make_uint4(ra[4 * c], ra[4 * c + 1], ra[4 * c + 2], ra[4 * c + 3]);
    uint8_t* const bs = sb + buf * kBN * kStageK;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<uint4*>(bs + swz(b_row, 2 * b_half + c)) =
          make_uint4(rb[4 * c], rb[4 * c + 1], rb[4 * c + 2], rb[4 * c + 3]);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < a.stages; ++s) {
    const bool more = s + 1 < a.stages;
    if (more) load(s + 1);
    const uint8_t* const as = sa + (s & 1) * kBM * kStageK;
    const uint8_t* const bs = sb + (s & 1) * kBN * kStageK;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = warp_m * 64 + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], as + swz(row, 2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int row = warp_n * 32 + jj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t r4[4];
        ldmatrix_x4(r4, bs + swz(row, 2 * ks + ((lane >> 3) & 1)));
        bf[2 * jj][0] = r4[0];
        bf[2 * jj][1] = r4[1];
        bf[2 * jj + 1][0] = r4[2];
        bf[2 * jj + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    if (more) store((s + 1) & 1);
    __syncthreads();
  }

  // epilogue: float(acc) * s + b, each rounded, ReLU, one bf16 rounding,
  // into the staged output tile (the stages' memory: every warp is past
  // the last barrier of the loop)
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = warp_n * 32 + j * 8 + 2 * tig;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + col + e;
      sc[e] = c < a.Cout ? a.scale[c] : 0.f;
      bi[e] = c < a.Cout ? a.bias[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), sc[e]), bi[e]);
          if (a.relu && v[e] < 0.f) v[e] = 0.f;
        }
        const int row = warp_m * 64 + i * 16 + g + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(smem + row * kOutLd + 2 * col) =
            __nv_bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBM * kBN / 8 / kThreads; ++k) {
    const int idx = tid + k * kThreads;
    const int row = idx >> 3, c0 = n0 + (idx & 7) * 8;
    const long long mo = m0 + row;
    if (mo >= a.M || c0 >= a.Cout) continue;
    const uint8_t* const src = smem + row * kOutLd + (idx & 7) * 16;
    __nv_bfloat16* const dst = a.y + mo * a.Cout + c0;
    if (a.vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* const sv = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int e = 0; e < 8 && c0 + e < a.Cout; ++e) dst[e] = sv[e];
    }
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// ---------------------------------------------------------------------------
// The Hopper path: bf16 x quantized in the operand load, s8 wgmma fed by TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kQRows = 4;                        // output image rows a tile
constexpr int kQSeg = 64;                        // output pixels a tile row
constexpr int kQBoxW = kQSeg + 2;                // a row and its halo pixels
constexpr int kQBoxPix = (kQRows + 2) * kQBoxW;  // pixel rows of a box: 396
constexpr int kQChunk = 64;                      // input channels a chunk
constexpr int kQXBytes = kQBoxPix * kQChunk * 2; // the bf16 box
constexpr int kQXSlot = (kQXBytes + 1023) / 1024 * 1024;
constexpr int kQASlot = (kQBoxPix * kQChunk + 1023) / 1024 * 1024;  // int8
constexpr int kQConsumers = 256;                 // two consumer warpgroups
constexpr int kQQuantizers = 128;                // a quantizer warpgroup
// + the producer warpgroup: a lane of one warp loads the boxes, of another the weights
constexpr int kQThreads = kQConsumers + kQQuantizers + 128;
constexpr int kQRowsWG = kQRows / 2;             // output rows a warpgroup
constexpr int kQUnits = kQBoxPix * kQChunk / 16; // 16-channel units a box
constexpr int kQSmemLimit = 227 * 1024;

template <int TN>
struct QCfg {
  static constexpr int kWBytes = 3 * TN * kQChunk;  // a kh's three taps
  static constexpr int kAOff = 2 * kQXSlot;
  static constexpr int kWOff = kAOff + 2 * kQASlot;
  static constexpr int kFit = (kQSmemLimit - 1024 - 256 - kWOff) / kWBytes;
  static constexpr int kWStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOff = kWOff + kWStages * kWBytes;
  // the rings, their barriers and the block's max reduce
  static constexpr int kSmem = 1024 + kBarOff + 256;
  static_assert(kWStages >= 3 && (8 + 2 * kWStages) * 8 + 32 <= 256, "the rings");
};

struct QShape {
  int N, H, W, Cout;
  int segs;         // 64-pixel segments of an image row
  int groups;       // groups of 4 image rows
  int n_tiles;      // output-channel tiles
  int chunks;       // 64-channel chunks of the input
  int tiles;        // N * groups * segs * n_tiles
};

struct QArgs {
  const float* x_scale;  // 0-d
  const float* w_scale;  // (Cout,)
  const float* bias;     // (Cout,)
  bf16* y;               // (N, H, W, Cout)
  unsigned* max_out;     // float bits of the max of y, or null
  int relu;
};

struct QTile {
  int n, h0, w0, d0;
};

// Tile t: output-channel tile fastest, then the row segment, the row group
// and the image (ops/kernels/int8conv.py hopper_tile).
__device__ __forceinline__ QTile q_tile(const QShape& s, int t, int tn) {
  QTile r;
  r.d0 = t % s.n_tiles * tn;
  int m = t / s.n_tiles;
  r.w0 = m % s.segs * kQSeg;
  m /= s.segs;
  r.h0 = m % s.groups * kQRows;
  r.n = m / s.groups;
  return r;
}

// Chunks of the block's tiles blockIdx.x, blockIdx.x + gridDim.x, ...
__device__ __forceinline__ int q_chunks(const QShape& s) {
  const int b = static_cast<int>(blockIdx.x), G = static_cast<int>(gridDim.x);
  return (s.tiles > b ? (s.tiles - 1 - b) / G + 1 : 0) * s.chunks;
}

// Chunk g of the block: the first chunk of tile blockIdx.x + l gridDim.x is
// l * chunks. Its bf16 box takes X slot g % 2, its int8 tile A slot g % 2,
// and its kernel row kh W step 3 g + kh, stage (3 g + kh) % kWStages. Two
// producer threads, in two warps: the boxes run ahead as far as the
// quantizers free X slots, the weights as far as the consumers free W
// stages.
__device__ __forceinline__ QTile q_tile_of_chunk(const QShape& s, int g, int tn) {
  return q_tile(s, static_cast<int>(blockIdx.x + g / s.chunks * gridDim.x), tn);
}

template <int TN>
__device__ void q_produce_x(const CUtensorMap* xmap, uint8_t* smem,
                            uint64_t* xfull, uint64_t* xempty, const QShape& s) {
  const int total = q_chunks(s);
  for (int g = 0; g < total; ++g) {
    // the box of image rows h0 - 1 .. h0 + 4, pixels w0 - 1 .. w0 + 64 (zero
    // outside the image and past Cin: the SAME padding, since q(0) = 0)
    const QTile tl = q_tile_of_chunk(s, g, TN);
    const int slot = g & 1;
    mbar_wait(&xempty[slot], static_cast<uint32_t>((g >> 1) & 1) ^ 1);
    mbar_expect_tx(&xfull[slot], kQXBytes);
    tma_load(smem + slot * kQXSlot, xmap, &xfull[slot], g % s.chunks * kQChunk,
             tl.w0 - 1, tl.h0 - 1, tl.n);
  }
}

template <int TN>
__device__ void q_produce_w(const CUtensorMap* wmap, uint8_t* smem,
                            uint64_t* wfull, uint64_t* wempty, const QShape& s) {
  using K = QCfg<TN>;
  const int total = q_chunks(s);
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < total; ++g) {
    const QTile tl = q_tile_of_chunk(s, g, TN);
    const int c0 = g % s.chunks * kQChunk;
    for (int kh = 0; kh < 3; ++kh) {
      mbar_wait(&wempty[stage], phase ^ 1);
      mbar_expect_tx(&wfull[stage], K::kWBytes);
      // the weights of taps (kh, 0..2): TN output rows of 64 input channels
      tma_load(smem + K::kWOff + stage * K::kWBytes, wmap, &wfull[stage], c0,
               tl.d0, 3 * kh);
      if (++stage == K::kWStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

struct QScale {
  float s, r;   // x_scale and its correctly rounded reciprocal
  bool divide;  // always divide: s is not within [2^-60, 2^60]
};

// Round half to even by the add of 1.5 * 2^23, whose float has unit steps:
// for a whole-number result within +-127 the low byte of the sum's bits is
// its two's complement. Clamping to +-127 first gives what rint, then the
// clamp, gives: the bounds are whole numbers.
constexpr float kQRound = 12582912.f;

__device__ __forceinline__ float q_bf16(const uint32_t (&w)[8], int e) {
  return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
}

// 16 bf16 (eight words, the lower half first) / x_scale as 16 int8 bytes:
// rint (half to even) of the IEEE quotient Q = RN(x / s), clamped to +-127,
// with no division and no branch. With r = RN(1 / s), t = x r is within
// 1.5 ulp of x / s; one correction q1 = t + r (x - s t) is within 1 ulp, and
// a second, Q = q1 + r (x - s q1), is RN(x / s) exactly (Markstein: r
// within half an ulp of 1 / s, q1 within an ulp of x / s, and x - s q1
// then exact), each step a fused multiply-add rounded once. Where |t| >=
// 128, x / s is past 127.5 and t clamps as Q would (and an infinite t
// gives no NaN). For s within [2^-60, 2^60] no step overflows, and an x
// small enough to underflow one gives |Q| < 0.5 either way; other scales
// take q_exact. rintf and conversions run at a quarter of the adds' rate,
// so there are none.
__device__ __forceinline__ uint4 q_fast(const uint4& lo, const uint4& hi,
                                        const QScale& k) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t sum[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float x = q_bf16(w, e);
    const float t = __fmul_rn(x, k.r);
    const float q1 = __fmaf_rn(__fmaf_rn(-k.s, t, x), k.r, t);
    const float q = __fmaf_rn(__fmaf_rn(-k.s, q1, x), k.r, q1);
    float v = fabsf(t) < 128.f ? q : t;
    v = fmaxf(v, -127.f);
    v = fminf(v, 127.f);
    sum[e] = __float_as_uint(__fadd_rn(v, kQRound));
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // the low bytes of four sums
    o[i] = __byte_perm(__byte_perm(sum[4 * i], sum[4 * i + 1], 0x0040),
                       __byte_perm(sum[4 * i + 2], sum[4 * i + 3], 0x0040), 0x5410);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The same bytes by IEEE division, for a scale out of q_fast's range (a
// zero gives 0 without dividing: the division's range check sends a zero
// dividend down its slow path).
__device__ __noinline__ uint4 q_exact(const uint4& lo, const uint4& hi,
                                      const QScale& k) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float f = q_bf16(w, e);
    float v = f == 0.f ? 0.f : __fdiv_rn(f, k.s);
    v = fminf(fmaxf(v, -127.f), 127.f);
    o[e >> 2] |= (__float_as_uint(__fadd_rn(v, kQRound)) & 0xffu) << (8 * (e & 3));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The bf16 box `x` into the int8 tile `t`, by quantizer thread `qtid`.
// Unit u is the 16 channels 16 (u % 4) .. of pixel row p = u / 4 of the box
// (p = r * 66 + q: box row r, pixel q). The box has TMA's 128-byte
// swizzle: 16-byte chunk j of row p at chunk j ^ (p % 8). The tile is
// K-major with wgmma's 64-byte swizzle: 64-byte rows, chunk c of row p at
// chunk c ^ (p / 2 % 4).
__device__ __forceinline__ void q_units(const uint8_t* x, uint8_t* t,
                                        const QScale& k, int qtid) {
  auto unit = [&](int u, auto quantize) {
    const int p = u >> 2, c = u & 3;
    const uint8_t* row = x + p * 128;
    const uint4 lo = *reinterpret_cast<const uint4*>(row + (((2 * c) ^ (p & 7)) << 4));
    const uint4 hi = *reinterpret_cast<const uint4*>(row + (((2 * c + 1) ^ (p & 7)) << 4));
    *reinterpret_cast<uint4*>(t + p * 64 + ((c ^ ((p >> 1) & 3)) << 4)) = quantize(lo, hi);
  };
  if (k.divide) {
    for (int u = qtid; u < kQUnits; u += kQQuantizers)
      unit(u, [&](const uint4& lo, const uint4& hi) { return q_exact(lo, hi, k); });
    return;
  }
#pragma unroll 2
  for (int u = qtid; u < kQUnits; u += kQQuantizers)
    unit(u, [&](const uint4& lo, const uint4& hi) { return q_fast(lo, hi, k); });
}

// Quantizer warps: chunk g's box (X slot g % 2) into its int8 tile (A slot
// g % 2), once the consumers are past chunk g - 2, the tile's last reader.
__device__ void q_quantize(uint8_t* smem, int a_off, uint64_t* xfull,
                           uint64_t* xempty, uint64_t* afull, uint64_t* aempty,
                           const QShape& s, const float* x_scale) {
  const int qtid = threadIdx.x - kQConsumers, lane = qtid % 32;
  const float xs = __ldg(x_scale);
  QScale k;
  k.s = xs;
  k.r = __frcp_rn(xs);
  k.divide = !(xs >= 0x1p-60f && xs <= 0x1p60f);
  const int total = q_chunks(s);
  for (int g = 0; g < total; ++g) {
    const int slot = g & 1;
    const uint32_t ph = static_cast<uint32_t>(g >> 1) & 1;
    mbar_wait(&xfull[slot], ph);
    mbar_wait(&aempty[slot], ph ^ 1);
    q_units(smem + slot * kQXSlot, smem + a_off + slot * kQASlot, k, qtid);
    fence_proxy_async();  // the tile is read by wgmma
    release(&afull[slot], lane);
    release(&xempty[slot], lane);
  }
}

// The float bits of a bf16 output for the max: y >= 0 after the ReLU, so
// the bits order as the values; -0.0 counts as +0.0.
__device__ __forceinline__ unsigned q_bits(__nv_bfloat16 v) {
  const unsigned u = static_cast<unsigned>(__bfloat16_as_ushort(v)) << 16;
  return u == 0x80000000u ? 0u : u;
}

// p[i] for a lane-dependent i in 0..3, by selects (no local memory).
__device__ __forceinline__ uint32_t q_pick(const uint32_t (&p)[4], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// Thread `tid` of warpgroup wg holds, of image row h0 + 2 wg + i, pixels
// w0 + 16 * warp + lane / 4 (+ 8) and channels d0 + 8 j + 2 (lane % 4) (+ 1):
// acc[i][4 j + 2 half + e], the wgmma accumulator layout. For each four j,
// the four lanes of a pixel trade pairs so that lane q holds the eight
// channels of j = 4 jj + q and stores them as 16 bytes.
template <int TN>
__device__ __forceinline__ void q_epilogue(int (&acc)[kQRowsWG][TN / 2],
                                           const QArgs& a, const QShape& s,
                                           const QTile& tl, float xs, int wg,
                                           int tid, unsigned& mx) {
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
#pragma unroll
  for (int jj = 0; jj < TN / 32; ++jj) {
    float2 sc[4], bi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = tl.d0 + 8 * (4 * jj + r) + 2 * q;
      const float2 ws = __ldg(reinterpret_cast<const float2*>(a.w_scale + d));
      // x_scale * w_scale[d], rounded
      sc[r] = make_float2(__fmul_rn(xs, ws.x), __fmul_rn(xs, ws.y));
      bi[r] = __ldg(reinterpret_cast<const float2*>(a.bias + d));
    }
#pragma unroll
    for (int i = 0; i < kQRowsWG; ++i) {
      const int h = tl.h0 + kQRowsWG * wg + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = tl.w0 + 16 * warp + lane / 4 + 8 * half;
        const bool inside = h < s.H && w < s.W;
        uint32_t p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // float(acc) * scale + b[d], each rounded, then the ReLU
          const int* v = &acc[i][4 * (4 * jj + r) + 2 * half];
          float v0 = __fadd_rn(__fmul_rn(__int2float_rn(v[0]), sc[r].x), bi[r].x);
          float v1 = __fadd_rn(__fmul_rn(__int2float_rn(v[1]), sc[r].y), bi[r].y);
          if (a.relu) {
            if (v0 < 0.f) v0 = 0.f;
            if (v1 < 0.f) v1 = 0.f;
          }
          const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
          if (inside) mx = max(mx, max(q_bits(out.x), q_bits(out.y)));
          p[r] = *reinterpret_cast<const uint32_t*>(&out);
        }
        // round r: send the pair of j = 4 jj + (q ^ r) to lane q ^ r, which
        // holds it at channels 2 q .. of its eight
        uint32_t got[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          got[r] = __shfl_xor_sync(0xffffffffu, q_pick(p, q ^ r), r);
        if (inside) {
          bf16* const dst = a.y + ((static_cast<long long>(tl.n) * s.H + h) * s.W + w) *
                                      s.Cout + tl.d0 + 32 * jj + 8 * q;
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(q_pick(got, q), q_pick(got, q ^ 1), q_pick(got, q ^ 2),
                         q_pick(got, q ^ 3));
        }
      }
    }
  }
}

// Both consumer warpgroups work on every tile, warpgroup wg on its output
// rows 2 wg and 2 wg + 1 (two m64 x TN accumulators), a chunk's products a
// kernel row at a time, its three taps shifted descriptors into the int8
// tile. The quantizer warps fill the next chunk's tile meanwhile, also
// while the consumers write a tile's output.
template <int TN>
__device__ void q_consume(uint8_t* smem, uint64_t* afull, uint64_t* aempty,
                          uint64_t* wfull, uint64_t* wempty, unsigned* red,
                          const QArgs& a, const QShape& s) {
  using K = QCfg<TN>;
  const int ctid = threadIdx.x, wg = ctid / 128, tid = ctid % 128;
  const int lane = tid % 32;
  const uint32_t base = smem_u32(smem);
  const float xs = __ldg(a.x_scale);
  const int total = q_chunks(s);
  int acc[kQRowsWG][TN / 2];
  unsigned mx = 0;
  int stage = 0;     // the W ring's next stage and its phase
  uint32_t phase = 0;
  int pending = -1;  // the W stage of the group in flight
  int g = 0;
  for (int l = 0; g < total; ++l) {
    const QTile tl = q_tile(s, static_cast<int>(blockIdx.x + l * gridDim.x), TN);
#pragma unroll
    for (int i = 0; i < kQRowsWG; ++i)
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc[i][e] = 0;
    for (int c = 0; c < s.chunks; ++c, ++g) {
      mbar_wait(&afull[g & 1], static_cast<uint32_t>(g >> 1) & 1);
      const uint32_t as = base + K::kAOff + (g & 1) * kQASlot;
      for (int kh = 0; kh < 3; ++kh) {
        mbar_wait(&wfull[stage], phase);
        const uint32_t bs = base + K::kWOff + stage * K::kWBytes;
#pragma unroll
        for (int i = 0; i < kQRowsWG; ++i) fence_acc(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
          for (int kk = 0; kk < kQChunk / 32; ++kk) {
            const uint64_t b = smem_desc(bs + kw * TN * kQChunk + kk * 32, 512, 2);
#pragma unroll
            for (int i = 0; i < kQRowsWG; ++i) {
              // tap (kh, kw) of output row 2 wg + i: box row 2 wg + i + kh
              // from pixel kw on, 64 rows of 64 bytes
              const int row = (kQRowsWG * wg + i + kh) * kQBoxW + kw;
              wgmma_s8<TN>(acc[i], smem_desc(as + row * kQChunk + kk * 32, 512, 2), b);
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group before is done
#pragma unroll
        for (int i = 0; i < kQRowsWG; ++i) fence_acc(acc[i]);
        if (pending >= 0) release(&wempty[pending], lane);
        pending = stage;
        if (++stage == K::kWStages) {
          stage = 0;
          phase ^= 1;
        }
        // chunk g - 1's products are done: its tile may be quantized over
        if (kh == 0 && g > 0) release(&aempty[(g - 1) & 1], lane);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kQRowsWG; ++i) fence_acc(acc[i]);
    release(&wempty[pending], lane);
    pending = -1;
    q_epilogue<TN>(acc, a, s, tl, xs, wg, tid, mx);
  }
  if (a.max_out != nullptr) {  // one atomicMax a block
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) red[ctid / 32] = mx;
    named_sync(1, kQConsumers);
    if (ctid == 0) {
      unsigned m = 0;
      for (int w = 0; w < kQConsumers / 32; ++w) m = max(m, red[w]);
      atomicMax(a.max_out, m);
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(kQThreads, 1) int8_conv3x3_q_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const QArgs a, const QShape s) {
  using K = QCfg<TN>;
  extern __shared__ uint8_t qsmem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(qsmem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + K::kBarOff);
  uint64_t* xempty = xfull + 2;
  uint64_t* afull = xempty + 2;
  uint64_t* aempty = afull + 2;
  uint64_t* wfull = aempty + 2;
  uint64_t* wempty = wfull + K::kWStages;
  unsigned* red = reinterpret_cast<unsigned*>(wempty + K::kWStages);
  if (threadIdx.x == 0) {
    // one arrival per warp that reads a slot: the quantizers' four for X,
    // the consumers' eight for A and W
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], kQQuantizers / 32);
      mbar_init(&afull[i], kQQuantizers / 32);
      mbar_init(&aempty[i], kQConsumers / 32);
    }
    ring_init(wfull, wempty, K::kWStages, kQConsumers / 32);
  }
  __syncthreads();
  // registers: 128 a thread at the launch; the producer gives 104 back,
  // the quantizers 40, and the consumers take them (24 + 88 + 2 x 200)
  if (threadIdx.x >= kQConsumers + kQQuantizers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kQConsumers + kQQuantizers)
      q_produce_w<TN>(&wmap, smem, wfull, wempty, s);
    else if (threadIdx.x == kQConsumers + kQQuantizers + 32)
      q_produce_x<TN>(&xmap, smem, xfull, xempty, s);
    return;
  }
  if (threadIdx.x >= kQConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n" ::: "memory");
    q_quantize(smem, K::kAOff, xfull, xempty, afull, aempty, s, a.x_scale);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  q_consume<TN>(smem, afull, aempty, wfull, wempty, red, a, s);
}

template <int TN>
int q_launch(const void* x, const void* w, const QArgs& a, const QShape& s,
             int Cin, int blocks, cudaStream_t stream) {
  using K = QCfg<TN>;
  CUtensorMap xmap, wmap;
  int err = encode_map(&xmap, x, s.N, s.H, s.W, Cin, kQChunk, kQBoxW,
                       CU_TENSOR_MAP_SWIZZLE_128B, kQRows + 2);
  if (err == 0) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(s.Cout), 9};
    const cuuint32_t box[3] = {kQChunk, TN, 3};
    err = encode_u8_map(&wmap, w, 3, dims, box, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != 0) return err;
  static SmemOnce smem_once;
  const int attr = smem_once.set(int8_conv3x3_q_kernel<TN>, K::kSmem);
  if (attr != 0) return attr;
  int8_conv3x3_q_kernel<TN><<<blocks, kQThreads, K::kSmem, stream>>>(xmap, wmap, a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bound with ctypes (ops/kernels/int8conv.py). `w` is the packed weight
// (ceil(Cout / 64) * 64, Kw) int8, Kw = 9 Cin + 32 rounded up to 16,
// 16-byte aligned;
// `relu` 0 or 1. Returns cudaGetLastError() after the launch on `stream`,
// or cudaErrorInvalidValue for arguments it does not take.
extern "C" int osvos_int8_conv3x3(const void* x, const void* w,
                                  const void* scale, const void* bias, void* y,
                                  int N, int H, int W, int Cin, int Cout,
                                  int relu, void* stream) {
  if (x == nullptr || w == nullptr || scale == nullptr || bias == nullptr ||
      y == nullptr || N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      !aligned(w, 16) || !aligned(scale, 4) || !aligned(bias, 4) ||
      !aligned(y, 2) || (relu != 0 && relu != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.M = static_cast<long long>(N) * H * W;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.cpt = (Cin + kPiece - 1) / kPiece;
  a.P = 9 * a.cpt;
  a.Kw = (9 * Cin + kPiece + 15) / 16 * 16;
  a.stages = (a.P + 1) / 2;
  a.n_tiles = (Cout + kBN - 1) / kBN;
  a.relu = relu;
  a.vec_out = Cout % 8 == 0 && aligned(y, 16);
  const long long blocks = (a.M + kBM - 1) / kBM * a.n_tiles;
  if (blocks > 0x7fffffffLL || static_cast<long long>(a.n_tiles) * kBN * a.Kw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (Cin % 16 == 0 && aligned(x, 16)) {
    int8_conv3x3_kernel<16><<<grid, kThreads, 0, s>>>(a);
  } else if (Cin % 4 == 0 && aligned(x, 4)) {
    int8_conv3x3_kernel<4><<<grid, kThreads, 0, s>>>(a);
  } else {
    int8_conv3x3_kernel<1><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Hopper path, bound with ctypes: y = I1(q(x), ...) with q(x) =
// clip(rint(float(x) / x_scale), -127, 127) formed in the kernel. x (N, H,
// W, Cin) bf16 NHWC; x_scale a float32 scalar on the device; w the (9, Cout,
// Cin) int8 [tap][out][in] weight (ops/kernels/int8conv.py
// pack_weight_hopper); w_scale and bias (Cout,) float32, y (N, H, W, Cout)
// bf16; Cin a multiple of 32 and Cout of 64; x, w and y 16-byte aligned,
// w_scale and bias 8-byte. With `max_out` (a float32 >= 0 on the device,
// relu 1), the max of y (-0.0 as +0.0) is folded into it by atomicMax on
// its bits. Returns cudaGetLastError() after the launch on `stream`, an
// error code of the tensor-map encoder, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int osvos_int8_conv3x3_q(const void* x, const void* x_scale,
                                    const void* w, const void* w_scale,
                                    const void* bias, void* y, void* max_out,
                                    int N, int H, int W, int Cin, int Cout,
                                    int relu, void* stream) {
  if (x == nullptr || x_scale == nullptr || w == nullptr || w_scale == nullptr ||
      bias == nullptr || y == nullptr || N < 1 || H < 1 || W < 1 ||
      Cin < 32 || Cout < 64 || Cin % 32 != 0 || Cout % 64 != 0 ||
      !aligned(x, 16) || !aligned(w, 16) || !aligned(y, 16) ||
      !aligned(x_scale, 4) || !aligned(w_scale, 8) || !aligned(bias, 8) ||
      (relu != 0 && relu != 1) ||
      (max_out != nullptr && (relu != 1 || !aligned(max_out, 4)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tn = Cout % 128 == 0 ? 128 : 64;
  QShape s;
  s.N = N;
  s.H = H;
  s.W = W;
  s.Cout = Cout;
  s.segs = (W + kQSeg - 1) / kQSeg;
  s.groups = (H + kQRows - 1) / kQRows;
  s.n_tiles = Cout / tn;
  s.chunks = (Cin + kQChunk - 1) / kQChunk;
  const long long tiles = static_cast<long long>(N) * s.groups * s.segs * s.n_tiles;
  if (tiles > 0x7fffff00LL) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = s.tiles < sms ? s.tiles : sms;
  QArgs a;
  a.x_scale = static_cast<const float*>(x_scale);
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.max_out = static_cast<unsigned*>(max_out);
  a.relu = relu;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tn == 128 ? q_launch<128>(x, w, a, s, Cin, blocks, st)
                   : q_launch<64>(x, w, a, s, Cin, blocks, st);
}
