// Weight gradient of a 3x3 SAME convolution, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel osvos_tpu/ops/pallas/wgrad.py `_kernel` (launched
// by `wgrad3x3`, B17) and, with the bias gradient, the flat trunk's dK + db
// (osvos_tpu/ops/pallas/flatconv.py `_wgrad_kernel`, B4, and the dK half of
// `_bwd_fused_kernel` and `_side_bwd_kernel`). It computes
//
//   dK[kh, kw, c, d] = sum_{n, h, w} x[n, h + kh - 1, w + kw - 1, c] * g[n, h, w, d]
//   db[d]            = sum_{n, h, w} g[n, h, w, d]          (with `with_db`)
//
// with x outside the image taken as zero; x (N, H, W, C) and g (N, H, W, D)
// are bf16, dK (3, 3, C, D) and db (D) are float32. Every product of two
// bf16 values is exact in float32, and the sums are taken in float32, as
// the JAX package's `_wgrad_einsum` (preferred_element_type=float32) takes
// them.
//
// Bound. Per conv it does 2 * 9 * C * D * N * H * W operations on the
// tensor cores and must read x and g once: at stage 1 (C = D = 64, batch 5
// at 480x854) 151 GFLOP against 0.52 GB, 0.153 ms at the card's 989 TFLOP/s
// and 0.157 ms at its 3.35 TB/s; at stage 5 (512 x 512 over 8 100 pixels)
// 38 GFLOP against 17 MB. It is bound by operations at every trunk conv
// after the stem (stage 1 sits at the ridge) and by bytes at the C -> 16
// side convs.
//
// Design of the Hopper path (C % 8 == 0 and D % 8 == 0: every trunk and
// side conv of the port). For one tap the function is the matrix product
// dK[kh, kw] = X_tap^T . G over K = the pixels, M = C, N = D. A block owns
// a 64 x TD tile of (C, D) (TD = 64, or 16 for D <= 16) and all nine taps of
// it, over a contiguous run of K-steps; a K-step is one image-row segment
// of KW = 32 or 64 pixels (whichever pads the row less).
// - TMA does the tap shift. x and g are 4-D tensor maps over (N, H, W, C)
//   and (N, H, W, D). For each K-step one producer thread loads the g box
//   (TD channels x KW pixels at (n, h, w0)) and, for each kh, one x box of
//   64 channels x (KW + 2) pixels at (n, h + kh - 1, w0 - 1). TMA fills
//   zeros outside the image and past C, D and W, which gives the SAME
//   padding at every edge and zero products on a row's ragged tail, with no
//   index arithmetic per pixel.
// - The kw shift is a start offset of kw pixel rows (128 bytes) into the
//   kh box: the x box is loaded once for the three kw taps.
// - Both operands are MN-major in shared memory (channels contiguous, a
//   128-byte row per pixel, 128-byte swizzle; g at TD = 16 a 32-byte row
//   and 32-byte swizzle), which bf16 wgmma reads through the descriptors'
//   transpose bits.
// - A ring of stages in dynamic shared memory with full and empty
//   mbarriers; one producer warp, three consumer warpgroups, one per kh,
//   each holding its three kw taps' 64 x TD float32 accumulators (96
//   registers a thread at TD = 64) and issuing wgmma.mma_async m64nTDk16
//   on the stages that have arrived, one commit group per stage kept in
//   flight while the next is issued.
// - The grid is one wave: min(132, K-steps x tiles) blocks, block b taking
//   units [b * total / blocks, (b + 1) * total / blocks) of the
//   tile-major order. A block whose run crosses a tile boundary writes the
//   finished tile's partial and goes on with the next, so every block
//   does the same work whatever the number of tiles. Piece b + t holds
//   block b's partial of tile t; a second pass adds each tile's pieces in
//   block order, so repeat launches give the same bits (no atomics).
// - db: the kh = 1 warpgroup of the blocks of the first C tile adds up the
//   columns of each staged g tile, and the second pass folds those sums
//   like the dK partials.
//
// The wmma path (csrc/wgrad.cu's first design, kept for the shapes TMA
// cannot describe: a global stride must be a multiple of 16 bytes, so C or
// D off a multiple of 8 takes it). A block owns one tap, one 64x64 or
// 16x64 (C, D) tile and one pixel chunk; it stages 32 pixel rows of x
// (shifted by the tap, zero outside the image) and g in shared memory and
// four warps run nvcuda::wmma 16x16x16 products; a second pass adds the
// chunks in order. The shape picks the path (ops/kernels/wgrad.py `plan`);
// a failure never does.
//
// S sequences in one launch (B17 of the packed schedule,
// ops/kernels/wgrad.py `wgrad3x3_seq`). x is (N, H, W, S * C) and g
// (N, H, W, S * D), sequence s the channels [s * C, (s + 1) * C) of x and
// [s * D, (s + 1) * D) of g, as the grouped conv of the packed trunk keeps
// them; dK is (S, 3, 3, C, D). Each sequence runs the lone launch's plan
// (blocks, unit ranges, pieces or chunks, fold order), so its dK is bit for
// bit what a lone launch on its contiguous slice gives. On the Hopper path
// x and g are 5-D maps (C, S, W, H, N) and (D, S, W, H, N): a box at
// sequence s reads its channels in place and TMA's zero fill stops at its
// own C or D, where a 4-D map at channel offset s * C would read the next
// sequence's channels into a tile past C. The lone launch is S = 1.
// - What held it back. A box row at sequence s is s's 64 channels of a
//   pixel, at stage 1 (C = D = 64) 128 of the pixel's S * 128 bytes, and the
//   maps ask for 256-byte L2 promotion. With the sequence as the slow grid
//   index, one sequence's 132 blocks ran as one wave and the next
//   sequence's as the next, so the other half of every line was fetched
//   from DRAM again a wave later: stage 1 took 1.081 ms against its two
//   lone launches' 0.767 (S = 2, batch 5 at 480x854, H100 80GB HBM3 at
//   700 W); the wider stages, whose lone boxes are already slices of wider
//   pixels, were level.
// - The Hopper path's two passes dispatch sequence-major (hopper.cuh
//   `seq_block`): grid block i runs sequence i % S of the lone launch's
//   block of rank i / S, so the S blocks of one unit range run side by side
//   and fetch each pixel's S slices together. Pass 1 ranks the lone blocks
//   by the pixel at which their run starts, then by tile (`ranked_block`):
//   with the blocks in tile order, the first of S waves would
//   take the first tiles of every pixel (at stage 2, C = 64 and D = 128,
//   the first D tile) and the next wave would read x again for the rest;
//   ranked, each wave takes every tile of its share of the pixels. A lone
//   launch (S = 1) is one wave and keeps the tile order. The rank is
//   computed in the kernel (`ranked_block`): a 132-entry order table among
//   the kernel's parameters made B4 (the lone dK + db) slower. The wmma
//   path keeps its 3-D grid (the sequence in z): it takes only C or D off a
//   multiple of 8, which no full-width trunk conv has.
// - What bounds it now: the lone launches' design, S times over. At S = 2
//   the 12 trunk convs take about 5.2 ms, level with two lone launches and
//   48% of their 2.527 ms operation bound; pass 1 takes 4.9 ms of it and
//   pass 2, the fold of the pieces, 0.28. Pass 1 runs wgmma m64n64k16 with
//   both operands from shared memory: 4 KB read for 131 kFLOP, so the full
//   tensor rate would need about 31 TB/s of shared-memory reads, about the
//   whole of the card's (128 bytes a clock on each of 132 SMs) before TMA's
//   writes. Wider tiles (m64n128 or m64n256, each staged x read for twice
//   or four times the products) or A from registers would lift it, in the
//   core that B4 and B6's dK share.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <numeric>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The Hopper path: TMA, mbarrier ring, wgmma
// ---------------------------------------------------------------------------

constexpr int kNumSMs = 132;
constexpr int kTileC = 64;                 // C rows of a block's tile
constexpr int kConsumers = 3;              // warpgroups, one per kh
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kTmaThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kSmemBudget = 200 * 1024;    // bytes of the stage ring

template <int TD, int KW>
struct Cfg {
  static constexpr int kGBytes = KW * TD * 2;         // g box, 1024-multiple
  static constexpr int kXRows = KW + 2;               // haloed x box rows
  static constexpr int kXBytes = (kXRows * 128 + 1023) / 1024 * 1024;
  static constexpr int kStage = kGBytes + 3 * kXBytes;
  static constexpr int kStages =
      kSmemBudget / kStage < 12 ? kSmemBudget / kStage : 12;
  static constexpr uint32_t kTx = kGBytes + 3 * kXRows * 128;  // per stage
  static constexpr int kAcc = TD / 2;   // float32 accumulators a thread a tap
  static constexpr int kPiece = 9 * kTileC * TD + TD;  // floats of a piece
  static constexpr int kSmem =
      1024 + kStages * kStage + 2 * kStages * 8 + 128 * 4;
  static_assert(kGBytes % 1024 == 0, "stages must stay 1024-byte aligned");
};

struct TmaShape {
  int N, H;
  int segs;         // K-steps (row segments) per image row
  int DT;           // D tiles
  long long units;  // K-steps per tile: N * H * segs
  long long total;  // units * tiles
  int blocks;
  int with_db;
  long long pieces; // pieces of a sequence: blocks + tiles - 1
  int S;            // sequences
  // the dispatch order over S > 1 sequences (ranked_block): blocks / gcd
  // (tiles, blocks), and the inverse of tiles / gcd modulo it
  int ranks;
  int inv;
};

// The block of rank r of a launch (grid block i runs block ranked_block(i /
// S) of sequence i % S). One sequence: block r. Over S > 1 sequences the
// blocks ranked by (b * tiles) % blocks, then by tile, which orders them
// by the K-step at which their run starts within its tile: a wave then
// takes every tile of the same pixels. With g = gcd(tiles, blocks), the g
// blocks of rank r / g are b0 + j * (blocks / g), j = r % g, where b0 solves
// b0 * tiles = (r / g) * g modulo blocks (ops/kernels/wgrad.py `Plan.order`).
__device__ __forceinline__ int ranked_block(int r, const TmaShape& s) {
  if (s.S == 1) return r;
  const int g = s.blocks / s.ranks;
  return static_cast<int>(static_cast<long long>(r / g) * s.inv % s.ranks) +
         r % g * s.ranks;
}

// The column sums of a staged g tile (KW rows of TD bf16, swizzled as TMA
// wrote it) that thread `tid` of a warpgroup owns: column tid % TD, every
// (128 / TD)-th row from tid / TD.
template <int TD, int KW>
__device__ __forceinline__ float column_sum(const uint8_t* g, int tid) {
  constexpr int kStep = 128 / TD;
  const int col = tid % TD;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < KW / kStep; ++i) {
    const int r = tid / TD + i * kStep;
    const int chunk = (col / 8) ^ (TD == 64 ? r % 8 : (r / 4) % 2);
    v += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
        g + r * TD * 2 + chunk * 16 + (col % 8) * 2));
  }
  return v;
}

template <int TD, int KW>
__device__ void produce(const CUtensorMap* xmap, const CUtensorMap* gmap,
                        uint8_t* smem, uint64_t* full, uint64_t* empty,
                        const TmaShape& s, int seq, long long u0, long long u1) {
  using K = Cfg<TD, KW>;
  long long t = u0 / s.units;
  const long long r = u0 - t * s.units;
  int j = static_cast<int>(r % s.segs);
  const long long row = r / s.segs;
  int h = static_cast<int>(row % s.H), n = static_cast<int>(row / s.H);
  int stage = 0;
  uint32_t phase = 0;
  for (long long u = u0; u < u1; ++u) {
    const int c0 = static_cast<int>(t / s.DT) * kTileC;
    const int d0 = static_cast<int>(t % s.DT) * TD;
    const int w0 = j * KW;
    uint8_t* st = smem + stage * K::kStage;
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], K::kTx);
    tma_load(st, gmap, &full[stage], d0, seq, w0, h, n);
    for (int kh = 0; kh < 3; ++kh) {
      tma_load(st + K::kGBytes + kh * K::kXBytes, xmap, &full[stage],
               c0, seq, w0 - 1, h + kh - 1, n);
    }
    if (++j == s.segs) {
      j = 0;
      if (++h == s.H) {
        h = 0;
        if (++n == s.N) {
          n = 0;
          ++t;
        }
      }
    }
    if (++stage == K::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Write the three taps' accumulators of warpgroup `kh` (and, from the kh = 1
// warpgroup of the first C tile, the bias-gradient column sums) to `piece`,
// tile-local: [tap][c - c0][d - d0], then db[d - d0].
template <int TD>
__device__ __forceinline__ void store_piece(float* piece, float (&acc)[3][TD / 2],
                                            float colsum, bool db_tile,
                                            float* fold, int kh, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    float* out = piece + (kh * 3 + kw) * kTileC * TD;
#pragma unroll
    for (int j = 0; j < TD / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + r * TD + col) =
          make_float2(acc[kw][4 * j], acc[kw][4 * j + 1]);
      *reinterpret_cast<float2*>(out + (r + 8) * TD + col) =
          make_float2(acc[kw][4 * j + 2], acc[kw][4 * j + 3]);
    }
  }
  if (db_tile) {  // uniform over the warpgroup
    fold[tid] = colsum;
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid < TD) {
      float v = 0.f;
      for (int k = tid; k < 128; k += TD) v += fold[k];
      piece[9 * kTileC * TD + tid] = v;
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }
}

// `partial` is the block's sequence's pieces; the block is the lone
// launch's block `block`.
template <int TD, int KW>
__device__ void consume(uint8_t* smem, uint64_t* full, uint64_t* empty,
                        float* fold, float* __restrict__ partial,
                        const TmaShape& s, int block, long long u0, long long u1) {
  using K = Cfg<TD, KW>;
  const int kh = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const uint32_t base = smem_u32(smem);
  const bool db_wg = s.with_db && kh == 1;
  float acc[3][K::kAcc];
  int stage = 0, pending = -1;
  uint32_t phase = 0;
  long long u = u0;
  for (long long t = u0 / s.units; u < u1; ++t) {  // each tile the run meets
    const long long end = (t + 1) * s.units < u1 ? (t + 1) * s.units : u1;
    const bool db_tile = db_wg && t < s.DT;         // first C tile
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int i = 0; i < K::kAcc; ++i) acc[kw][i] = 0.f;
    float colsum = 0.f;
    for (; u < end; ++u) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = base + stage * K::kStage;
      const uint32_t xs = st + K::kGBytes + kh * K::kXBytes;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) fence_acc(acc[kw]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const uint64_t b = TD == 64 ? smem_desc(st + kk * 2048, 1024, 1)
                                    : smem_desc(st + kk * 512, 256, 3);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          // tap kw reads the kh box from pixel row kw on
          wgmma_bf16<TD, 1, 1>(acc[kw], smem_desc(xs + (kw + 16 * kk) * 128, 1024, 1), b);
        }
      }
      wgmma_commit();
      if (db_tile) colsum += column_sum<TD, KW>(smem + stage * K::kStage, tid);
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) fence_acc(acc[kw]);
      if (pending >= 0) release(&empty[pending], lane);
      pending = stage;
      if (++stage == K::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) fence_acc(acc[kw]);
    release(&empty[pending], lane);
    pending = -1;
    store_piece<TD>(partial + (block + t) * K::kPiece, acc, colsum, db_tile,
                    fold, kh, tid);
  }
}

// Pass 1. Grid block i is block b = ranked_block(r) of sequence q, (q, r) =
// seq_block(i, S): it runs units [b * total / blocks, (b + 1) * total /
// blocks) of sequence q and writes piece b + t of every tile t it touches
// to the sequence's pieces.
template <int TD, int KW>
__global__ void __launch_bounds__(kTmaThreads, 1) wgrad_tma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap gmap, float* __restrict__ partial,
    const TmaShape s) {
  using K = Cfg<TD, KW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K::kStages * K::kStage);
  uint64_t* empty = full + K::kStages;
  float* fold = reinterpret_cast<float*>(empty + K::kStages);
  const SeqBlock sb = seq_block(blockIdx.x, s.S);
  const int block = ranked_block(sb.block, s);
  const long long u0 = s.total * block / s.blocks;
  const long long u1 = s.total * (block + 1) / s.blocks;
  if (threadIdx.x == 0) {
    // one arrival on an empty barrier per consumer warp
    ring_init(full, empty, K::kStages, 4 * kConsumers);
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) {
      produce<TD, KW>(&xmap, &gmap, smem, full, empty, s, sb.seq, u0, u1);
    }
    return;
  }
  consume<TD, KW>(smem, full, empty, fold, partial + sb.seq * s.pieces * K::kPiece,
                  s, block, u0, u1);
}

// Pass 2: out[i] = the sum of tile t's pieces b + t over the blocks b whose
// runs meet it, in block order; four consecutive outputs a thread, grid
// block i the outputs' block i / S of sequence i % S (seq_block).
__global__ void __launch_bounds__(256) wgrad_tma_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int C, int D,
    int TD, int DT, long long units, long long total, int blocks,
    long long n_out, long long pieces, int S) {
  const SeqBlock sb = seq_block(blockIdx.x, S);
  const long long i = (static_cast<long long>(sb.block) * 256 + threadIdx.x) * 4;
  if (i >= n_out) return;
  partial += sb.seq * pieces * (9LL * kTileC * TD + TD);
  out += sb.seq * n_out;
  const long long cd = static_cast<long long>(C) * D;
  long long t, local;
  if (i < 9 * cd) {
    const long long tap = i / cd, rem = i - tap * cd;
    const int c = static_cast<int>(rem / D), d = static_cast<int>(rem % D);
    t = static_cast<long long>(c / kTileC) * DT + d / TD;
    local = (tap * kTileC + c % kTileC) * TD + d % TD;
  } else {  // db
    const int d = static_cast<int>(i - 9 * cd);
    t = d / TD;
    local = 9LL * kTileC * TD + d % TD;
  }
  const long long piece = 9LL * kTileC * TD + TD;
  // the first and last block whose run [b * total / blocks, ...) meets
  // [t * units, (t + 1) * units)
  const long long b_lo = (t * units + 1) * blocks / total +
                         ((t * units + 1) * blocks % total != 0) - 1;
  long long b_hi = ((t + 1) * units * blocks + total - 1) / total - 1;
  if (b_hi > blocks - 1) b_hi = blocks - 1;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long b = b_lo; b <= b_hi; ++b) {
    const float4 v =
        *reinterpret_cast<const float4*>(partial + (b + t) * piece + local);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(out + i) = acc;
}

template <int TD, int KW>
int launch_tma(const void* x, const void* g, float* partial, const TmaShape& s,
               int W, int C, int D, int S, cudaStream_t stream) {
  using K = Cfg<TD, KW>;
  CUtensorMap xmap, gmap;
  int err = encode_map5(&xmap, x, s.N, s.H, W, S, C, kTileC, KW + 2,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) {
    err = encode_map5(&gmap, g, s.N, s.H, W, S, D, TD, KW,
                      TD == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (err != 0) return err;
  static SmemOnce smem_once;
  const int attr = smem_once.set(wgrad_tma_kernel<TD, KW>, K::kSmem);
  if (attr != 0) return attr;
  wgrad_tma_kernel<TD, KW><<<s.blocks * S, kTmaThreads, K::kSmem, stream>>>(
      xmap, gmap, partial, s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wmma path, for C or D off a multiple of 8
// ---------------------------------------------------------------------------

using namespace nvcuda;

constexpr int kTK = 32;  // pixel rows staged per step
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Shape {
  int N, H, W, C, D;
  long long P;      // N * H * W
  long long chunk;  // pixels per split
  int S;            // sequences, channels interleaved (S * C, S * D a pixel)
};

// Stage the rows [p0, p0 + kTK) of one operand, channels [c0, c0 + T), into
// shared memory with row stride LD. For x (kShift), row p reads the input
// pixel shifted by the tap and is zero outside the image; rows past p_hi
// and channels past the extent are zero. A pixel holds `extent` channels of
// each of s.S sequences; the block's sequence starts at channel `base`.
template <int T, int LD, bool kVec, bool kShift>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* __restrict__ dst, const __nv_bfloat16* __restrict__ src,
    const Shape& s, int extent, long long base, long long p0, long long p_hi,
    int c0, int kh, int kw) {
  const long long pixel = static_cast<long long>(s.S) * extent;
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
          off = ((n * s.H + h) * s.W + w) * pixel + base + c;
        }
      } else {
        off = p * pixel + base + c;
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

// Pass 1. Block (tap + 9 * split, c-tile, d-tile + D tiles * sequence)
// writes its float32 tile of pixel chunk `split` to partial[sequence,
// split, tap, c, d].
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
  const int dt = (s.D + TD - 1) / TD;
  const int seq = blockIdx.z / dt;
  const int d0 = (blockIdx.z % dt) * TD;
  partial += static_cast<long long>(seq) * (gridDim.x / 9) * stride;
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
    stage_rows<TC, LDA, kVecX, true>(As, x, s, s.C, static_cast<long long>(seq) * s.C,
                                     p0, p_hi, c0, kh, kw);
    stage_rows<TD, LDB, kVecG, false>(Bs, g, s, s.D, static_cast<long long>(seq) * s.D,
                                      p0, p_hi, d0, 0, 0);
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

// Pass 2: out[i] = sum over splits of partial[split, i], in split order,
// for sequence blockIdx.y.
__global__ void __launch_bounds__(256) wgrad_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, long long n,
    long long splits) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  partial += blockIdx.y * splits * n;
  out += blockIdx.y * n;
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
                  (s.D + TD - 1) / TD * s.S);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The Hopper path, bound with ctypes. x (N, H, W, S * C) and g (N, H, W,
// S * D) contiguous bf16 with C % 8 == 0 and D % 8 == 0, S sequences
// (S = 1: one); `tile_d` 64 or 16 output channels of a block tile (C tiles
// are 64); `step` 64 or 32 pixels of a K-step (one image-row segment);
// `blocks` a sequence, at most 132 and at most the K-steps of all tiles,
// N * H * ceil(W / step) * ceil(C / 64) * ceil(D / tile_d). partial: S *
// (blocks + tiles - 1) pieces of 9 * 64 * tile_d + tile_d float32; out S
// rows of (9 * C * D + with_db * D) float32, dK (3, 3, C, D) followed by db
// (D) when `with_db` is 1; every base 16-byte aligned. Returns 0 or an
// error code after the two launches on `stream`.
extern "C" int osvos_wgrad3x3_tma(const void* x, const void* g, void* partial,
                                  void* out, int N, int H, int W, int C, int D,
                                  int S, int tile_d, int step, int blocks,
                                  int with_db, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 8 || D < 8 || C % 8 != 0 ||
      D % 8 != 0 || S < 1 || S > 65535 || (tile_d != 64 && tile_d != 16) ||
      (step != 64 && step != 32) || (with_db != 0 && with_db != 1) ||
      blocks < 1 || blocks > kNumSMs || !aligned16(x) || !aligned16(g) ||
      !aligned16(partial) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int segs = (W + step - 1) / step;
  const int DT = (D + tile_d - 1) / tile_d;
  const long long tiles = static_cast<long long>((C + kTileC - 1) / kTileC) * DT;
  const long long units = static_cast<long long>(N) * H * segs;
  const int common = static_cast<int>(std::gcd(tiles, static_cast<long long>(blocks)));
  const int ranks = blocks / common;
  int inv = 0;  // tiles / common * inv = 1 modulo ranks
  while (ranks > 1 && tiles / common % ranks * inv % ranks != 1) ++inv;
  const TmaShape s{N, H, segs, DT, units, units * tiles, blocks, with_db,
                   blocks + tiles - 1, S, ranks, inv};
  if (blocks > s.total) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  int err;
  if (tile_d == 64) {
    err = step == 64 ? launch_tma<64, 64>(x, g, part, s, W, C, D, S, st)
                     : launch_tma<64, 32>(x, g, part, s, W, C, D, S, st);
  } else {
    err = step == 64 ? launch_tma<16, 64>(x, g, part, s, W, C, D, S, st)
                     : launch_tma<16, 32>(x, g, part, s, W, C, D, S, st);
  }
  if (err != 0) return err;
  const long long n_out = 9LL * C * D + with_db * D;
  wgrad_tma_reduce_kernel<<<static_cast<unsigned>((n_out / 4 + 255) / 256 * S),
                            256, 0, st>>>(part, static_cast<float*>(out), C, D,
                                          tile_d, DT, units, s.total, blocks,
                                          n_out, s.pieces, S);
  return static_cast<int>(cudaGetLastError());
}

// The wmma path, bound with ctypes. x (N, H, W, S * C) and g (N, H, W,
// S * D) contiguous bf16, S sequences (S = 1: one); partial (S, splits,
// 9 * C * D + with_db * D) float32 scratch; out S rows of (9 * C * D +
// with_db * D) float32, dK (3, 3, C, D) followed by db (D) when `with_db`
// is 1; every base 16-byte aligned. `tile_c` is 64 (a 64x64 block tile) or
// 16 (16x64, for narrow inputs such as the 3-channel stem). `chunk` pixels
// per split, a multiple of 32, with splits * chunk >= N * H * W. Returns
// cudaGetLastError() after the two launches on `stream`, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int osvos_wgrad3x3(const void* x, const void* g, void* partial,
                              void* out, int N, int H, int W, int C, int D,
                              int S, int tile_c, long long splits,
                              long long chunk, int with_db, void* stream) {
  const long long P = static_cast<long long>(N) * H * W;
  if (N < 1 || H < 1 || W < 1 || C < 1 || D < 1 || S < 1 || splits < 1 ||
      chunk < kTK || chunk % kTK != 0 || splits * chunk < P ||
      (splits - 1) * chunk >= P || 9 * splits > 0x7fffffffLL ||
      (tile_c != 64 && tile_c != 16) || (with_db != 0 && with_db != 1) ||
      static_cast<long long>((D + 63) / 64) * S > 65535 || S > 65535 ||
      !aligned16(x) || !aligned16(g) || !aligned16(partial) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{N, H, W, C, D, P, chunk, S};
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
  wgrad_reduce_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256), S), 256, 0,
                        stream_>>>(part, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
