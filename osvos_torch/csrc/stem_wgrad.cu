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
// Function as one product. The pixels are the reduction dimension. Each
// pixel's nine taps x C channels are stacked into one row of K = 32
// values, row index t * C + c (t = 3 * kh + kw), followed by a column of
// ones (index 9 * C) and zeros; the whole function is then ONE product
// Out = S^T . G over the pixels, (32 x P) . (P x D), and db is row 9 * C of
// it, so g is read once for both. This is the TPU kernel's tap stacking;
// its packed pixel pairs, u32 shifts and lane rolls do not carry over.
//
// Bound. At batch 5 on 480x854 with D = 64 it must read g (262 MB) and the
// image (12 MB) once: 0.082 ms at 3.35 TB/s, against 7.1 GFLOP (2 x 27 x
// 64 per pixel), 0.007 ms at the bf16 tensor-core rate. It is bound by
// bytes: the design keeps HBM busy on g while the image is staged cheaply
// beside it.
//
// Two paths; the shape picks one (ops/kernels/stem_wgrad.py), a failure
// never does.
//
// The Hopper path (`osvos_stem_wgrad_tma`, D a multiple of 8; csrc/stem.cuh
// has the parts it shares with the stem's forward, csrc/stem.cu):
// - A persistent grid: per 64-channel tile of D, one block per SM (or per
//   image row where there are fewer), block b taking a contiguous run of
//   image rows (n, h).
// - g streams through a ring of six 16 KB stages filled by one producer
//   thread: a TMA box of 64 channels x 128 pixels of one row (a 3-D map
//   over (N * H, W, D), 128-byte swizzle), zero past W and past D.
// - The image rows come through a rolling strip of four slots: while a
//   row's segments are multiplied, the copy of the row two ahead is in
//   flight (cp.async; a row starts on a 2- or 4-byte boundary, which TMA
//   cannot describe).
// - The consumer warpgroup builds each pixel's stacked row (one thread a
//   pixel, the taps unrolled) into a 128 x 32 tile (64-byte swizzle, three
//   in turn) and runs wgmma m64n32k16: D^T (64 channels x 32) += G^T (64 x
//   128 pixels, the TMA box read MN-major) . S (128 x 32, MN-major). The
//   float32 accumulators stay in registers for the block's whole run.
// - Each block writes its rows of the (9 C + 1, D) output as one run's
//   partial; the mma path's second pass adds the runs' partials in a fixed
//   order, so repeat launches give the same bits.
//
// The mma path (`osvos_stem_wgrad`, the first design, kept for D off a
// multiple of 8): a block walks over row segments of 64 pixels (one image
// row, 64 columns): it stages the haloed strip of three image rows (the
// segment's row and its neighbours, 66 columns, zero off the image) and
// the segment's g rows in shared memory, builds the stacked operand from
// the strip, and four warps, each owning 16 output channels, run mma.sync
// m16n8k16 bf16 products into float32 accumulators. Blocks take contiguous
// runs of segments (split-K); a second pass adds their partial outputs in
// a fixed order.
//
// S sequences in one launch (B16 of the packed schedule,
// ops/kernels/stem_wgrad.py `stem_wgrad_seq`): x is (N, H, W, S * C) and g
// (N, H, W, S * D), sequence s the channels [s * C, (s + 1) * C) of x and
// [s * D, (s + 1) * D) of g (the grouped conv's layout); dK is (S, 3, 3, C,
// D) and db (S, D). Each sequence runs the lone launch's plan (runs or
// splits, partial slots, fold order), so its result is bit for bit a lone
// launch on its slice. On the Hopper path g is a 4-D map (D, S, W, N * H), a
// box at sequence s its channels alone.
// - What held it back. An interleaved strip would hold S * C values a
//   pixel and outgrows shared memory beyond S = 4, so the first sequence
//   kernel built every stacked row from global memory: up to 27 scalar
//   loads a consumer thread between the ring wait and each segment's
//   wgmma, each image value read nine times; and its grid put the sequence
//   in y, so g's S slices of a pixel were read a wave apart. It took 0.464
//   ms against two lone launches' 0.212 and a bound of 0.164 (S = 2, batch 5
//   at 480x854, D = 64; H100 80GB HBM3 at 700 W).
// - The sequence kernel (kGather) keeps the lone strip: four slots and the
//   zero row of the lone shape, each slot one image row of the block's own
//   sequence, laid out as the lone strip lays out that row of the
//   sequence's contiguous slice. A gather warpgroup, which the consumers do
//   not wait on, fills the slots two rows ahead (`gather_rows`: plain loads
//   along the interleaved row, stores into the slot, halo included) and
//   publishes each on an mbarrier; the consumers free a slot on another
//   once its last output row is built. The consumers then run the lone
//   `build_stacked` on the strip: the same values in the same tile, the
//   same products in the same order.
// - The grid is sequence-major (hopper.cuh `seq_block`), so the S blocks
//   of one row run are dispatched side by side and read each g pixel's S
//   slices together. The mma path keeps the sequence in z.
// - It now takes about 0.21 ms at S = 2, level with two lone launches and
//   76% of the bound: like the lone launch, it is bound by reading g.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "stem.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTW = 64;       // pixels of a row segment, one staged step
constexpr int kRows = 32;     // rows of the stacked operand
constexpr int kTD = 64;       // output channels of a block
constexpr int kWarps = kTD / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = kStemMaxC;
constexpr int kStrip = kTW + 2;  // staged columns of a strip row
constexpr int kLDA = kTW + 8;    // bf16 row strides: 16-byte multiples,
constexpr int kLDG = kTD + 8;    // padded against bank conflicts

struct Shape {
  int N, H, W, C, D;
  int segs_w;           // segments per image row
  long long segs;       // N * H * segs_w
  long long per_block;  // segments of one split
  int rows;             // 9 * C + 1 rows of the output
  int S;                // sequences, channels interleaved
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

// Pass 1. Block (split, d-tile, sequence) writes the (rows, D) float32
// output of its run of segments, channels [d0, d0 + kTD), to
// partial[sequence, split].
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
  const int seq = blockIdx.z;
  const long long xpix = static_cast<long long>(s.S) * s.C;  // a pixel's values
  const long long gpix = static_cast<long long>(s.S) * s.D;
  x += static_cast<long long>(seq) * s.C;
  g += static_cast<long long>(seq) * s.D;
  partial += static_cast<long long>(seq) * gridDim.x * s.rows * s.D;
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
        v = x[((n * s.H + hh) * s.W + ww) * xpix + c];
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
          v = __ldg(reinterpret_cast<const uint4*>(g + (p0 + j) * gpix + d0 + dv));
        }
        *reinterpret_cast<uint4*>(Gs + j * kLDG + dv) = v;
      }
    } else {
      for (int i = threadIdx.x; i < kTW * kTD; i += kThreads) {
        const int j = i / kTD, dd = i % kTD;
        Gs[j * kLDG + dd] =
            j < tw && d0 + dd < s.D ? g[(p0 + j) * gpix + d0 + dd] : zero;
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

// Pass 2: out[i] = sum over splits of partial[split, i], for sequence
// blockIdx.y. A block owns 32 consecutive outputs; warp w adds splits w,
// w + 8, ... in order, then one warp adds the eight warps' sums in order.
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(32 * kReduceWarps) stem_wgrad_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n,
    long long splits) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  partial += blockIdx.y * splits * n;
  out += static_cast<long long>(blockIdx.y) * n;
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

// ---------------------------------------------------------------------------
// The Hopper path: the rolling strip, a TMA ring of g, wgmma
// ---------------------------------------------------------------------------

constexpr int kNumSMs = 132;
constexpr int kStages = 6;
constexpr int kSlots = 4;                                  // rows r - 1 .. r + 2
constexpr int kGBox = kStemSeg * kStemTileD * 2;           // 16 KB
constexpr int kSBytes = kStemSeg * kStemRowBytes;          // 8 KB
constexpr int kSTiles = 3;
constexpr int kTmaThreads = 128 + 32;                      // + the producer warp
constexpr int kGatherThreads = 128;                        // the gather warpgroup
constexpr int kGatherBatch = 16;                           // loads in flight a thread
constexpr int kSmemLimit = 227 * 1024;

// Dynamic shared memory of a launch: the ring, the stacked tiles, the strip
// and the zero row, the ring's and the strip's barriers
// (ops/kernels/stem_wgrad.py `tma_smem`).
inline int tma_smem_bytes(const StemShape& s) {
  return 1024 + kStages * kGBox + kSTiles * kSBytes + (kSlots + 1) * s.slot_bytes +
         2 * (kStages + kSlots) * 8;
}

// The sequence kernel's gather, thread `gtid` of kGatherThreads: image rows
// first .. last of sequence `seq` of x (N, H, W, S * C) into their strip
// slots, each as the lone launch's strip holds that row of the sequence's
// contiguous slice: its W * C values from the slot's lead on, a zero pixel
// either side (the halo). A sequence's values start on a 2-byte boundary of
// an S * C-value pixel, which neither cp.async nor TMA can describe: each
// thread makes kGatherBatch plain loads, neighbouring threads on
// neighbouring values of the sequence's row, then stores them. Row r's slot
// is written once the consumers have freed it (row r - kSlots read by every
// output row; freed[]) and published on landed[] (ops/kernels/stem_wgrad.py
// `gather_row` mirrors the arithmetic).
template <int C>
__device__ __forceinline__ void gather_rows(uint8_t* strip, uint64_t* landed,
                                            uint64_t* freed,
                                            const uint16_t* __restrict__ x,
                                            const StemShape& s, int S, int seq,
                                            long long first, long long last,
                                            int gtid) {
  const long long pixel = static_cast<long long>(S) * C;
  const int n = s.W * C;
  for (long long r = first; r <= last; ++r) {
    const int slot = static_cast<int>(r % kSlots);
    const uint32_t use = static_cast<uint32_t>((r - first) / kSlots) & 1;
    mbar_wait(&freed[slot], use ^ 1);
    uint16_t* dst = reinterpret_cast<uint16_t*>(strip + slot * s.slot_bytes +
                                                row_window(s, r).lead);
    const uint16_t* src = x + r * s.W * pixel + seq * C;
    for (int i0 = gtid - C; i0 < n + C; i0 += kGatherThreads * kGatherBatch) {
      uint16_t v[kGatherBatch];
#pragma unroll
      for (int k = 0; k < kGatherBatch; ++k) {
        const int i = i0 + k * kGatherThreads;
        v[k] = i >= 0 && i < n ? __ldg(src + (i / C) * pixel + i % C) : 0;
      }
#pragma unroll
      for (int k = 0; k < kGatherBatch; ++k) {
        const int i = i0 + k * kGatherThreads;
        if (i < n + C) dst[i] = v[k];
      }
    }
    mbar_arrive(&landed[slot]);
  }
}

// Pass 1. Grid block i is block b = bb * DT + t of sequence q (seq_block):
// it takes channel tile t and the bb-th run of image rows of sequence q and
// writes its product's rows 0 .. 9 C and channels [64 t, 64 t + 64) to
// partial[q, bb] (9 C + 1, D), float32. The image rows come through the
// rolling strip: for one image (S = 1, !kGather) the consumers cp.async
// them; over S interleaved sequences (kGather) the gather warpgroup fills
// the same slots with the block's own sequence's channels.
template <int C, bool kGather>
__global__ void __launch_bounds__(kGather ? kTmaThreads + kGatherThreads : kTmaThreads, 1)
    stem_wgrad_tma_kernel(const __grid_constant__ CUtensorMap gmap,
                          const uint8_t* __restrict__ x, float* __restrict__ partial,
                          const StemShape s, int D, int DT, int S) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* ring = smem;
  uint8_t* stacked = ring + kStages * kGBox;
  uint8_t* strip = stacked + kSTiles * kSBytes;
  uint8_t* zero_row = strip + kSlots * s.slot_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero_row + s.slot_bytes);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;  // the gather's slots
  uint64_t* freed = landed + kSlots;
  const SeqBlock sb = seq_block(blockIdx.x, S);
  const int d0 = (sb.block % DT) * kStemTileD;
  const int runs = gridDim.x / S / DT, bb = sb.block / DT;
  const long long r_lo = run_start(s.rows, bb, runs);
  const long long r_hi = run_start(s.rows, bb + 1, runs);
  // the image rows that the run's output rows read
  const long long first = r_lo > 0 ? r_lo - 1 : 0;
  const long long last = r_hi < s.rows ? r_hi : s.rows - 1;

  if (threadIdx.x == 0) {
    if (kGather) {
      for (int i = 0; i < kSlots; ++i) {
        mbar_init(&landed[i], kGatherThreads);
        mbar_init(&freed[i], 1);
      }
    }
    ring_init(full, empty, kStages, 4);  // a warp's arrival
  }
  for (int i = threadIdx.x; i < (kSlots + 1) * s.slot_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(strip)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (kGather && threadIdx.x >= kTmaThreads) {
      gather_rows<C>(strip, landed, freed, reinterpret_cast<const uint16_t*>(x), s,
                     S, sb.seq, first, last, threadIdx.x - kTmaThreads);
      return;
    }
    if (threadIdx.x != 128) return;  // the producer
    int stage = 0;
    uint32_t phase = 0;
    for (long long r = r_lo; r < r_hi; ++r) {
      for (int seg = 0; seg < s.segs; ++seg) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kGBox);
        tma_load(ring + stage * kGBox, &gmap, &full[stage], d0, sb.seq,
                 seg * kStemSeg, static_cast<int>(r));
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane % 4;
  if (!kGather) {
    for (long long rr = r_lo - 1; rr <= r_lo + 1; ++rr)
      if (rr >= 0 && rr < s.rows)
        strip_load(strip_slot(strip, s, rr, kSlots), x, s, rr, tid, 128);
    cp_async_commit();
  }
  const uint32_t ring_addr = smem_u32(ring), s_addr = smem_u32(stacked);
  float acc[kStemK / 2];
#pragma unroll
  for (int i = 0; i < kStemK / 2; ++i) acc[i] = 0.f;
  long long u = 0;  // units (row segments) so far
  int pending = -1;
  for (long long r = r_lo; r < r_hi; ++r) {
    const int h = static_cast<int>(r % s.H);
    if (kGather) {
      // every output row that reads row r - 2 is built (the last barrier
      // of row r - 1 passed): its slot is free; then rows up to r + 1 have
      // landed
      if (tid == 0 && r - 2 >= first) mbar_arrive(&freed[(r - 2) % kSlots]);
      for (long long rr = r == r_lo ? first : r + 1; rr <= r + 1 && rr <= last; ++rr)
        mbar_wait(&landed[rr % kSlots], static_cast<uint32_t>((rr - first) / kSlots) & 1);
    } else {
      // rows r - 1 .. r + 1 have landed; zero their halo columns
      cp_async_wait_all();
      named_sync(1, 128);
      if (tid < 3 * 2 * C) {
        const long long rr = r - 1 + tid / (2 * C);
        if (rr >= 0 && rr < s.rows)
          strip_halo(strip_slot(strip, s, rr, kSlots), s, rr, tid % (2 * C));
      }
      named_sync(1, 128);
      // the next row, into the slot of row r - 2
      if (r + 2 < s.rows && r + 2 <= r_hi)
        strip_load(strip_slot(strip, s, r + 2, kSlots), x, s, r + 2, tid, 128);
      cp_async_commit();
    }
    const uint8_t* const rows[3] = {tap_row(strip, zero_row, s, r, h, 0, kSlots),
                                    tap_row(strip, zero_row, s, r, h, 1, kSlots),
                                    tap_row(strip, zero_row, s, r, h, 2, kSlots)};
    for (int seg = 0; seg < s.segs; ++seg, ++u) {
      // tile u % 3 was last read by unit u - 3, done in every warp: each
      // passed wgmma_wait<1> after unit u - 2 before the last barrier
      const int tile = static_cast<int>(u % kSTiles);
      build_stacked<C>(stacked + tile * kSBytes, rows, seg * kStemSeg + tid, s.W, tid);
      fence_proxy_async();
      named_sync(1, 128);
      const int stage = static_cast<int>(u % kStages);
      mbar_wait(&full[stage], static_cast<uint32_t>(u / kStages) & 1);
      const uint32_t gs = ring_addr + stage * kGBox;
      const uint32_t ss = s_addr + tile * kSBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStemSeg / 16; ++kk) {
        // 16 pixels: G^T from the g box (channels contiguous, 128-byte
        // rows), S from the stacked tile (32 values, 64-byte rows)
        wgmma_bf16<kStemK, 1, 1>(acc, smem_desc(gs + kk * 16 * 128, 1024, 1),
                                 smem_desc(ss + kk * 16 * kStemRowBytes, 512, 2));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous unit's products are done
      fence_acc(acc);
      if (pending >= 0) release(&empty[pending], lane);
      pending = stage;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (pending >= 0) release(&empty[pending], lane);
  // accumulator element 4 j + 2 half + e: channel 16 warp + lane / 4 + 8
  // half, stacked row 8 j + 2 (lane % 4) + e
  constexpr int kRowsOut = 9 * C + 1;
  float* out = partial + (static_cast<long long>(sb.seq) * runs + bb) * kRowsOut * D;
#pragma unroll
  for (int j = 0; j < kStemK / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * j + 2 * q + e, d = d0 + 16 * warp + lane / 4 + 8 * half;
        if (k < kRowsOut && d < D) out[k * D + d] = acc[4 * j + 2 * half + e];
      }
}

// g as a 4-D map (D, S, W, N * H): a box of 64 channels x kStemSeg pixels
// of one row of sequence s, 128-byte swizzle, zero past W and past D.
template <int C, bool kGather>
int launch_tma(const void* x, const void* g, float* partial, float* out,
               const StemShape& s, int D, int S, int runs, cudaStream_t stream) {
  const int DT = (D + kStemTileD - 1) / kStemTileD;
  CUtensorMap gmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(s.W),
                              static_cast<cuuint64_t>(s.rows)};
  const cuuint32_t box[4] = {kStemTileD, 1, kStemSeg, 1};
  const int err = encode_bf16_map(&gmap, g, 4, dims, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  static SmemOnce smem_once;
  const int attr = smem_once.set(stem_wgrad_tma_kernel<C, kGather>, kSmemLimit);
  if (attr != 0) return attr;
  stem_wgrad_tma_kernel<C, kGather>
      <<<runs * DT * S, kGather ? kTmaThreads + kGatherThreads : kTmaThreads,
         tma_smem_bytes(s), stream>>>(gmap, static_cast<const uint8_t*>(x), partial,
                                      s, D, DT, S);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = (9 * C + 1) * D;
  stem_wgrad_reduce_kernel<<<dim3((n + 31) / 32, S), 32 * kReduceWarps, 0, stream>>>(
      partial, out, n, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The Hopper path, bound with ctypes. x (N, H, W, S * C) and g (N, H, W,
// S * D) contiguous bf16, S sequences (S = 1: one image), 1 <= C <= 3, D a
// multiple of 8; `runs` runs of image rows a 64-channel tile, at most 132 /
// ceil(D / 64) and at most N * H (ops/kernels/stem_wgrad.py `tma_plan` of
// one sequence's shape); partial (S, runs, 9 * C + 1, D) float32 scratch;
// out (S, 9 * C + 1, D) float32 as for the mma path; the shared memory
// (`tma_smem` there) within 227 KB; every base 16-byte aligned. Returns
// cudaGetLastError() after the two launches on `stream`, an error code of
// the tensor-map encoder, or cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int osvos_stem_wgrad_tma(const void* x, const void* g, void* partial,
                                    void* out, int N, int H, int W, int C, int D,
                                    int S, int runs, void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxC || D < 8 || D % 8 != 0 ||
      S < 1 || S > 65535 || !aligned(x) || !aligned(g) || !aligned(partial) ||
      !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StemShape s = stem_shape(N, H, W, C);
  const int DT = (D + kStemTileD - 1) / kStemTileD;
  if (runs < 1 || runs * DT > kNumSMs || runs > s.rows || s.rows > 0x7fffffffLL ||
      tma_smem_bytes(s) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  const bool gather = S > 1;  // one image: the consumers cp.async the strip
  switch (C) {
    case 1:
      return gather ? launch_tma<1, true>(x, g, part, o, s, D, S, runs, st)
                    : launch_tma<1, false>(x, g, part, o, s, D, S, runs, st);
    case 2:
      return gather ? launch_tma<2, true>(x, g, part, o, s, D, S, runs, st)
                    : launch_tma<2, false>(x, g, part, o, s, D, S, runs, st);
    default:
      return gather ? launch_tma<3, true>(x, g, part, o, s, D, S, runs, st)
                    : launch_tma<3, false>(x, g, part, o, s, D, S, runs, st);
  }
}

// The mma path, bound with ctypes. x (N, H, W, S * C) and g (N, H, W,
// S * D) contiguous bf16, S sequences (S = 1: one image), 1 <= C <= 3;
// partial (S, splits, 9 * C + 1, D) float32 scratch; out (S, 9 * C + 1, D)
// float32: rows t * C + c (t = 3 * kh + kw) are dK, row 9 * C is db.
// `per_block` segments of 64 pixels of one image row per split, with
// splits = ceil(N * H * ceil(W / 64) / per_block). Every base 16-byte
// aligned. Returns cudaGetLastError() after the two launches on `stream`,
// or cudaErrorInvalidValue for arguments it does not take.
extern "C" int osvos_stem_wgrad(const void* x, const void* g, void* partial,
                                void* out, int N, int H, int W, int C, int D,
                                int S, long long per_block, long long splits,
                                void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxC || D < 1 || S < 1 ||
      S > 65535 || per_block < 1 || !aligned(x) || !aligned(g) ||
      !aligned(partial) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int segs_w = (W + kTW - 1) / kTW;
  const long long segs = static_cast<long long>(N) * H * segs_w;
  if (splits != (segs + per_block - 1) / per_block || splits > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{N, H, W, C, D, segs_w, segs, per_block, 9 * C + 1, S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(g);
  float* part = static_cast<float*>(partial);
  const dim3 grid(static_cast<unsigned>(splits), (D + kTD - 1) / kTD, S);
  if (D % 8 == 0) {
    stem_wgrad_partial_kernel<true><<<grid, kThreads, 0, st>>>(xb, gb, part, s);
  } else {
    stem_wgrad_partial_kernel<false><<<grid, kThreads, 0, st>>>(xb, gb, part, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = s.rows * D;
  stem_wgrad_reduce_kernel<<<dim3((n + 31) / 32, S), 32 * kReduceWarps, 0, st>>>(
      part, static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
