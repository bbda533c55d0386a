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
// Bound. Both kernels move each input byte once and do a few
// transcendentals per element, so they are bound by memory: stats reads 8 B
// per element, grad reads 8 B and writes 4 B. Loads are float4 where the
// addresses allow it. The TPU kernel pads to (rows, 128) tiles with a
// -1e30 logit and corrects the census afterwards; here each block masks its
// own ragged edge, so nothing is padded or corrected.
//
// Statistics, design. One cooperative launch over a persistent grid (as many
// blocks as the card holds at once, found once per device, or one per tile
// where there are fewer tiles). The grid walks a fixed list of (sample,
// chunk) tiles of kChunk elements, block g taking tiles g, g + grid, ...;
// a thread issues all kUnroll float4 pairs of x and z of a tile before it
// sums any. Both softplus forms share L = log1p(exp(-|x|)), so each
// element's term is max(z ? -x : x, 0) + L, chosen by select, and no warp
// runs both softplus paths. A row starts unaligned when n % 4 != 0: each
// tile takes the scalar head up to a 16-byte boundary, its float4 body,
// then its scalar tail. Each tile's partial goes to the tile's own slot;
// after one grid barrier (cooperative groups) warp w of the grid folds
// sample w's partials. Blocks of 512 threads halve the barrier's arrivals
// against 256 (255 tiles at the per-sample shape); the barrier's cost grows
// with the blocks that arrive at it.
//
// A "last block folds" ticket in place of the barrier would need its
// counters zeroed before any block counts: without a memset that is a grid
// barrier too, and one at the start costs more than one at the end (the
// barrier's fence waits on the loads in flight).
//
// Determinism. The statistics are reduced in a fixed order: each thread
// sums its elements in a fixed order, each block folds its threads through
// a fixed shuffle tree into the partial of its tile, and a sample's partials
// are folded in chunk order (lane l of one warp takes chunks l, l + 32, ...,
// then a fixed shuffle tree). No float atomics and no counter kept between
// calls, so two launches return the same bits, on any stream. Counts are
// integers, stored as float (exact below 2^24 elements, which the wrapper
// checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                          // float4 pairs a tile
constexpr int kMinBlocks = 2;  // resident blocks an SM must hold (64 registers)
constexpr long long kChunk = 4LL * kUnroll * kThreads;  // elements per tile
constexpr int kMaxDevices = 64;

// One element's count and terms: z = 1{label >= 0.5} and, with
// L = log1p(exp(-|x|)), softplus(-x) = max(-x, 0) + L to sp when z, and
// softplus(x) = max(x, 0) + L to sn otherwise.
__device__ __forceinline__ void add_one(float x, float label, int& cnt,
                                        float& sp, float& sn) {
  const bool pos = label >= 0.5f;
  const float t = fmaxf(pos ? -x : x, 0.f) + log1pf(expf(-fabsf(x)));
  cnt += pos;
  sp += pos ? t : 0.f;
  sn += pos ? 0.f : t;
}

// Fixed-order block reduction of (cnt, sp, sn); the result is valid in
// thread 0. Ends on a barrier, so that the block may reduce again.
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
  __syncthreads();
}

// Tile t: elements [lo, hi) of sample b, with chunks tiles a sample; a
// row's scalar head runs up to a 16-byte boundary, then n4 float4s, then a
// scalar tail of fewer than 4 elements.
struct Tile {
  long long b, lo, hi, body;
  int head, n4;
  __device__ Tile(const float* x, long long n, int chunks, long long t) {
    b = t / chunks;
    lo = (t - b * chunks) * kChunk;
    hi = lo + kChunk < n ? lo + kChunk : n;
    const long long mis = (reinterpret_cast<uintptr_t>(x + b * n + lo) / 4) % 4;
    head = static_cast<int>(mis ? 4 - mis : 0);
    if (head > hi - lo) head = static_cast<int>(hi - lo);
    body = lo + head;
    n4 = static_cast<int>((hi - body) / 4);
  }
};

// This thread's float4 pairs of a tile: float4 tid + u * kThreads of the
// tile's body.
struct Pairs {
  float4 x[kUnroll], z[kUnroll];
};

__device__ __forceinline__ void tile_load(const float* __restrict__ x,
                                          const float* __restrict__ z,
                                          long long n, const Tile& g,
                                          Pairs& l) {
  const float4* x4 = reinterpret_cast<const float4*>(x + g.b * n + g.body);
  const float4* z4 = reinterpret_cast<const float4*>(z + g.b * n + g.body);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < g.n4) {
      l.x[u] = __ldg(x4 + i);
      l.z[u] = __ldg(z4 + i);
    }
  }
}

// Sum this thread's elements of a tile (its float4 pairs in order, then its
// head element, thread < head, then its tail element, thread < the tail's
// length), fold the block's threads and write the tile's partial (count, -,
// sum_pos, sum_neg) to its slot.
__device__ __forceinline__ void tile_sum(const float* __restrict__ x,
                                         const float* __restrict__ z,
                                         long long n, const Tile& g,
                                         const Pairs& l, long long t,
                                         float4* partial) {
  const int tid = threadIdx.x;
  const float* xr = x + g.b * n;
  const float* zr = z + g.b * n;
  const bool has_head = tid < g.head;
  const long long tail = g.body + 4LL * g.n4 + tid;
  const bool has_tail = tail < g.hi;
  float hx = 0.f, hz = 0.f, tx = 0.f, tz = 0.f;
  if (has_head) {
    hx = __ldg(xr + g.lo + tid);
    hz = __ldg(zr + g.lo + tid);
  }
  if (has_tail) {
    tx = __ldg(xr + tail);
    tz = __ldg(zr + tail);
  }
  int cnt = 0;
  float sp = 0.f, sn = 0.f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (tid + u * kThreads < g.n4) {
      add_one(l.x[u].x, l.z[u].x, cnt, sp, sn);
      add_one(l.x[u].y, l.z[u].y, cnt, sp, sn);
      add_one(l.x[u].z, l.z[u].z, cnt, sp, sn);
      add_one(l.x[u].w, l.z[u].w, cnt, sp, sn);
    }
  }
  if (has_head) add_one(hx, hz, cnt, sp, sn);
  if (has_tail) add_one(tx, tz, cnt, sp, sn);
  block_reduce(cnt, sp, sn);
  if (tid == 0) partial[t] = make_float4(static_cast<float>(cnt), 0.f, sp, sn);
}

// One warp folds sample b's partials row[0 .. chunks) in chunk order into
// out = (n_pos, n_neg, sum_pos, sum_neg).
__device__ __forceinline__ void fold(const float4* row, int chunks, long long n,
                                     float4* out) {
  const int lane = threadIdx.x % 32;
  int cnt = 0;
  float sp = 0.f, sn = 0.f;
#pragma unroll 4
  for (int j = lane; j < chunks; j += 32) {
    const float4 v = __ldcg(row + j);
    cnt += static_cast<int>(v.x);
    sp += v.z;
    sn += v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sp += __shfl_down_sync(0xffffffffu, sp, off);
    sn += __shfl_down_sync(0xffffffffu, sn, off);
  }
  if (lane == 0) {
    *out = make_float4(static_cast<float>(cnt), static_cast<float>(n - cnt), sp,
                       sn);
  }
}

// Block g sums tiles g, g + grid, ... (tile t = (sample t / chunks, chunk
// t % chunks)), each into partial[t]. After the grid's barrier warp w of the
// grid folds sample w.
__global__ void __launch_bounds__(kThreads, kMinBlocks) stats_kernel(
    const float* __restrict__ x, const float* __restrict__ z,
    float4* __restrict__ partial, float4* __restrict__ out, long long n, int B,
    int chunks) {
  const long long tiles = static_cast<long long>(B) * chunks;
  Pairs l;
  long long t = blockIdx.x;
  if (t < tiles) tile_load(x, z, n, Tile(x, n, chunks, t), l);
  while (t < tiles) {
    tile_sum(x, z, n, Tile(x, n, chunks, t), l, t, partial);
    t += gridDim.x;
    if (t < tiles) tile_load(x, z, n, Tile(x, n, chunks, t), l);
  }
  cg::this_grid().sync();
  for (long long b = blockIdx.x * kWarps + threadIdx.x / 32; b < B;
       b += static_cast<long long>(gridDim.x) * kWarps) {
    fold(partial + b * chunks, chunks, n, out + b);
  }
}

// Blocks of stats_kernel the device holds at once, found once per device.
int resident_blocks(int device) {
  static int blocks[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stats_kernel,
                                                      kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    blocks[device] = sms * per_sm;
  }
  return blocks[device];
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
// float32 on the device with 16-byte aligned bases: x and z (B, n), out
// (B, 4), scratch the tiles' partials (B, chunks, 4), chunks =
// ceil(n / kChunk). Launches go on `stream`; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take). The statistics' cooperative launch fails if the device cannot hold
// its grid at once; it is never split.
extern "C" int osvos_cbbce_stats(const void* x, const void* z, void* scratch,
                                 void* out, long long n, int B, void* stream) {
  if (n < 1 || n >= (1LL << 24) || B < 1 || B > 65535 || !aligned16(x) ||
      !aligned16(z) || !aligned16(scratch) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = resident_blocks(device);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
  int chunks = static_cast<int>((n + kChunk - 1) / kChunk);
  const long long tiles = static_cast<long long>(B) * chunks;
  const unsigned grid =
      static_cast<unsigned>(tiles < resident ? tiles : resident);
  const float* xf = static_cast<const float*>(x);
  const float* zf = static_cast<const float*>(z);
  float4* pf = static_cast<float4*>(scratch);
  float4* of = static_cast<float4*>(out);
  void* args[] = {&xf, &zf, &pf, &of, &n, &B, &chunks};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(stats_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
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
