// Fused-head tail of OSVOS inference: upsample + crop + sum + bias + sigmoid
// + uint8, for Hopper (sm_90a).
//
// Replaces the TPU kernel osvos_tpu/ops/pallas/fused_head.py `_tail_kernel`
// (launched by `fused_upsample_sigmoid_u8`). It computes, per frame b and
// output pixel (y, x),
//
//   out[b,y,x] = rint(255 * sigmoid(bias + sum_i (Uh_i . c_i[b] . Uw_i^T)[y,x]))
//
// where c_i is the (h_i, w_i) low-resolution contribution map of side branch
// i (factor 2^(i+1)) and Uh_i / Uw_i are the bilinear interpolation matrices
// with the center crop folded in.
//
// The TPU kernel runs the interpolation as dense matrix products, which suits
// its matrix unit. Each row of those matrices has at most two nonzeros (the
// transposed conv's kernel is 2*factor long at stride factor): output index
// o of an axis of n source values reads sources (o + top) / f - 1 and
// (o + top) / f that lie in [0, n), with the bilinear filter's weights,
// where top is the crop's offset. The kernel computes these taps itself
// (tap_of), as two_tap_table in osvos_torch/ops/kernels/fused_head.py
// states them; the map is then two two-tap passes per scale: for output row
// y the vertical blend v_i[c] = rw.x * c_i[r.x][c] + rw.y * c_i[r.y][c] of
// every source column c, then for output column x the two taps v_i[cx.x] *
// cw.x + v_i[cx.y] * cw.y, summed over the scales in order, the bias last.
// That is the order of (Uh . c) . Uw^T, value for value.
//
// Bound. Per output pixel the kernel writes 1 byte and reads about 1.3 bytes
// of contributions, 3.8 MB at the serving batch of 4 frames of 480x854: about
// 1.1 us at the card's bandwidth. At that size the work is latency and
// instruction issue, not bytes: what counts is how few round trips to
// memory a block waits on and how few instructions a pixel takes.
//
// Design.
// - A persistent grid, a block per SM (1024 threads), each block a run of
//   consecutive rows of the flat (B * H) output, taken in pieces of up to
//   `run` rows that lie in at most two frames (one piece at the serving
//   shape, where a block has 14 or 15 rows).
// - For a piece, the source rows each scale needs follow from the factor
//   and the crop: output row o reads source rows floor((o + top) / f) - 1
//   and floor((o + top) / f). So the block copies those rows (per scale and
//   frame one contiguous span of memory, about rows / f + 2 rows) into
//   shared memory by cp.async as soon as it starts, with no table to wait
//   for; each source row comes from L2 once per block, not once per output
//   row that reads it (3 MB in all at the serving shape instead of 12).
//   The taps are computed while the copies are in flight; values the whole
//   block shares (its run, the spans, the filter taps) are computed once,
//   by a few threads, not by every thread.
// - The vertical blend v[o][c] = rw.x * src[r.x][c] + rw.y * src[r.y][c] of
//   every output row of the piece and source column goes to shared memory
//   (thread t takes source column t, then t + 1024, ...); one barrier; then
//   thread t sums output column t (then t + 1024, ...) of every row of the
//   piece from its column taps, computed once per block into registers as
//   byte offsets into a row's blend buffer.
// - The scale count is a template parameter: the scale loops unroll fully.
// - A warp stores 32 consecutive bytes of a row: one full 32-byte sector per
//   store instruction. Wider stores would need several columns per thread
//   (more tap registers for fewer threads) or a staging pass with another
//   barrier, and issue no fewer instructions.
// Streaming a block's rows R at a time (one barrier per R rows, the next
// rows' source values in flight) is slower: each output row reads its
// source rows from L2 again, and each wait on them stalls the whole block.
//
// Rounding: rintf (round half to even, as torch.round and jnp.round) of an
// accurate expf; no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxScales = 4;
constexpr int kThreads = 1024;
constexpr int kMaxRun = 16;  // rows of a piece
constexpr int kMaxFactor = 16;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 224 * 1024;  // source rows and blends; row taps take the rest

struct Params {
  const float* c[kMaxScales];  // (B, h, w) float32, contiguous
  int h[kMaxScales], w[kMaxScales];
  int f[kMaxScales];      // upsampling factor
  int top_h[kMaxScales];  // the crop's first row of the full upsampled map
  int top_w[kMaxScales];  // and its first column
  // start of each scale's source row in a blend buffer; off[n_scales] is
  // the buffer's length
  int off[kMaxScales + 1];
  // start (in floats) of each scale's staged source rows in shared memory:
  // two spans (one per frame of the piece) of cap[i] rows of w[i] values
  int stage[kMaxScales + 1];
  int cap[kMaxScales];
  const float* bias;      // scalar, on the device
  unsigned char* out;     // (B, H, W)
  int H, W;
  int run;                // rows of a piece, at most kMaxRun
  long long rows;         // B * H
};

struct Tap {
  int2 i;
  float2 w;
};

// Tap k of the 1-D bilinear filter of length 2f, in double and then rounded,
// as ops/upsample.py's _bilinear_filter_1d computes it.
__device__ __forceinline__ float filt(int k, int f) {
  return static_cast<float>(1.0 - fabs(static_cast<double>(k) - (f - 0.5)) / f);
}

// Output index o's two taps on an axis of n source values at factor f and
// crop offset top, with filter taps k1d[0 .. 2f): sources (o + top) / f - 1
// and (o + top) / f that lie in [0, n), in order; a lone source repeats with
// weight 0.
__device__ __forceinline__ Tap tap_of(int o, int n, int f, int top,
                                      const float* k1d) {
  const int u = o + top;
  const int i1 = f & (f - 1) ? u / f : u >> (__ffs(f) - 1), i0 = i1 - 1;
  const bool in0 = i0 >= 0 && i0 < n, in1 = i1 < n;
  const float w0 = k1d[u - i0 * f], w1 = k1d[u - i1 * f];
  if (in0 && in1) return Tap{make_int2(i0, i1), make_float2(w0, w1)};
  if (in1) return Tap{make_int2(i1, i1), make_float2(w1, 0.f)};
  if (in0) return Tap{make_int2(i0, i0), make_float2(w0, 0.f)};
  return Tap{make_int2(0, 0), make_float2(0.f, 0.f)};
}

// A 4-byte copy from global to shared memory that completes asynchronously
// (cp.async); cp_async_wait_all() waits for this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ int scale_of(const Params& p, int j) {
  int s = 0;
#pragma unroll
  for (int i = 1; i < N; ++i) s += j >= p.off[i];
  return s;
}

// Output column x's taps, as byte offsets into a blend buffer.
template <int N>
__device__ __forceinline__ void col_taps(const Params& p, int x,
                                         const float (*k1d)[2 * kMaxFactor],
                                         int2 (&ci)[N], float2 (&cw)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const Tap t = tap_of(x, p.w[s], p.f[s], p.top_w[s], k1d[s]);
    ci[s] = make_int2(4 * (p.off[s] + t.i.x), 4 * (p.off[s] + t.i.y));
    cw[s] = t.w;
  }
}

// One output pixel from the row's blend buffer v: the column taps per scale,
// in order, then the bias, sigmoid and rounding.
template <int N>
__device__ __forceinline__ unsigned char pixel(const float* v,
                                               const int2 (&ci)[N],
                                               const float2 (&cw)[N],
                                               float bias) {
  const char* vb = reinterpret_cast<const char*>(v);
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const float t0 = *reinterpret_cast<const float*>(vb + ci[s].x);
    const float t1 = *reinterpret_cast<const float*>(vb + ci[s].y);
    acc += t0 * cw[s].x + t1 * cw[s].y;
  }
  const float logit = acc + bias;
  const float prob = 1.f / (1.f + expf(-logit));
  return static_cast<unsigned char>(
      fminf(fmaxf(rintf(255.f * prob), 0.f), 255.f));
}

// The source rows [lo, hi] of scale s that output rows [o0, o1] of a frame
// read (tap_of indexes no others).
__device__ __forceinline__ int2 span(const Params& p, int s, int o0, int o1) {
  return make_int2(max((o0 + p.top_h[s]) / p.f[s] - 1, 0),
                   min((o1 + p.top_h[s]) / p.f[s], p.h[s] - 1));
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    tail_kernel(const __grid_constant__ Params p) {
  // the staged source rows (p.stage), then run blend buffers of nsrc values
  extern __shared__ float smem[];
  // per row of a piece and scale: the offsets in smem of its two staged
  // source rows (as .i) and their weights
  __shared__ Tap taps[kMaxRun][N];
  __shared__ float k1d[N][2 * kMaxFactor];  // each scale's filter taps
  __shared__ int2 spans[N][2];              // each scale's staged rows, per frame
  __shared__ long long s_run[2];            // the block's rows [lo, hi)
  __shared__ int s_pos[2];                  // row lo's frame and row in it
  const int tid = threadIdx.x;
  const int nsrc = p.off[N];
  float* const vbuf = smem + p.stage[N];
  // One thread each finds the run and its start (64-bit divisions); others
  // build the filter taps.
  if (tid == 0) {
    const long long lo = p.rows * blockIdx.x / gridDim.x;
    s_run[0] = lo;
    s_pos[0] = static_cast<int>(lo / p.H);
    s_pos[1] = static_cast<int>(lo % p.H);
  } else if (tid == 32) {
    s_run[1] = p.rows * (blockIdx.x + 1) / gridDim.x;
  } else if (tid >= 64 && tid < 64 + N * 2 * kMaxFactor) {
    const int s = (tid - 64) / (2 * kMaxFactor), k = (tid - 64) % (2 * kMaxFactor);
    if (k < 2 * p.f[s]) k1d[s][k] = filt(k, p.f[s]);
  }
  __syncthreads();
  const long long lo = s_run[0], hi = s_run[1];
  if (lo >= hi) return;
  const float bias = __ldg(p.bias);
  int b0 = s_pos[0], y0 = s_pos[1];

  int2 ci[N];
  float2 cw[N];
  for (long long p0 = lo; p0 < hi;) {
    // The piece: rows p0 .. p1 - 1, of frame b0 from row y0, then (n1 rows)
    // of frame b0 + 1.
    long long p1 = p0 + p.run < hi ? p0 + p.run : hi;
    const long long frame_end = p0 - y0 + 2LL * p.H;
    if (p1 > frame_end) p1 = frame_end;
    const int rows = static_cast<int>(p1 - p0);
    const int n0 = min(rows, p.H - y0), n1 = rows - n0;
    if (tid < 2 * N) {
      const int s = tid / 2;
      spans[s][tid % 2] = tid % 2 == 0 ? span(p, s, y0, y0 + n0 - 1)
                                       : span(p, s, 0, n1 > 0 ? n1 - 1 : 0);
    }
    __syncthreads();
    // Copy each scale's staged rows.
#pragma unroll
    for (int s = 0; s < N; ++s) {
      for (int q = 0; q < (n1 > 0 ? 2 : 1); ++q) {
        const int2 sp = spans[s][q];
        const int count = (sp.y - sp.x + 1) * p.w[s];
        const float* src =
            p.c[s] + (static_cast<size_t>(b0 + q) * p.h[s] + sp.x) * p.w[s];
        float* dst = smem + p.stage[s] + q * p.cap[s] * p.w[s];
        for (int e = tid; e < count; e += kThreads) cp_async4(dst + e, src + e);
      }
    }
    // While the copies are in flight: this thread's column taps (once) and
    // the piece's row taps.
    if (p0 == lo && tid < p.W) col_taps<N>(p, tid, k1d, ci, cw);
    if (tid < rows * N) {
      const int r = tid / N, s = tid % N, q = r < n0 ? 0 : 1;
      const Tap t = tap_of(q == 0 ? y0 + r : r - n0, p.h[s], p.f[s], p.top_h[s], k1d[s]);
      const int first = p.stage[s] + q * p.cap[s] * p.w[s] - spans[s][q].x * p.w[s];
      taps[r][s] = Tap{make_int2(first + t.i.x * p.w[s], first + t.i.y * p.w[s]), t.w};
    }
    cp_async_wait_all();
    __syncthreads();
    // The vertical blend of every row of the piece.
    for (int j = tid; j < nsrc; j += kThreads) {
      const int s = scale_of<N>(p, j);
      const int c = j - p.off[s];
      for (int r = 0; r < rows; ++r) {
        const Tap t = taps[r][s];
        vbuf[r * nsrc + j] = t.w.x * smem[t.i.x + c] + t.w.y * smem[t.i.y + c];
      }
    }
    __syncthreads();
    unsigned char* orow = p.out + p0 * p.W;
    if (tid < p.W) {
      for (int r = 0; r < rows; ++r) {
        orow[static_cast<size_t>(r) * p.W + tid] = pixel<N>(vbuf + r * nsrc, ci, cw, bias);
      }
    }
    for (int x = tid + kThreads; x < p.W; x += kThreads) {
      int2 xi[N];
      float2 xw[N];
      col_taps<N>(p, x, k1d, xi, xw);
      for (int r = 0; r < rows; ++r) {
        orow[static_cast<size_t>(r) * p.W + x] = pixel<N>(vbuf + r * nsrc, xi, xw, bias);
      }
    }
    p0 = p1;
    if (n1 > 0) {
      b0 += 1;
      y0 = n1;
    } else {
      y0 += n0;
    }
    if (y0 == p.H) {
      y0 = 0;
      b0 += 1;
    }
    __syncthreads();  // the next piece reuses the staged rows and blends
  }
}

// Resident blocks of tail_kernel<N> per SM, times the SMs, per device;
// found once per device.
template <int N>
int grid_size(int device) {
  static int blocks[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_kernel<N>,
                                                      kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    blocks[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks[device];
}

// The piece length that lets the staged rows and blends fit in shared
// memory, and its layout; false if not even one row fits.
template <int N>
bool layout(Params& p, size_t& smem) {
  for (int run = kMaxRun; run >= 1; --run) {
    int stage = 0;
    for (int s = 0; s < N; ++s) {
      p.stage[s] = stage;
      p.cap[s] = (run - 1) / p.f[s] + 3;
      stage += 2 * p.cap[s] * p.w[s];
    }
    p.stage[N] = stage;
    smem = sizeof(float) * (static_cast<size_t>(stage) +
                            static_cast<size_t>(run) * p.off[N]);
    if (smem <= static_cast<size_t>(kMaxSmem)) {
      p.run = run;
      return true;
    }
  }
  return false;
}

template <int N>
int launch(Params p, cudaStream_t stream) {
  size_t smem = 0;
  if (!layout<N>(p, smem)) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = grid_size<N>(device);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tail_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = p.rows < blocks ? p.rows : blocks;
  tail_kernel<N><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Scales past n_scales are ignored
// (their pointers may be null). Scale i is upsampled by f_i and cropped from
// row top_h_i and column top_w_i of its full map. The launch goes on
// `stream` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int osvos_fused_head_tail_u8(
    const void* c0, const void* c1, const void* c2, const void* c3,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    int f0, int f1, int f2, int f3, int th0, int th1, int th2, int th3,
    int tw0, int tw1, int tw2, int tw3, int n_scales, const void* bias,
    void* out, int B, int H, int W, void* stream) {
  if (n_scales < 1 || n_scales > kMaxScales || B < 1 || H < 1 || W < 1 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* cs[kMaxScales] = {c0, c1, c2, c3};
  const int hs[kMaxScales] = {h0, h1, h2, h3};
  const int ws[kMaxScales] = {w0, w1, w2, w3};
  const int fs[kMaxScales] = {f0, f1, f2, f3};
  const int ths[kMaxScales] = {th0, th1, th2, th3};
  const int tws[kMaxScales] = {tw0, tw1, tw2, tw3};
  Params p{};
  int nsrc = 0;
  for (int i = 0; i < kMaxScales; ++i) {
    p.off[i] = nsrc;
    if (i < n_scales) {
      if (hs[i] < 1 || ws[i] < 1 || fs[i] < 1 || fs[i] > kMaxFactor ||
          ths[i] < 0 || tws[i] < 0 ||
          ths[i] + H > (hs[i] + 1) * fs[i] || tws[i] + W > (ws[i] + 1) * fs[i]) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      p.c[i] = static_cast<const float*>(cs[i]);
      p.h[i] = hs[i];
      p.w[i] = ws[i];
      p.f[i] = fs[i];
      p.top_h[i] = ths[i];
      p.top_w[i] = tws[i];
      nsrc += ws[i];
    }
  }
  p.off[kMaxScales] = nsrc;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<unsigned char*>(out);
  p.H = H;
  p.W = W;
  p.rows = static_cast<long long>(B) * H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_scales) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 3: return launch<3>(p, s);
    default: return launch<4>(p, s);
  }
}
