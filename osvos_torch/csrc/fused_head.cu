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
// Design. The TPU kernel runs the interpolation as dense matrix products,
// which suits its matrix unit. Each row of those matrices has at most two
// nonzeros (the transposed conv's kernel is 2*factor long at stride factor),
// so here the same map is a 2x2 gather per scale per output pixel, with the
// two-tap tables built once on the host (osvos_torch/ops/kernels/
// fused_head.py). The sum keeps the order of (Uh . c) . Uw^T: first over the
// two source rows at both source columns, then over the two columns.
//
// Bound. Per output pixel the kernel writes 1 byte and reads about 1.3 bytes
// of contributions (4 B / 4 + 4 B / 16 + 4 B / 64 + 4 B / 256 from the four
// scales; the gathers' reuse between neighbours is served by L1/L2), so it
// is bound by memory, not arithmetic. At the serving batch of 4 frames of
// 480x854 that is about 3 MB of traffic, a few microseconds at the card's
// bandwidth, so the launch overhead dominates. One thread per output pixel,
// one byte stored per thread; wider stores come with the speed work.
//
// Rounding: rintf (round half to even, as torch.round and jnp.round) of an
// accurate expf; no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxScales = 4;
constexpr int kThreads = 128;

struct Scale {
  const float* c;        // (B, h, w) float32, contiguous
  const int2* row_idx;   // (H,) the two source rows of each output row
  const float2* row_w;   // (H,) their weights
  const int2* col_idx;   // (W,) the two source columns of each output column
  const float2* col_w;   // (W,) their weights
  int h, w;
};

struct Params {
  Scale s[kMaxScales];
  int n_scales;
  const float* bias;     // scalar, on the device
  unsigned char* out;    // (B, H, W)
  int H, W;
};

__global__ void __launch_bounds__(kThreads) tail_kernel(const Params p) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= p.W) return;

  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxScales; ++i) {
    if (i >= p.n_scales) break;
    const Scale& s = p.s[i];
    const int2 r = s.row_idx[y];
    const float2 rw = s.row_w[y];
    const int2 c = s.col_idx[x];
    const float2 cw = s.col_w[x];
    const float* frame = s.c + static_cast<size_t>(b) * s.h * s.w;
    const float* r0 = frame + static_cast<size_t>(r.x) * s.w;
    const float* r1 = frame + static_cast<size_t>(r.y) * s.w;
    // (Uh . c) at the two source columns ...
    const float t0 = rw.x * __ldg(r0 + c.x) + rw.y * __ldg(r1 + c.x);
    const float t1 = rw.x * __ldg(r0 + c.y) + rw.y * __ldg(r1 + c.y);
    // ... then . Uw^T over those columns.
    acc += t0 * cw.x + t1 * cw.y;
  }
  const float logit = acc + __ldg(p.bias);
  const float prob = 1.f / (1.f + expf(-logit));
  const float q = fminf(fmaxf(rintf(255.f * prob), 0.f), 255.f);
  p.out[(static_cast<size_t>(b) * p.H + y) * p.W + x] =
      static_cast<unsigned char>(q);
}

}  // namespace

// Plain C entry point, bound with ctypes. Scales past n_scales are ignored
// (their pointers may be null). Tables are (n_scales, H, 2) / (n_scales, W, 2)
// contiguous; the launch goes on `stream` and returns cudaGetLastError().
extern "C" int osvos_fused_head_tail_u8(
    const void* c0, const void* c1, const void* c2, const void* c3,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    int n_scales, const void* row_idx, const void* row_w,
    const void* col_idx, const void* col_w, const void* bias, void* out,
    int B, int H, int W, void* stream) {
  if (n_scales < 1 || n_scales > kMaxScales || B < 1 || H < 1 || W < 1 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* cs[kMaxScales] = {c0, c1, c2, c3};
  const int hs[kMaxScales] = {h0, h1, h2, h3};
  const int ws[kMaxScales] = {w0, w1, w2, w3};
  Params p{};
  for (int i = 0; i < n_scales; ++i) {
    p.s[i].c = static_cast<const float*>(cs[i]);
    p.s[i].row_idx = static_cast<const int2*>(row_idx) + static_cast<size_t>(i) * H;
    p.s[i].row_w = static_cast<const float2*>(row_w) + static_cast<size_t>(i) * H;
    p.s[i].col_idx = static_cast<const int2*>(col_idx) + static_cast<size_t>(i) * W;
    p.s[i].col_w = static_cast<const float2*>(col_w) + static_cast<size_t>(i) * W;
    p.s[i].h = hs[i];
    p.s[i].w = ws[i];
  }
  p.n_scales = n_scales;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<unsigned char*>(out);
  p.H = H;
  p.W = W;
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
