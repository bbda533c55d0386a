// What the stem conv's two Hopper kernels share (csrc/stem.cu, B2's stem
// forward, and csrc/stem_wgrad.cu, B16's dK + db): the persistent schedule
// of image rows, the rolling strip of image rows in shared memory, the
// stacked 32-value row of a pixel, and the tensor map over a 64-channel
// NHWC tensor seen as rows of pixels.
//
// The image x (N, H, W, C <= 3) bf16 has 6-byte pixels, so an image row
// starts on a 2- or 4-byte boundary: TMA cannot describe it (a global
// stride must be a multiple of 16 bytes). A block keeps a ring of strip
// slots, one image row each. Row r arrives by 16-byte cp.async copies of
// the aligned chunks that cover its bytes, the last one reading only what
// lies inside the tensor; the slot keeps the chunks' alignment, so the row
// starts `lead` bytes into it. The pixel left and right of the row (the
// halo columns w = -1 and w = W, which the chunks fill with the
// neighbouring rows' bytes) are zeroed once the row has landed; a tap row
// outside the image reads a zero row written once. Moving to the next
// output row loads one new image row and drops the oldest, so x is read
// once (ops/kernels/stem_wgrad.py mirrors this arithmetic for the tests).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kStemMaxC = 3;
constexpr int kStemK = 32;                  // stacked values of a pixel
constexpr int kStemRowBytes = kStemK * 2;   // 64-byte rows, 64-byte swizzle
constexpr int kStemSeg = 128;               // pixels of a segment, one a thread
constexpr int kStemTileD = 64;              // channels of a 64-channel box
constexpr int kStemLead = 16;               // slot bytes before the first chunk

struct StemShape {
  int N, H, W, C;
  long long rows;         // N * H image rows
  long long row_bytes;    // W * C * 2
  long long total_bytes;  // rows * row_bytes
  int slot_bytes;         // a strip slot
  int segs;               // segments of an image row
};

inline StemShape stem_shape(int N, int H, int W, int C) {
  StemShape s;
  s.N = N;
  s.H = H;
  s.W = W;
  s.C = C;
  s.rows = static_cast<long long>(N) * H;
  s.row_bytes = 2LL * W * C;
  s.total_bytes = s.rows * s.row_bytes;
  s.slot_bytes = static_cast<int>((s.row_bytes + 64 + 15) / 16 * 16);
  s.segs = (W + kStemSeg - 1) / kStemSeg;
  return s;
}

// Block `b` of `blocks` takes the image rows [rows * b / blocks,
// rows * (b + 1) / blocks), in order.
__device__ __forceinline__ long long run_start(long long rows, int b, int blocks) {
  return rows * b / blocks;
}

// The 16-byte chunks of x that cover image row r: from the chunk that
// holds its first byte (a0) to the one that holds its last; the row's first
// pixel lands `lead` bytes into the slot.
struct RowWindow {
  long long a0;
  int chunks;
  int lead;
};

__device__ __forceinline__ RowWindow row_window(const StemShape& s, long long r) {
  const long long b0 = r * s.row_bytes;
  RowWindow w;
  w.a0 = b0 & ~15LL;
  w.chunks = static_cast<int>((b0 + s.row_bytes - w.a0 + 15) >> 4);
  w.lead = kStemLead + static_cast<int>(b0 & 15);
  return w;
}

// Start the copies of image row r into `slot`, thread `tid` of `threads`:
// no chunk reads past the tensor's end.
__device__ __forceinline__ void strip_load(uint8_t* slot, const uint8_t* x,
                                           const StemShape& s, long long r,
                                           int tid, int threads) {
  const RowWindow w = row_window(s, r);
  for (int i = tid; i < w.chunks; i += threads) {
    const long long src = w.a0 + 16LL * i;
    const long long inside = s.total_bytes - src;
    cp_async16(slot + kStemLead + 16 * i, x + src,
               inside < 16 ? static_cast<int>(inside) : 16);
  }
}

// Zero the halo columns of image row r in its slot: thread `tid` < 2 C
// takes one value, the left pixel's for tid < C.
__device__ __forceinline__ void strip_halo(uint8_t* slot, const StemShape& s,
                                           long long r, int tid) {
  const int lead = row_window(s, r).lead;
  if (tid < s.C) {
    reinterpret_cast<uint16_t*>(slot + lead)[tid - s.C] = 0;
  } else if (tid < 2 * s.C) {
    reinterpret_cast<uint16_t*>(slot + lead + s.row_bytes)[tid - s.C] = 0;
  }
}

// Where the ring of `slots` slots keeps image row r.
__device__ __forceinline__ uint8_t* strip_slot(uint8_t* strip, const StemShape& s,
                                               long long r, int slots) {
  return strip + (r % slots) * s.slot_bytes;
}

// Pixel 0 of the image row that tap row kh of output row r (image row h)
// reads: the strip's row r + kh - 1, or the zero row outside the image.
__device__ __forceinline__ const uint8_t* tap_row(uint8_t* strip,
                                                  const uint8_t* zero_row,
                                                  const StemShape& s, long long r,
                                                  int h, int kh, int slots) {
  const int hh = h + kh - 1;
  if (hh < 0 || hh >= s.H) return zero_row + kStemLead;
  const long long rr = r + kh - 1;
  return strip_slot(strip, s, rr, slots) + row_window(s, rr).lead;
}

// Byte offset of 16-byte chunk j (values 8 j .. 8 j + 7) of row p in a
// tile of 64-byte rows written with the 64-byte swizzle, as wgmma reads it.
__device__ __forceinline__ int swz64(int p, int j) {
  return p * kStemRowBytes + ((j ^ ((p >> 1) & 3)) << 4);
}

// The stacked row of pixel w (thread row p of the segment tile S): value
// t * C + c (t = 3 kh + kw) is x[h + kh - 1, w + kw - 1, c], read from the
// tap rows; value 9 C is 1 (B16's bias gradient); the rest are 0, and the
// whole row is 0 past the image row's end. One thread a pixel, the taps
// unrolled: no division per value.
template <int C>
__device__ __forceinline__ void build_stacked(uint8_t* S, const uint8_t* const (&rows)[3],
                                              int w, int W, int p) {
  uint32_t u[kStemK / 2];
#pragma unroll
  for (int i = 0; i < kStemK / 2; ++i) u[i] = 0u;
  if (w < W) {
    uint16_t v[kStemK];
#pragma unroll
    for (int k = 0; k < kStemK; ++k) v[k] = 0;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[(3 * kh + kw) * C + c] = *reinterpret_cast<const uint16_t*>(
              rows[kh] + ((w + kw - 1) * C + c) * 2);
    v[9 * C] = 0x3F80;  // bf16 1.0
#pragma unroll
    for (int i = 0; i < kStemK / 2; ++i)
      u[i] = static_cast<uint32_t>(v[2 * i]) | (static_cast<uint32_t>(v[2 * i + 1]) << 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(S + swz64(p, j)) =
        make_uint4(u[4 * j], u[4 * j + 1], u[4 * j + 2], u[4 * j + 3]);
}

// A bf16 map over the (N * H, W, D) rows of pixels of an NHWC tensor with
// D channels (D % 8 == 0), a box of 64 channels x `box_w` pixels x one
// row, 128-byte swizzle; `map_w` pixels a row (W: a box's pixels past the
// row's end are zero when loaded and not written when stored). Returns 0
// or an error code.
inline int encode_rows_map(CUtensorMap* map, const void* base, long long rows,
                           int W, int map_w, int D, int box_w) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(map_w),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {2ull * D, 2ull * D * W};
  const cuuint32_t box[3] = {kStemTileD, static_cast<cuuint32_t>(box_w), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

}  // namespace
