// EASU resize of a planar f32 (C, H, W) frame to (C, OH, OW) (reference
// easu_scale, FSR.cl:324-358): the hand-written Hopper kernel behind
// ops/easu.easu_scale.
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/easu_scale.py::pallas_easu_up
// and, since it takes every ratio, the JAX package's XLA rational and
// fallback paths.  The oracle is ops/easu.easu_scale_plain, which this
// kernel matches borders included: the EASU core of easu.cuh where its
// 4x4 support is inside (1 <= x0 < w-4, 1 <= y0 < h-4), the nearest tap f
// elsewhere.  No sample map is read and nothing is pasted afterwards; the
// TPU kernel's parity planes, permutation matmuls and border bands have no
// place here.
//
// What bounds it on the H100 is arithmetic: at 1080p -> 4K, ~430 f32
// operations for each of 8.3 M outputs and 27 for each source pixel's
// direction terms (about 54 us at the card's f32 rate) against 124 MB of
// traffic, 99.5 MB of it the output (about 37 us).
// At 2x each source quad is the f of four outputs, so per-output gathers
// and direction terms repeated the same work four times.  Its design: a
// block owns a 64 x 32 output tile (each thread eight outputs, 32 columns
// and 8 rows apart, so a warp's shared-memory reads stay on neighbouring
// texels), places the tile's columns and rows once, stages the source box
// of its samples and their per-source-pixel direction terms in shared
// memory (csrc/easu.cuh) and resolves each output from there.  A tile
// whose box exceeds kBoxCap (a strong downscale) gathers from device
// memory.  S streams (the batched form, behind ops/easu's vmap rule) are S
// z-slices of one grid, as K2 is K1's (csrc/warp.cu): each stream reads its
// source at its own stream stride (0 for a source every stream shares) and
// writes its slice of the contiguous (S, C, OH, OW) output; the streams
// share the placement, since shapes are static.  Placement, exactly as the
// plain version:
//  - rational (oh/h = py/qy, ow/w = px/qx, small-rational upscales): with
//    num = 2q*u + q - p, y0 = floor(num / 2p) and ppy = (num mod 2p) / 2p,
//    in integer arithmetic and one correctly rounded division;
//  - fallback (every other ratio): y = clip((u + 0.5) * (h/oh) - 0.5, 0,
//    h - 1) in f32, y0 = floor(y), ppy = y - y0, with each operation
//    rounded on its own (no fused multiply-add) so floor() sees the same y.

#include "easu.cuh"

namespace {

// A block's tile is 64 x 32 outputs: 8 a thread, 2 columns and 4 rows.
constexpr int kRows = 4;
constexpr int kTileW = 2 * kThreadsX, kTileH = kRows * kThreadsY;
// Source pixels a tile stages: 35 x 19 at 2x, 46 x 25 at 3/2, 51 x 27 at
// 4/3; a 0.5x downscale needs 131 x 67 and gathers from device memory.
// The box is 54 KB, so four blocks fit a multiprocessor.
constexpr int kBoxCap = 1536;

// Source index and fraction of output row (or column) u.
__device__ __forceinline__ void place(int u, int n_in, int rational, int p, int q, float scale,
                                      int& i0, float& frac) {
  if (rational) {
    const int num = 2 * q * u + q - p, den = 2 * p;
    i0 = num >= 0 ? num / den : -((den - 1 - num) / den);  // floor division
    frac = __fdiv_rn(static_cast<float>(num - i0 * den), static_cast<float>(den));
  } else {
    float y = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(u), 0.5f), scale), 0.5f);
    y = fminf(fmaxf(y, 0.0f), static_cast<float>(n_in - 1));
    const float y0 = floorf(y);
    i0 = static_cast<int>(y0);
    frac = __fsub_rn(y, y0);
  }
}

// Four blocks a multiprocessor (64 registers, a few bytes spilled) measured
// faster than three.
template <int NC>
__global__ void __launch_bounds__(kThreadsX * kThreadsY, 4)
    easu_scale_kernel(const float* __restrict__ src, float* __restrict__ out, long long src_ss,
                      int h, int w, int oh, int ow, int rational, int py, int qy, int px, int qx,
                      float sy, float sx, int rgb_luma) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Box<NC, kBoxCap> box(smem);
  __shared__ int col_x0[kTileW], row_y0[kTileH];
  __shared__ float col_pp[kTileW], row_pp[kTileH];
  __shared__ int4 red[kWarps];
  const size_t oplane = static_cast<size_t>(oh) * ow;
  const size_t splane = static_cast<size_t>(h) * w;
  src += blockIdx.z * src_ss;
  out += blockIdx.z * (oplane * NC);
  const int tile_x = blockIdx.x * kTileW, tile_y = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // Placement once per column and row of the tile.  The box spans the f of
  // the columns and rows whose taps are all inside, with the taps' rim.
  int4 b = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  if (tid < kTileW) {
    if (tile_x + tid < ow) {
      int i0;
      place(tile_x + tid, w, rational, px, qx, sx, i0, col_pp[tid]);
      col_x0[tid] = i0;
      if (i0 >= 1 && i0 < w - 4) b.x = b.y = i0;
    }
  } else if (tid < kTileW + kTileH) {
    const int r = tid - kTileW;
    if (tile_y + r < oh) {
      int i0;
      place(tile_y + r, h, rational, py, qy, sy, i0, row_pp[r]);
      row_y0[r] = i0;
      if (i0 >= 1 && i0 < h - 4) b.z = b.w = i0;
    }
  }
  b = block_bounds(b, red);  // also publishes the placements
  const bool any = b.x <= b.y && b.z <= b.w;
  const int bw = any ? b.y - b.x + 4 : 0, bh = any ? b.w - b.z + 4 : 0;
  const bool staged = any && static_cast<long long>(bw) * bh <= kBoxCap;
  if (staged) stage(box, src, splane, w, b.z - 1, b.x - 1, bw, bh, rgb_luma);

#pragma unroll 1
  for (int k = 0; k < 2 * kRows; ++k) {
    const int cx = threadIdx.x + kThreadsX * (k & 1), cy = threadIdx.y + kThreadsY * (k >> 1);
    const int x = tile_x + cx, y = tile_y + cy;
    if (x >= ow || y >= oh) continue;
    const int x0 = col_x0[cx], y0 = row_y0[cy];
    float* dst = out + static_cast<size_t>(y) * ow + x;
    if (!easu_inside(x0, y0, w, h)) {
      const size_t f = static_cast<size_t>(clampi(y0, 0, h - 1)) * w + clampi(x0, 0, w - 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) dst[c * oplane] = load(src + c * splane + f);
      continue;
    }
    float res[NC];
    if (staged) {
      easu_staged(box, bw, y0 - b.z, x0 - b.x, col_pp[cx], row_pp[cy], res);
    } else {
      easu_global<NC>(src, splane, w, y0, x0, col_pp[cx], row_pp[cy], rgb_luma, res);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[c * oplane] = res[c];
  }
}

template <int NC>
cudaError_t launch(const float* src, float* out, int n_streams, long long src_ss, int h, int w,
                   int oh, int ow, int rational, int py, int qy, int px, int qx, float sy,
                   float sx, int rgb_luma, cudaStream_t stream) {
  const size_t smem = Box<NC, kBoxCap>::kBytes;
  const cudaError_t e = allow_smem(easu_scale_kernel<NC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ow + kTileW - 1) / kTileW, (oh + kTileH - 1) / kTileH, n_streams);
  easu_scale_kernel<NC><<<grid, dim3(kThreadsX, kThreadsY), smem, stream>>>(
      src, out, src_ss, h, w, oh, ow, rational, py, qy, px, qx, sy, sx, rgb_luma);
  return cudaGetLastError();
}

}  // namespace

// src: S (nc, h, w) f32 sources, each contiguous, src_ss elements apart (0:
// one source shared by every stream); out: contiguous (S, nc, oh, ow) f32.
// 1 <= nc <= 4, 1 <= S <= 65535.  rational picks the sample placement (py,
// qy, px, qx) over (sy, sx) = (h/oh, w/ow).  Returns cudaGetLastError()
// after the launch.
extern "C" int lvk_easu_scale_batched(const void* src, void* out, int n_streams, long long src_ss,
                                      int nc, int h, int w, int oh, int ow, int rational, int py,
                                      int qy, int px, int qx, float sy, float sx, int rgb_luma,
                                      void* stream) {
  if (nc < 1 || nc > 4 || n_streams < 1 || n_streams > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = n_streams;
  const long long ss = src_ss;
  cudaError_t e;
  switch (nc) {
    case 1: e = launch<1>(s, o, n, ss, h, w, oh, ow, rational, py, qy, px, qx, sy, sx, rgb_luma, st); break;
    case 2: e = launch<2>(s, o, n, ss, h, w, oh, ow, rational, py, qy, px, qx, sy, sx, rgb_luma, st); break;
    case 3: e = launch<3>(s, o, n, ss, h, w, oh, ow, rational, py, qy, px, qx, sy, sx, rgb_luma, st); break;
    default: e = launch<4>(s, o, n, ss, h, w, oh, ow, rational, py, qy, px, qx, sy, sx, rgb_luma, st); break;
  }
  return static_cast<int>(e);
}

// One frame: the S = 1 launch.  src: (nc, h, w) f32; out: (nc, oh, ow) f32.
// The entry point that every version of the library exports
// (tools/torch_kernels_ab.py times versions by it).
extern "C" int lvk_easu_scale(const void* src, void* out, int nc, int h, int w, int oh, int ow,
                              int rational, int py, int qy, int px, int qx, float sy, float sx,
                              int rgb_luma, void* stream) {
  return lvk_easu_scale_batched(src, out, 1, 0, nc, h, w, oh, ow, rational, py, qy, px, qx, sy,
                                sx, rgb_luma, stream);
}
