// The deblocker's smoothing path (filters/deblocking.py) and the k x k
// median (ops/resample.median_blur): the hand-written Hopper kernels K8.
//
// Replaces no TPU kernel: the JAX package leaves the deblocker to XLA (its
// median is a selection network of dense ops, resample.median_select).
// The port's plain version is a dozen PyTorch passes over the frame and a
// `torch.median` over 25 stacked shifted copies of the pooled frame (a
// 155 MB stack at 4K and a generic radix select): ~5 ms of the 4K chain's
// ~12 ms step.  These kernels compute the same function in two launches.
//
// What bounds it: bytes.  At 3 x 2160 x 3840 f32 the deblocker must read
// the frame (99.5 MB) and write its output (99.5 MB); the two kernels read
// the frame twice and move ~6.4 MB of small maps besides, ~311 MB, 0.093
// ms at 3.35 TB/s.  The median is ~100 min/max operations on each of the
// 1.55 M pooled values, a few microseconds of the SMs.  So the design
// keeps every intermediate but the pooled frame and the keep map on chip:
//
//   deblock_reduce: a block takes a band of `block` rows of the frame
//     (edge-replicated up to whole blocks: the clamp is in the index, no
//     padded copy) and 256 columns, plane by plane, by 16-byte loads into
//     shared memory.  From it: each plane's scale x scale cell means (the
//     pooled frame, INTER_AREA) and the luma (plane 0, or the weighted
//     sum in ops/color.luma's order); then, a warp to a block, the block
//     mean, the mean |luma - block mean| over the block still on chip,
//     and keep = min(floor(255 m), L) / L.  Sums are taken in double, so
//     a mean carries one f32 rounding, whatever the order of its terms.
//   deblock_blend: a block takes 16 x 32 cells of the pooled frame, (16
//     scale) x (32 scale) output pixels.  It stages the cells its bilinear
//     stencil reads (one more on each side) plus the median's reflect-101
//     halo in shared memory, takes the median of each staged cell with the
//     selection network in registers (median_net.cuh), and for each pixel
//     the x scale and x block half-pixel, edge-clamped bilinear values in
//     F.interpolate(align_corners=False)'s arithmetic, keep forced to 1 on
//     the partial border blocks, and px * keep + smooth * (1 - keep)
//     rounded step by step as the plain version's separate passes are.
//     Rows move by 16-byte loads and streaming stores.
//
// median_kernel is the median alone, for resample.median_blur: a block
// stages a 16 x 64 output tile and its halo and takes each output's median
// by the same device function.  A median network's result is one of its
// inputs, so it equals torch.median bit for bit.
//
// S streams (the batched form, behind the ops' vmap rules) are S z-slices
// of each grid: each stream reads its frame at its own stream stride (0
// for a frame every stream shares).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "median_net.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMedRows = 16, kMedCols = 64;     // median_kernel's output tile
constexpr int kCellRows = 16, kCellCols = 32;   // deblock_blend's tile of cells
constexpr int kTileCols = 256;                  // deblock_reduce's columns, in pixels
constexpr int kMaxSmem = 232448;                // a block's shared memory on Hopper

// Reflect-101 of i into [0, n), for i in [-(n - 1), 2n - 2].
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// Median of the k x k window at `s` (row stride `stride`) of shared memory.
template <int K>
__device__ __forceinline__ float window_median(const float* s, int stride) {
  float v[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) v[dy * K + dx] = s[dy * stride + dx];
  lvk_median::Net<K * K>::run(v);
  return v[K * K / 2];
}

// One half-pixel, edge-clamped bilinear axis of an upsample from n samples
// by `scale` (the float32 1 / factor): F.interpolate(align_corners=False)'s
// source index, its two samples and weights.
struct Axis {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Axis bilinear_axis(int dst, float scale, int n) {
  float src = scale * (dst + 0.5f) - 0.5f;
  src = src < 0.0f ? 0.0f : src;
  Axis a;
  a.i0 = static_cast<int>(src);
  a.i1 = a.i0 + (a.i0 < n - 1 ? 1 : 0);
  a.l1 = src - a.i0;
  a.l0 = 1.0f - a.l1;
  return a;
}

// The plain upsample's interpolation of the four samples, in its order.
__device__ __forceinline__ float bilinear(const Axis& y, const Axis& x, float v00, float v01,
                                          float v10, float v11) {
  return y.l0 * (x.l0 * v00 + x.l1 * v01) + y.l1 * (x.l0 * v10 + x.l1 * v11);
}

// ---------------------------------------------------------------- median

template <int K>
__global__ void __launch_bounds__(kThreads)
    median_kernel(const float* __restrict__ src, float* __restrict__ out, int n_planes, int h,
                  int w) {
  constexpr int R = K / 2;
  constexpr int SH = kMedRows + 2 * R, SW = kMedCols + 2 * R;
  __shared__ float tile[SH][SW];
  const int y0 = blockIdx.y * kMedRows, x0 = blockIdx.x * kMedCols;
  const size_t plane = static_cast<size_t>(h) * w;
  for (int p = blockIdx.z; p < n_planes; p += gridDim.z) {
    const float* s = src + p * plane;
    for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
      const int ty = i / SW, tx = i % SW;
      const int y = reflect101(min(y0 - R + ty, h - 1 + R), h);
      const int x = reflect101(min(x0 - R + tx, w - 1 + R), w);
      tile[ty][tx] = __ldg(s + static_cast<size_t>(y) * w + x);
    }
    __syncthreads();
    const int tx = threadIdx.x % kMedCols, x = x0 + tx;
    for (int ty = threadIdx.x / kMedCols; ty < kMedRows; ty += kThreads / kMedCols) {
      const int y = y0 + ty;
      if (y < h && x < w)
        out[p * plane + static_cast<size_t>(y) * w + x] = window_median<K>(&tile[ty][tx], SW);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- deblock

struct Shape {
  int h, w;        // the frame
  int fh, fw;      // its whole blocks
  int sh, sw;      // the pooled frame: (h, w) padded to whole blocks, / scale
  int kh, kw;      // the keep map: blocks of the padded frame
  int block, scale, levels;
};

// Block band blockIdx.y of the frame, columns blockIdx.x * tw ..: the pooled
// cells of every plane into `small` and each block's keep into `keep`.
// Dynamic shared memory: 2 x block x tw floats (the plane, the luma).
template <int NC>
__global__ void __launch_bounds__(kThreads)
    deblock_reduce_kernel(const float* __restrict__ src, long long src_ss, Shape g, int tw,
                          bool weighted, float lw0, float lw1, float lw2, bool vec,
                          float* __restrict__ small, float* __restrict__ keep) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* luma = tile + g.block * tw;
  const int B = g.block, S = g.scale;
  const int y0 = blockIdx.y * B, x0 = blockIdx.x * tw;
  const int cols = min(tw, g.kw * B - x0);  // whole blocks of the padded frame
  const size_t plane = static_cast<size_t>(g.h) * g.w;
  src += blockIdx.z * src_ss;
  small += static_cast<size_t>(blockIdx.z) * NC * g.sh * g.sw;
  keep += static_cast<size_t>(blockIdx.z) * g.kh * g.kw;
  const float lw[3] = {lw0, lw1, lw2};
  const int ncy = B / S, ncx = cols / S;
  const float inv_cell = 1.0f / static_cast<float>(S * S);

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float* p = src + c * plane;
    const float wc = c < 3 ? lw[c] : 0.0f;
    if (vec) {  // w, block and tw multiples of 4: a quad is all inside or all past w
      const int quads = cols / 4;
      for (int i = threadIdx.x; i < B * quads; i += kThreads) {
        const int ty = i / quads, x = x0 + 4 * (i % quads);
        const float* row = p + static_cast<size_t>(min(y0 + ty, g.h - 1)) * g.w;
        const float4 q = x < g.w ? __ldg(reinterpret_cast<const float4*>(row + x))
                                 : make_float4(row[g.w - 1], row[g.w - 1], row[g.w - 1],
                                               row[g.w - 1]);
        float* t = tile + ty * tw + (x - x0);
        float* l = luma + ty * tw + (x - x0);
        *reinterpret_cast<float4*>(t) = q;
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c == 0)
            l[k] = weighted ? __fmul_rn(wc, qv[k]) : qv[k];
          else if (weighted && c < 3)
            l[k] = __fadd_rn(l[k], __fmul_rn(wc, qv[k]));
        }
      }
    } else {
      for (int i = threadIdx.x; i < B * cols; i += kThreads) {
        const int ty = i / cols, tx = i % cols;
        const float v = __ldg(p + static_cast<size_t>(min(y0 + ty, g.h - 1)) * g.w +
                              min(x0 + tx, g.w - 1));
        tile[ty * tw + tx] = v;
        float& l = luma[ty * tw + tx];
        if (c == 0)
          l = weighted ? __fmul_rn(wc, v) : v;
        else if (weighted && c < 3)
          l = __fadd_rn(l, __fmul_rn(wc, v));
      }
    }
    __syncthreads();
    float* out = small + static_cast<size_t>(c) * g.sh * g.sw;
    for (int i = threadIdx.x; i < ncy * ncx; i += kThreads) {
      const int cy = i / ncx, cx = i % ncx;
      const float* t = tile + cy * S * tw + cx * S;
      double sum = 0.0;
      for (int dy = 0; dy < S; ++dy)
        for (int dx = 0; dx < S; ++dx) sum += t[dy * tw + dx];
      out[static_cast<size_t>(blockIdx.y * ncy + cy) * g.sw + x0 / S + cx] =
          __fmul_rn(static_cast<float>(sum), inv_cell);
    }
    __syncthreads();
  }

  // A warp to a block: its mean, then the mean |luma - mean|, then keep.
  const int lane = threadIdx.x % 32, nb = cols / B;
  const float inv_block = 1.0f / static_cast<float>(B * B);
  for (int b = threadIdx.x / 32; b < nb; b += kThreads / 32) {
    const float* l = luma + b * B;
    double sum = 0.0;
    for (int e = lane; e < B * B; e += 32) sum += l[(e / B) * tw + e % B];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = __fmul_rn(static_cast<float>(sum), inv_block);
    double dev = 0.0;
    for (int e = lane; e < B * B; e += 32) dev += fabsf(__fsub_rn(l[(e / B) * tw + e % B], mean));
#pragma unroll
    for (int o = 16; o > 0; o /= 2) dev += __shfl_xor_sync(0xffffffffu, dev, o);
    if (lane == 0) {
      const float m = __fmul_rn(static_cast<float>(dev), inv_block);
      const float lv = static_cast<float>(g.levels);
      keep[static_cast<size_t>(blockIdx.y) * g.kw + x0 / B + b] =
          __fdiv_rn(fminf(floorf(__fmul_rn(m, 255.0f)), lv), lv);
    }
  }
}

// Cells blockIdx.y * 16 .., blockIdx.x * 32 .. of the pooled frame: their
// medians, then the output pixels they cover.
template <int NC, int K>
__global__ void __launch_bounds__(kThreads)
    deblock_blend_kernel(const float* __restrict__ src, long long src_ss,
                         const float* __restrict__ small, const float* __restrict__ keep, Shape g,
                         bool vec, float* __restrict__ out) {
  constexpr int R = K / 2;
  constexpr int MR = kCellRows + 2, MC = kCellCols + 2;  // cells my0 .. my0 + MR - 1
  constexpr int HR = MR + 2 * R, HC = MC + 2 * R;
  __shared__ float halo[NC][HR][HC];
  __shared__ float med[NC][MR][MC];
  const int my0 = blockIdx.y * kCellRows - 1, mx0 = blockIdx.x * kCellCols - 1;
  const size_t plane = static_cast<size_t>(g.h) * g.w, cells = static_cast<size_t>(g.sh) * g.sw;
  src += blockIdx.z * src_ss;
  out += static_cast<size_t>(blockIdx.z) * NC * plane;
  small += static_cast<size_t>(blockIdx.z) * NC * cells;
  keep += static_cast<size_t>(blockIdx.z) * g.kh * g.kw;

  for (int i = threadIdx.x; i < NC * HR * HC; i += kThreads) {
    const int c = i / (HR * HC), ty = i / HC % HR, tx = i % HC;
    const int y = reflect101(max(min(my0 - R + ty, g.sh - 1 + R), -R), g.sh);
    const int x = reflect101(max(min(mx0 - R + tx, g.sw - 1 + R), -R), g.sw);
    halo[c][ty][tx] = __ldg(small + c * cells + static_cast<size_t>(y) * g.sw + x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NC * MR * MC; i += kThreads) {
    const int c = i / (MR * MC), my = i / MC % MR, mx = i % MC;
    const int y = my0 + my, x = mx0 + mx;
    if (y >= 0 && y < g.sh && x >= 0 && x < g.sw)
      med[c][my][mx] = window_median<K>(&halo[c][my][mx], HC);
  }
  __syncthreads();

  const float up = 1.0f / static_cast<float>(g.scale), kup = 1.0f / static_cast<float>(g.block);
  const int th = kCellRows * g.scale, quads = kCellCols * g.scale / 4;
  const int y0 = (my0 + 1) * g.scale, x0 = (mx0 + 1) * g.scale;
  for (int i = threadIdx.x; i < th * quads; i += kThreads) {
    const int y = y0 + i / quads, xq = x0 + 4 * (i % quads);
    if (y >= g.h || xq >= g.w) continue;
    const Axis sy = bilinear_axis(y, up, g.sh), ky = bilinear_axis(y, kup, g.kh);
    const float* k0 = keep + static_cast<size_t>(ky.i0) * g.kw;
    const float* k1 = keep + static_cast<size_t>(ky.i1) * g.kw;
    float kv[4];
    Axis sx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = xq + k;
      const Axis kx = bilinear_axis(x, kup, g.kw);
      kv[k] = bilinear(ky, kx, __ldg(k0 + kx.i0), __ldg(k0 + kx.i1), __ldg(k1 + kx.i0),
                       __ldg(k1 + kx.i1));
      if (y >= g.fh || x >= g.fw) kv[k] = 1.0f;  // partial border blocks pass through
      sx[k] = bilinear_axis(x, up, g.sw);
      sx[k].i0 -= mx0;
      sx[k].i1 -= mx0;
    }
    const int r0 = sy.i0 - my0, r1 = sy.i1 - my0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* row = src + c * plane + static_cast<size_t>(y) * g.w;
      float* dst = out + c * plane + static_cast<size_t>(y) * g.w + xq;
      float px[4];
      if (vec) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + xq));
        px[0] = q.x, px[1] = q.y, px[2] = q.z, px[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) px[k] = xq + k < g.w ? __ldg(row + xq + k) : 0.0f;
      }
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float smooth = bilinear(sy, sx[k], med[c][r0][sx[k].i0], med[c][r0][sx[k].i1],
                                      med[c][r1][sx[k].i0], med[c][r1][sx[k].i1]);
        o[k] = __fadd_rn(__fmul_rn(px[k], kv[k]), __fmul_rn(smooth, __fsub_rn(1.0f, kv[k])));
      }
      if (vec) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (xq + k < g.w) __stcs(dst + k, o[k]);
      }
    }
  }
}

// One deblocker call: its operands and what the entry point derived.
struct Launch {
  const float* src;
  long long src_ss;
  int n_streams;
  Shape g;
  int tw;                       // deblock_reduce's columns: whole blocks, ~kTileCols
  bool weighted;                // luma as the weighted sum of planes 0..2
  float lw[3];                  // its weights
  bool vec_reduce, vec_blend;   // 16-byte rows
  float *small, *keep, *out;
  cudaStream_t stream;
};

template <int NC, int K>
int launch_deblock(const Launch& a) {
  const Shape& g = a.g;
  const size_t smem = 2 * sizeof(float) * g.block * a.tw;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        deblock_reduce_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 reduce_grid((g.kw * g.block + a.tw - 1) / a.tw, g.kh, a.n_streams);
  deblock_reduce_kernel<NC><<<reduce_grid, kThreads, smem, a.stream>>>(
      a.src, a.src_ss, g, a.tw, a.weighted, a.lw[0], a.lw[1], a.lw[2], a.vec_reduce, a.small,
      a.keep);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 blend_grid((g.sw + kCellCols - 1) / kCellCols, (g.sh + kCellRows - 1) / kCellRows,
                        a.n_streams);
  deblock_blend_kernel<NC, K><<<blend_grid, kThreads, 0, a.stream>>>(
      a.src, a.src_ss, a.small, a.keep, g, a.vec_blend, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_deblock_nc(int nc, const Launch& a) {
  switch (nc) {
    case 1: return launch_deblock<1, K>(a);
    case 2: return launch_deblock<2, K>(a);
    case 3: return launch_deblock<3, K>(a);
    default: return launch_deblock<4, K>(a);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The ksize x ksize median, reflect-101 borders, of n_planes contiguous
// (h, w) f32 planes of `src` into `out`.  ksize 3, 5 or 7, and h, w >
// ksize / 2.  Returns cudaGetLastError() after the launch.
extern "C" int lvk_median_blur(const void* src, void* out, int n_planes, int h, int w, int ksize,
                               void* stream) {
  const int r = ksize / 2;
  if (n_planes < 1 || h <= r || w <= r || (h + kMedRows - 1) / kMedRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kMedCols - 1) / kMedCols, (h + kMedRows - 1) / kMedRows,
                  n_planes < 65535 ? n_planes : 65535);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ksize) {
    case 3: median_kernel<3><<<grid, kThreads, 0, st>>>(s, o, n_planes, h, w); break;
    case 5: median_kernel<5><<<grid, kThreads, 0, st>>>(s, o, n_planes, h, w); break;
    case 7: median_kernel<7><<<grid, kThreads, 0, st>>>(s, o, n_planes, h, w); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deblocker on S frames of nc (h, w) f32 planes, each contiguous,
// src_ss elements apart (0: one frame shared by every stream), in two
// launches.  luma: 0 takes plane 0, 1 the sum lw0 p0 + lw1 p1 + lw2 p2 (nc
// >= 3).  small: (S, nc, sh, sw) and keep: (S, kh, kw) f32 scratch, out:
// (S, nc, h, w) f32, all contiguous, where kh, kw are the blocks of the
// frame padded to whole blocks and sh, sw its cells (block % scale == 0;
// sh, sw > ksize / 2; ksize 3, 5 or 7).  Returns the first CUDA error of
// the launches, or 0.
extern "C" int lvk_deblock(const void* src, long long src_ss, int n_streams, int nc, int h, int w,
                           int block, int scale, int ksize, int levels, int luma, float lw0,
                           float lw1, float lw2, void* small, void* keep, void* out,
                           void* stream) {
  Launch a;
  Shape& g = a.g;
  g.h = h, g.w = w, g.block = block, g.scale = scale, g.levels = levels;
  g.fh = h / block * block, g.fw = w / block * block;
  g.kh = (h + block - 1) / block, g.kw = (w + block - 1) / block;
  g.sh = g.kh * block / (scale > 0 ? scale : 1), g.sw = g.kw * block / (scale > 0 ? scale : 1);
  a.tw = block * (block < kTileCols ? kTileCols / block : 1);
  const int r = ksize / 2;
  if (nc < 1 || nc > 4 || h < 1 || w < 1 || block < 1 || scale < 1 || block % scale != 0 ||
      levels < 1 || (luma != 0 && nc < 3) || n_streams < 1 || n_streams > 65535 || g.sh <= r ||
      g.sw <= r || 2 * sizeof(float) * block * a.tw > kMaxSmem || g.kh > 65535 ||
      (g.sh + kCellRows - 1) / kCellRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.src = static_cast<const float*>(src);
  a.src_ss = src_ss;
  a.n_streams = n_streams;
  a.weighted = luma != 0;
  a.lw[0] = lw0, a.lw[1] = lw1, a.lw[2] = lw2;
  const bool vec_src = w % 4 == 0 && src_ss % 4 == 0 && aligned16(src);
  a.vec_reduce = vec_src && block % 4 == 0;
  a.vec_blend = vec_src && aligned16(out);
  a.small = static_cast<float*>(small);
  a.keep = static_cast<float*>(keep);
  a.out = static_cast<float*>(out);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (ksize) {
    case 3: return launch_deblock_nc<3>(nc, a);
    case 5: return launch_deblock_nc<5>(nc, a);
    case 7: return launch_deblock_nc<7>(nc, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
