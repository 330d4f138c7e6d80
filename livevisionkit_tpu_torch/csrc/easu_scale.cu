// EASU resize of a planar f32 (C, H, W) frame to (C, OH, OW) (reference
// easu_scale, FSR.cl:324-358): the hand-written Hopper kernel behind
// ops/easu.easu_scale.
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/easu_scale.py::pallas_easu_up
// and, since it takes every ratio, the JAX package's XLA rational and
// fallback paths.  The oracle is ops/easu.easu_scale_plain, which this
// kernel matches borders included: the EASU core of easu.cuh where its
// 4x4 support is inside (1 <= x0 < w-4, 1 <= y0 < h-4), the nearest tap f
// elsewhere.
//
// One thread per output pixel computes all C channels.  It places its own
// sample from the per-axis ratio, exactly as the plain version does:
//  - rational (oh/h = py/qy, ow/w = px/qx, small-rational upscales): with
//    num = 2q*u + q - p, y0 = floor(num / 2p) and ppy = (num mod 2p) / 2p,
//    in integer arithmetic and one correctly rounded division;
//  - fallback (every other ratio): y = clip((u + 0.5) * (h/oh) - 0.5, 0,
//    h - 1) in f32, y0 = floor(y), ppy = y - y0, with each operation
//    rounded on its own (no fused multiply-add) so floor() sees the same y.
// No sample map is read and nothing is pasted afterwards; the TPU kernel's
// parity planes, permutation matmuls and border bands have no place here.

#include "easu.cuh"

namespace {

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

__global__ void easu_scale_kernel(const float* __restrict__ src, float* __restrict__ out, int nc,
                                  int h, int w, int oh, int ow, int rational, int py, int qy,
                                  int px, int qx, float sy, float sx, int rgb_luma) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  int y0, x0;
  float ppy, ppx;
  place(y, h, rational, py, qy, sy, y0, ppy);
  place(x, w, rational, px, qx, sx, x0, ppx);
  const size_t o = static_cast<size_t>(y) * ow + x;
  const size_t oplane = static_cast<size_t>(oh) * ow;
  const size_t splane = static_cast<size_t>(h) * w;

  if (!(x0 >= 1 && y0 >= 1 && x0 < w - 4 && y0 < h - 4)) {
    const size_t f = static_cast<size_t>(clampi(y0, 0, h - 1)) * w + clampi(x0, 0, w - 1);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= nc) break;
      out[c * oplane + o] = load(src + c * splane + f);
    }
    return;
  }
  float res[kMaxC];
  easu_filter(src, nc, splane, w, y0, x0, ppx, ppy, rgb_luma, res);
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= nc) break;
    out[c * oplane + o] = res[c];
  }
}

}  // namespace

// src: (nc, h, w) f32; out: (nc, oh, ow) f32.  nc <= 4.  rational picks the
// sample placement (py, qy, px, qx) over (sy, sx) = (h/oh, w/ow).  Returns
// cudaGetLastError() after the launch.
extern "C" int lvk_easu_scale(const void* src, void* out, int nc, int h, int w, int oh, int ow,
                              int rational, int py, int qy, int px, int qx, float sy, float sx,
                              int rgb_luma, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
  easu_scale_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), nc, h, w, oh, ow, rational, py,
      qy, px, qx, sy, sx, rgb_luma);
  return static_cast<int>(cudaGetLastError());
}
