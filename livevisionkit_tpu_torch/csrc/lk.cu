// Sparse pyramidal Lucas-Kanade over a whole pyramid in one launch: the
// hand-written Hopper kernel behind vision/optical_flow.track.
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/lk.py::lk_track (body
// _lk_pyramid_kernel) and, with n_levels = 1, lk_level (_lk_kernel).  The
// oracle is the XLA path's semantics, vision/optical_flow._track_level,
// whose plain PyTorch version sits beside the wrapper: per level, a
// (win+2)^2 template patch bilinearly sampled at the sub-pixel point with
// replicate-clamped taps, patch-local Scharr gradients, the 2x2 gradient
// matrix with min-eigenvalue rejection, then `iters` frozen-Jacobian
// Gauss-Newton steps that gather the search window from the next level
// directly, with a closed-form 2x2 solve.  Unlike the XLA path, the search
// window follows the iterate anywhere (no cached block, no drift clamp)
// and any window size whose patches fit in shared memory is taken.
//
// One warp per feature walks the levels coarse to fine; its lanes split
// the window pixels and meet in butterfly shuffles, which leave the same
// sums in every lane, so all lanes step the flow identically.  The work is
// a few KB of gathers per feature, bound by gather latency: the template
// and its gradients stay in shared memory across the iterations, and the
// pyramid (under 1 MB a frame) stays resident in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 4;

struct Levels {
  const float* img[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Bilinear sample of the pixel block starting at integer (bx, by) shifted
// by (fx, fy), taps clamped to the image (replicate border).
__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w,
                                        int bx, int by, float fx, float fy) {
  const int y0 = clampi(by, 0, h - 1), y1 = clampi(by + 1, 0, h - 1);
  const int x0 = clampi(bx, 0, w - 1), x1 = clampi(bx + 1, 0, w - 1);
  const float b00 = __ldg(img + y0 * w + x0), b01 = __ldg(img + y0 * w + x1);
  const float b10 = __ldg(img + y1 * w + x0), b11 = __ldg(img + y1 * w + x1);
  const float top = b00 + (b01 - b00) * fx;
  const float bot = b10 + (b11 - b10) * fx;
  return top + (bot - top) * fy;
}

__global__ void lk_kernel(Levels prev, Levels next, int n_levels,
                          const float* __restrict__ pts, const float* __restrict__ flow0,
                          float* __restrict__ flow_out, uint8_t* __restrict__ good_out,
                          int n, int win, int iters, float min_eig_thr) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fid = blockIdx.x * kWarpsPerBlock + warp;
  if (fid >= n) return;  // whole warps only; no block-wide barrier below
  const int area = win * win, bw = win + 2, r = win / 2;
  float* tmpl = smem + warp * (3 * area + bw * bw);
  float* gxs = tmpl + area;
  float* gys = gxs + area;
  float* bwin = gys + area;

  const float p0x = pts[2 * fid], p0y = pts[2 * fid + 1];
  const float scale_top = static_cast<float>(1 << (n_levels - 1));
  float gx = flow0[2 * fid] / scale_top, gy = flow0[2 * fid + 1] / scale_top;
  bool good = true;

  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    const float s = static_cast<float>(1 << lvl);
    const float px = p0x / s, py = p0y / s;
    const float* __restrict__ P = prev.img[lvl];
    const float* __restrict__ Q = next.img[lvl];
    const int h = prev.h[lvl], w = prev.w[lvl];

    // Template patch with a 1-px gradient halo.
    const float fpx = floorf(px), fpy = floorf(py);
    const int tbx = static_cast<int>(fpx) - r - 1, tby = static_cast<int>(fpy) - r - 1;
    const float tfx = px - fpx, tfy = py - fpy;
    for (int i = lane; i < bw * bw; i += 32)
      bwin[i] = sample(P, h, w, tbx + i % bw, tby + i / bw, tfx, tfy);
    __syncwarp();

    // Patch-local Scharr gradients (1/32 normalisation) and the gradient matrix.
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
    for (int i = lane; i < area; i += 32) {
      const int iy = i / win, ix = i % win;
      const float* b0 = bwin + iy * bw + ix;  // row iy, col ix of the halo patch
      const float* b1 = b0 + bw;
      const float* b2 = b1 + bw;
      const float sv0 = (3.0f * b0[0] + 10.0f * b1[0] + 3.0f * b2[0]) / 32.0f;
      const float sv2 = (3.0f * b0[2] + 10.0f * b1[2] + 3.0f * b2[2]) / 32.0f;
      const float ggx = sv2 - sv0;
      const float ggy =
          (3.0f * (b2[0] - b0[0]) + 10.0f * (b2[1] - b0[1]) + 3.0f * (b2[2] - b0[2])) / 32.0f;
      tmpl[i] = b1[1];
      gxs[i] = ggx;
      gys[i] = ggy;
      sxx += ggx * ggx;
      sxy += ggx * ggy;
      syy += ggy * ggy;
    }
    sxx = warp_sum(sxx);
    sxy = warp_sum(sxy);
    syy = warp_sum(syy);
    __syncwarp();
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    const float min_eig = (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f))) / 2.0f;
    good = good && (min_eig / area) >= min_eig_thr;
    const float inv_det = det > 1e-12f ? 1.0f / det : 0.0f;

    // Frozen-Jacobian Gauss-Newton, gathering the window from `next` directly.
    for (int it = 0; it < iters; ++it) {
      const float qx = px + gx, qy = py + gy;
      const float fqx = floorf(qx), fqy = floorf(qy);
      const int wbx = static_cast<int>(fqx) - r, wby = static_cast<int>(fqy) - r;
      const float wfx = qx - fqx, wfy = qy - fqy;
      float bx = 0.0f, by = 0.0f;
      for (int i = lane; i < area; i += 32) {
        const float warped = sample(Q, h, w, wbx + i % win, wby + i / win, wfx, wfy);
        const float rr = tmpl[i] - warped;
        bx += rr * gxs[i];
        by += rr * gys[i];
      }
      bx = warp_sum(bx);
      by = warp_sum(by);
      gx += (syy * bx - sxy * by) * inv_det;
      gy += (sxx * by - sxy * bx) * inv_det;
    }
    __syncwarp();  // bwin/tmpl are rewritten by the next level

    const float tx = px + gx, ty = py + gy;
    good = good && tx >= 0.0f && tx <= w - 1.0f && ty >= 0.0f && ty <= h - 1.0f;
    if (lvl > 0) {
      gx *= 2.0f;
      gy *= 2.0f;
    }
  }
  if (lane == 0) {
    flow_out[2 * fid] = gx;
    flow_out[2 * fid + 1] = gy;
    good_out[fid] = good ? 1 : 0;
  }
}

}  // namespace

// prev/next: n_levels device pointers to (hs[l], ws[l]) f32 levels, level 0
// first; pts, flow0, flow: (n, 2) f32 (x, y) at level-0 scale; good: (n,) u8.
// Returns cudaGetLastError() after the launch.
extern "C" int lvk_lk_track(const void* const* prev, const void* const* next, const int* hs,
                            const int* ws, int n_levels, const void* pts, const void* flow0,
                            void* flow, void* good, int n, int win, int iters,
                            float min_eig_thr, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels p, q;
  for (int l = 0; l < n_levels; ++l) {
    p.img[l] = static_cast<const float*>(prev[l]);
    q.img[l] = static_cast<const float*>(next[l]);
    p.h[l] = q.h[l] = hs[l];
    p.w[l] = q.w[l] = ws[l];
  }
  const size_t smem =
      sizeof(float) * kWarpsPerBlock * (3 * win * win + (win + 2) * (win + 2));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    lk_kernel<<<blocks, 32 * kWarpsPerBlock, smem, static_cast<cudaStream_t>(stream)>>>(
        p, q, n_levels, static_cast<const float*>(pts), static_cast<const float*>(flow0),
        static_cast<float*>(flow), static_cast<uint8_t*>(good), n, win, iters, min_eig_thr);
  }
  return static_cast<int>(cudaGetLastError());
}
