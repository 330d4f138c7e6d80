// The EASU core (FidelityFX-SR 1.0, FSR.cl:93-322) shared by the warp
// kernel (warp.cu) and the scale kernel (easu_scale.cu): the 12 taps
// around f = floor(sample), the direction/length accumulation of the four
// bilinear corners, kernel shaping, the 12-tap weighting and the de-ring.
// Its plain version is ops/easu._easu_core.
//
// Tap layout around the sample point (x right, y down):
//         b c
//       e f g h
//       i j k l
//         n o

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 4;
// (dx, dy) of the taps b c e f g h i j k l n o relative to f = floor(sample).
__constant__ int kTapX[12] = {0, 1, -1, 0, 1, 2, -1, 0, 1, 2, 0, 1};
__constant__ int kTapY[12] = {-1, -1, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2};
enum { B, C_, E, F, G, H_, I, J, K, L, N_, O };

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Direction/length terms of one bilinear corner (FSR.cl:132-176).
__device__ __forceinline__ void accumulate(float& dirx, float& diry, float& len,
                                           float w, float la, float lb, float lc,
                                           float ld, float le) {
  float dc = ld - lc, cb = lc - lb;
  float lenx = 1.0f / fmaxf(fmaxf(fabsf(dc), fabsf(cb)), 1e-20f);
  float dx = ld - lb;
  lenx = fminf(fmaxf(fabsf(dx) * lenx, 0.0f), 1.0f);
  lenx = lenx * lenx;
  float ec = le - lc, ca = lc - la;
  float leny = 1.0f / fmaxf(fmaxf(fabsf(ec), fabsf(ca)), 1e-20f);
  float dy = le - la;
  leny = fminf(fmaxf(fabsf(dy) * leny, 0.0f), 1.0f);
  leny = leny * leny;
  dirx += dx * w;
  diry += dy * w;
  len += (lenx + leny) * w;
}

// EASU at fractional offset (ppx, ppy) from tap f = src[y0 * w + x0] of
// each of the nc planes (splane elements apart).  Every tap must lie inside
// the image: the caller checks 1 <= x0 < w-4, 1 <= y0 < h-4.  rgb_luma
// picks the luma 0.5*ch0 + ch1 + 0.5*ch2 (RGB/BGR) over plane 0.  Writes
// the de-ringed value of each channel to res[0..nc).
template <typename T>
__device__ __forceinline__ void easu_filter(const T* __restrict__ src, int nc, size_t splane,
                                            int w, int y0, int x0, float ppx, float ppy,
                                            int rgb_luma, float res[kMaxC]) {
  float px[kMaxC][12];
  const int base = y0 * w + x0;
#pragma unroll
  for (int t = 0; t < 12; ++t) {
    const int off = base + kTapY[t] * w + kTapX[t];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) px[c][t] = c < nc ? load(src + c * splane + off) : 0.0f;
  }
  float lum[12];
#pragma unroll
  for (int t = 0; t < 12; ++t)
    lum[t] = rgb_luma ? 0.5f * px[0][t] + px[1][t] + 0.5f * px[2][t] : px[0][t];

  float dirx = 0.0f, diry = 0.0f, len = 0.0f;
  accumulate(dirx, diry, len, (1.0f - ppx) * (1.0f - ppy), lum[B], lum[E], lum[F], lum[G], lum[J]);
  accumulate(dirx, diry, len, ppx * (1.0f - ppy), lum[C_], lum[F], lum[G], lum[H_], lum[K]);
  accumulate(dirx, diry, len, (1.0f - ppx) * ppy, lum[F], lum[I], lum[J], lum[K], lum[N_]);
  accumulate(dirx, diry, len, ppx * ppy, lum[G], lum[J], lum[K], lum[L], lum[O]);

  // Direction normalization + kernel shaping (FSR.cl:306-330).
  const float dir_r = dirx * dirx + diry * diry;
  const bool zro = dir_r < (1.0f / 32768.0f);
  const float inv_r = zro ? 1.0f : rsqrtf(fmaxf(dir_r, 1e-30f));
  dirx = (zro ? 1.0f : dirx) * inv_r;
  diry = (zro ? 0.0f : diry) * inv_r;
  len = len * 0.5f;
  len = len * len;
  const float stretch = (dirx * dirx + diry * diry) / fmaxf(fmaxf(fabsf(dirx), fabsf(diry)), 1e-20f);
  const float len2x = 1.0f + (stretch - 1.0f) * len;
  const float len2y = 1.0f - 0.5f * len;
  const float lob = 0.5f + ((1.0f / 4.0f - 0.04f) - 0.5f) * len;
  const float clp = 1.0f / lob;
  const float lob2 = lob * lob;
  const float cw1 = -1.25f - 2.0f * lob;
  const float cw2 = 0.25f + 2.5f * lob + lob2;
  const float cw3 = -0.5f * lob - 1.25f * lob2;
  const float cw4 = 0.25f * lob2;
  const float dxx = dirx * len2x, dyx = diry * len2x;
  const float dxy = -diry * len2y, dyy = dirx * len2y;

  // 12 weighted taps (easu_tap, FSR.cl:100-127).
  float ac[kMaxC] = {0.0f, 0.0f, 0.0f, 0.0f};
  float aw = 0.0f;
#pragma unroll
  for (int t = 0; t < 12; ++t) {
    const float offx = kTapX[t] - ppx, offy = kTapY[t] - ppy;
    const float vx = offx * dxx + offy * dyx;
    const float vy = offx * dxy + offy * dyy;
    const float d2 = fminf(vx * vx + vy * vy, clp);
    const float wt = 1.0f + d2 * (cw1 + d2 * (cw2 + d2 * (cw3 + d2 * cw4)));
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) ac[c] += px[c][t] * wt;
    aw += wt;
  }
  const float rcp = 1.0f / (fabsf(aw) > 1e-20f ? aw : 1e-20f);
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    // De-ring: clip into the min/max of the 4 nearest taps f, g, j, k.
    const float mi4 = fminf(fminf(px[c][F], px[c][G]), fminf(px[c][J], px[c][K]));
    const float ma4 = fmaxf(fmaxf(px[c][F], px[c][G]), fmaxf(px[c][J], px[c][K]));
    res[c] = fminf(fmaxf(ac[c] * rcp, mi4), ma4);
  }
}

}  // namespace
