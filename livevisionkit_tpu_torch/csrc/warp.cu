// Backward warp of a planar (C, H, W) frame by an absolute (2, OH, OW)
// (y, x) sample map, with the 12-tap EASU filter (FSR.cl:362-403) or
// bilinear filtering: the hand-written Hopper kernel behind ops/remap.remap.
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/warp.py::pallas_remap (bodies
// _easu_kernel and _kernel).  The oracle is the plain version in
// ops/easu.easu_remap and ops/remap.bilinear_sample, which this kernel
// matches exactly, borders included: EASU where its 4x4 support is inside
// (1 <= x0 < w-4, 1 <= y0 < h-4), nearest inside that ring, fill outside.
//
// One thread per output pixel computes all C channels.  Taps are gathered
// straight from the source through the read-only cache; the TPU kernel's
// shift-select, mean-shift and separability machinery has no place on a
// GPU, which gathers natively.  A u8 source is filtered on its 0..255 scale
// (the scale the oracle's constants, e.g. 1/32768, are applied on) and the
// result is rounded half to even and clipped back to u8.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
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

template <typename T, bool kEasu>
__global__ void warp_kernel(const T* __restrict__ src, const float* __restrict__ smap,
                            T* __restrict__ out, int nc, int h, int w, int oh, int ow,
                            int has_fill, float fill, int rgb_luma) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const size_t o = static_cast<size_t>(y) * ow + x;
  const size_t oplane = static_cast<size_t>(oh) * ow;
  const size_t splane = static_cast<size_t>(h) * w;
  const float sy = smap[o];
  const float sx = smap[oplane + o];
  const float y0 = floorf(sy), x0 = floorf(sx);

  if (!kEasu) {
    const float wy = sy - y0, wx = sx - x0;
    const int y0i = clampi(static_cast<int>(y0), 0, h - 1);
    const int x0i = clampi(static_cast<int>(x0), 0, w - 1);
    const int y1i = min(y0i + 1, h - 1), x1i = min(x0i + 1, w - 1);
    const bool inside = sy >= 0.0f && sy <= h - 1.0f && sx >= 0.0f && sx <= w - 1.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= nc) break;
      const T* p = src + c * splane;
      float v00 = load(p + y0i * w + x0i), v01 = load(p + y0i * w + x1i);
      float v10 = load(p + y1i * w + x0i), v11 = load(p + y1i * w + x1i);
      float top = v00 + (v01 - v00) * wx;
      float bot = v10 + (v11 - v10) * wx;
      float v = top + (bot - top) * wy;
      if (has_fill && !inside) v = fill;
      store(out + c * oplane + o, v);
    }
    return;
  }

  const float ppy = sy - y0, ppx = sx - x0;
  const int y0i = static_cast<int>(y0), x0i = static_cast<int>(x0);
  const bool easu_ok = x0i >= 1 && y0i >= 1 && x0i < w - 4 && y0i < h - 4;
  const bool inside = x0i >= 0 && y0i >= 0 && x0i < w && y0i < h;
  if (!easu_ok) {
    // Nearest-neighbour ring just inside the border, fill outside (FSR.cl:385-397).
    const int yc = clampi(y0i, 0, h - 1), xc = clampi(x0i, 0, w - 1);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= nc) break;
      float v = (inside || !has_fill) ? load(src + c * splane + yc * w + xc) : fill;
      store(out + c * oplane + o, v);
    }
    return;
  }

  // Inside the EASU region every tap is in range: no clamping needed.
  float px[kMaxC][12];
  const int base = y0i * w + x0i;
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
    if (c >= nc) break;
    // De-ring: clip into the min/max of the 4 nearest taps f, g, j, k.
    const float mi4 = fminf(fminf(px[c][F], px[c][G]), fminf(px[c][J], px[c][K]));
    const float ma4 = fmaxf(fmaxf(px[c][F], px[c][G]), fmaxf(px[c][J], px[c][K]));
    store(out + c * oplane + o, fminf(fmaxf(ac[c] * rcp, mi4), ma4));
  }
}

template <typename T, bool kEasu>
void launch(const void* src, const float* smap, void* out, int nc, int h, int w, int oh,
            int ow, int has_fill, float fill, int rgb_luma, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
  warp_kernel<T, kEasu><<<grid, block, 0, stream>>>(
      static_cast<const T*>(src), smap, static_cast<T*>(out), nc, h, w, oh, ow, has_fill,
      fill, rgb_luma);
}

}  // namespace

// src: (nc, h, w) u8 or f32; smap: (2, oh, ow) f32; out: (nc, oh, ow) of the
// source dtype.  nc <= 4.  Returns cudaGetLastError() after the launch.
extern "C" int lvk_warp(const void* src, const void* smap, void* out, int nc, int h, int w,
                        int oh, int ow, int is_u8, int easu, int has_fill, float fill,
                        int rgb_luma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(smap);
  if (is_u8) {
    if (easu) launch<uint8_t, true>(src, m, out, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
    else launch<uint8_t, false>(src, m, out, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
  } else {
    if (easu) launch<float, true>(src, m, out, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
    else launch<float, false>(src, m, out, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
  }
  return static_cast<int>(cudaGetLastError());
}
