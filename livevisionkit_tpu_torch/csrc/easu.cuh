// The EASU core (FidelityFX-SR 1.0, FSR.cl:93-322) shared by the warp
// kernel (warp.cu) and the scale kernel (easu_scale.cu): the 12 taps
// around f = floor(sample), the direction/length terms of the four
// bilinear corners f, g, j, k, kernel shaping, the 12-tap weighting and the
// de-ring.  Its plain version is ops/easu._easu_core.
//
// Tap layout around the sample point (x right, y down):
//         b c
//       e f g h
//       i j k l
//         n o
//
// What bounds it on the H100 is arithmetic: ~430 f32 operations per output
// pixel and 27 per source pixel for its direction terms (two IEEE
// divisions).  When every output gathered its own taps it also recomputed
// four corners' terms and, for u8, made 36 int->float conversions (a
// quarter-rate pipe).  Both kernels therefore work on a block's source box
// staged in shared memory (`stage`): each source pixel is read from device
// memory once (a u8 frame with word-aligned rows four pixels of a plane a
// load) and converted once into a texel (a float, or a float4 of up to four
// channels), and its direction terms -- which depend on the luma cross
// around that pixel alone, not on the sample -- are computed once and
// shared by every output whose corner it is.  An output then does 12 texel
// and 4 term reads from shared memory (`easu_staged`).  A block whose
// samples spread over more source pixels than the box holds (a strong
// zoom-out or rotation) gathers from device memory instead (`easu_global`),
// with the same arithmetic.  (Measured on the H100: staging u8 by words
// instead of bytes saves ~1% of the 8-stream warp and nothing solo; the
// same words first copied into shared memory and interleaved after a
// barrier cost ~1%; a u8 texel packed into one 32-bit word of shared
// memory and unpacked per tap with byte permutes cost 5%.)

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Both kernels run 256-thread blocks of 32 x 8 threads.
constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kWarps = kThreadsX * kThreadsY / 32;

enum { B, C_, E, F, G, H_, I, J, K, L, N_, O };

// (dx, dy) of tap t (b c e f g h i j k l n o) relative to f; constants once
// the tap loops are unrolled.
__device__ __forceinline__ constexpr int tap_x(int t) {
  return t < 2 ? t : (t < 6 ? t - 3 : (t < 10 ? t - 7 : t - 10));
}
__device__ __forceinline__ constexpr int tap_y(int t) {
  return t < 2 ? -1 : (t < 6 ? 0 : (t < 10 ? 1 : 2));
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Where the EASU support of f = (x0, y0) lies inside a w x h image.
__device__ __forceinline__ bool easu_inside(int x0, int y0, int w, int h) {
  return x0 >= 1 && y0 >= 1 && x0 < w - 4 && y0 < h - 4;
}

// A source pixel's NC channels as one shared-memory texel: a float for one
// channel, a float4 for more, converted from u8 once when it is staged.
template <int NC>
using Texel = std::conditional_t<NC == 1, float, float4>;

template <int NC, typename T>
__device__ __forceinline__ Texel<NC> gather_texel(const T* p, size_t splane) {
  if constexpr (NC == 1) {
    return load(p);
  } else {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v.x = load(p);
    v.y = load(p + splane);
    if constexpr (NC > 2) v.z = load(p + 2 * splane);
    if constexpr (NC > 3) v.w = load(p + 3 * splane);
    return v;
  }
}

template <int NC>
__device__ __forceinline__ float channel(Texel<NC> v, int c) {
  if constexpr (NC == 1) {
    return v;
  } else {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
  }
}

// The 2x-luma (FSR.cl:286-297): 0.5*ch0 + ch1 + 0.5*ch2 for RGB/BGR,
// plane 0 otherwise.
template <int NC>
__device__ __forceinline__ float luma(const float (&v)[NC], int rgb_luma) {
  if constexpr (NC >= 3) {
    if (rgb_luma) return 0.5f * v[0] + v[1] + 0.5f * v[2];
  }
  return v[0];
}

// Direction/length terms of the luma cross around one source pixel
// (FSR.cl:132-176; a above, b left, c centre, d right, e below):
// (dx, dy, lenx + leny).  A bilinear corner adds them with its weight.
__device__ __forceinline__ float4 dir_terms(float la, float lb, float lc, float ld, float le) {
  const float dc = ld - lc, cb = lc - lb;
  float lenx = 1.0f / fmaxf(fmaxf(fabsf(dc), fabsf(cb)), 1e-20f);
  const float dx = ld - lb;
  lenx = fminf(fmaxf(fabsf(dx) * lenx, 0.0f), 1.0f);
  const float ec = le - lc, ca = lc - la;
  float leny = 1.0f / fmaxf(fmaxf(fabsf(ec), fabsf(ca)), 1e-20f);
  const float dy = le - la;
  leny = fminf(fmaxf(fabsf(dy) * leny, 0.0f), 1.0f);
  return make_float4(dx, dy, __fadd_rn(__fmul_rn(lenx, lenx), __fmul_rn(leny, leny)), 0.0f);
}

// EASU of the sample at fraction (ppx, ppy) past f, given the direction
// terms of the corners f, g, j, k and `tap(t, v)`, which fills v with tap
// t's channels: the bilinear blend of the terms, kernel shaping
// (FSR.cl:306-330), the 12 weighted taps (easu_tap, FSR.cl:100-127) and
// the de-ring into the min/max of the 4 nearest taps f, g, j, k.
template <int NC, typename Tap>
__device__ __forceinline__ void easu_resolve(const Tap& tap, float4 tf, float4 tg, float4 tj,
                                             float4 tk, float ppx, float ppy, float (&res)[NC]) {
  const float w_f = (1.0f - ppx) * (1.0f - ppy), w_g = ppx * (1.0f - ppy);
  const float w_j = (1.0f - ppx) * ppy, w_k = ppx * ppy;
  float dirx = tf.x * w_f, diry = tf.y * w_f, len = tf.z * w_f;
  dirx += tg.x * w_g;
  diry += tg.y * w_g;
  len += tg.z * w_g;
  dirx += tj.x * w_j;
  diry += tj.y * w_j;
  len += tj.z * w_j;
  dirx += tk.x * w_k;
  diry += tk.y * w_k;
  len += tk.z * w_k;

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

  float ac[NC], mi[NC], ma[NC];
  float aw = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) ac[c] = 0.0f;
#pragma unroll
  for (int t = 0; t < 12; ++t) {
    float v[NC];
    tap(t, v);
    const float offx = tap_x(t) - ppx, offy = tap_y(t) - ppy;
    const float vx = offx * dxx + offy * dyx;
    const float vy = offx * dxy + offy * dyy;
    const float d2 = fminf(vx * vx + vy * vy, clp);
    const float wt = 1.0f + d2 * (cw1 + d2 * (cw2 + d2 * (cw3 + d2 * cw4)));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ac[c] += v[c] * wt;
      if (t == F) {
        mi[c] = v[c];
        ma[c] = v[c];
      } else if (t == G || t == J || t == K) {
        mi[c] = fminf(mi[c], v[c]);
        ma[c] = fmaxf(ma[c], v[c]);
      }
    }
    aw += wt;
  }
  const float rcp = 1.0f / (fabsf(aw) > 1e-20f ? aw : 1e-20f);
#pragma unroll
  for (int c = 0; c < NC; ++c) res[c] = fminf(fmaxf(ac[c] * rcp, mi[c]), ma[c]);
}

// EASU at fraction (ppx, ppy) past f = (x0, y0) of the NC planes of src
// (splane elements apart), every tap gathered from device memory.  Every
// tap must lie inside the image: easu_inside(x0, y0, w, h).
template <int NC, typename T>
__device__ __forceinline__ void easu_global(const T* __restrict__ src, size_t splane, int w,
                                            int y0, int x0, float ppx, float ppy, int rgb_luma,
                                            float (&res)[NC]) {
  float px[12][NC], lum[12];
  const int base = y0 * w + x0;
#pragma unroll
  for (int t = 0; t < 12; ++t) {
    const int off = base + tap_y(t) * w + tap_x(t);
#pragma unroll
    for (int c = 0; c < NC; ++c) px[t][c] = load(src + c * splane + off);
    lum[t] = luma<NC>(px[t], rgb_luma);
  }
  easu_resolve<NC>(
      [&](int t, float (&v)[NC]) {
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = px[t][c];
      },
      dir_terms(lum[B], lum[E], lum[F], lum[G], lum[J]),
      dir_terms(lum[C_], lum[F], lum[G], lum[H_], lum[K]),
      dir_terms(lum[F], lum[I], lum[J], lum[K], lum[N_]),
      dir_terms(lum[G], lum[J], lum[K], lum[L], lum[O]), ppx, ppy, res);
}

// A block's source box in dynamic shared memory (kBytes of it): bh rows of
// bw texels with their luma, and the direction terms of the (bh - 2) x
// (bw - 2) pixels inside the box's one-pixel rim.  kCap bounds bw * bh.
template <int NC, int kCap>
struct Box {
  static constexpr size_t kBytes = kCap * (sizeof(float4) + sizeof(Texel<NC>) + sizeof(float));
  float4* terms;
  Texel<NC>* pix;
  float* lum;
  __device__ __forceinline__ explicit Box(unsigned char* smem)
      : terms(reinterpret_cast<float4*>(smem)),
        pix(reinterpret_cast<Texel<NC>*>(smem + kCap * sizeof(float4))),
        lum(reinterpret_cast<float*>(smem + kCap * (sizeof(float4) + sizeof(Texel<NC>)))) {}
};

// Let `kernel` take `bytes` of dynamic shared memory: with its static
// shared memory that may pass 48 KB only after this call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Block-wide bounds: the min of .x and .z and the max of .y and .w over
// the block's threads (an empty range has .x > .y).  Every thread of the
// block must call it; it ends synchronized.
__device__ __forceinline__ int4 block_bounds(int4 v, int4* red) {
  v.x = __reduce_min_sync(0xffffffffu, v.x);
  v.y = __reduce_max_sync(0xffffffffu, v.y);
  v.z = __reduce_min_sync(0xffffffffu, v.z);
  v.w = __reduce_max_sync(0xffffffffu, v.w);
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  int4 b = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    const int4 r = red[i];
    b = make_int4(min(b.x, r.x), max(b.y, r.y), min(b.z, r.z), max(b.w, r.w));
  }
  return b;
}

constexpr unsigned kThreads = kThreadsX * kThreadsY;

// Element i = tid + k * kThreads of a box with rows of n elements sits at
// row r, column c; each step moves (kThreads / n, kThreads % n) on, with no
// division in the loop.
struct BoxWalk {
  unsigned n, step_r, step_c, r, c;
  __device__ __forceinline__ BoxWalk(unsigned row_len, unsigned first)
      : n(row_len), step_r(kThreads / row_len), step_c(kThreads - step_r * row_len),
        r(first / row_len), c(first - r * row_len) {}
  __device__ __forceinline__ void next() {
    r += step_r;
    c += step_c;
    if (c >= n) c -= n, ++r;
  }
};

__device__ __forceinline__ unsigned thread_rank() {
  return threadIdx.y * kThreadsX + threadIdx.x;
}

template <int NC>
__device__ __forceinline__ void put_texel(Texel<NC>* pix, float* lum, unsigned i,
                                          const float (&ch)[NC], int rgb_luma) {
  if constexpr (NC == 1) {
    pix[i] = ch[0];
  } else {
    float4 v = make_float4(ch[0], ch[1], 0.0f, 0.0f);
    if constexpr (NC > 2) v.z = ch[2];
    if constexpr (NC > 3) v.w = ch[3];
    pix[i] = v;
  }
  lum[i] = luma<NC>(ch, rgb_luma);
}

// The box's texels and luma, one texel per source pixel, gathered one
// channel at a time.  Each thread starts all its loads before its first
// store, so a block waits on device memory once.
template <typename T, int NC, int kCap>
__device__ __forceinline__ void stage_texels(const Box<NC, kCap>& box, const T* __restrict__ src,
                                             size_t splane, int w, int oy, int ox, int bw,
                                             int bh, int rgb_luma) {
  constexpr int kPer = (kCap + kThreads - 1) / kThreads;
  const unsigned tid = thread_rank();
  BoxWalk p(bw, tid);
  Texel<NC> v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (p.r < static_cast<unsigned>(bh))
      v[k] = gather_texel<NC>(src + static_cast<size_t>(oy + p.r) * w + ox + p.c, splane);
    p.next();
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned i = tid + k * kThreads;
    if (i < static_cast<unsigned>(bw * bh)) {
      float ch[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) ch[j] = channel<NC>(v[k], j);
      put_texel<NC>(box.pix, box.lum, i, ch, rgb_luma);
    }
  }
}

// A u8 value as a float, exactly, with no int->float conversion: 2^23 + b
// built from its bits, less 2^23.
__device__ __forceinline__ float u8_to_float(unsigned b) {
  return __uint_as_float(0x4b000000u | b) - 8388608.0f;
}

// The same for a u8 frame whose rows are whole aligned 32-bit words: each
// thread loads whole words of the box's rows (four pixels of a plane a
// load) and writes their four texels.
template <int NC, int kCap>
__device__ __forceinline__ void stage_words(const Box<NC, kCap>& box,
                                            const uint8_t* __restrict__ src, size_t splane,
                                            int w, int oy, int ox, int bw, int bh,
                                            int rgb_luma) {
  // A row of bw >= 4 pixels spans at most (bw + 6) / 4 words and bw * bh <=
  // kCap, so a box has at most 5 kCap / 8 words a plane, which kPer loads a
  // thread cover.
  constexpr int kPer = (5 * kCap / 8 + kThreads - 1) / kThreads;
  const unsigned tid = thread_rank();
  const int q0 = ox >> 2, lead = ox & 3;
  const unsigned nq = ((ox + bw + 3) >> 2) - q0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(src) +
                          static_cast<size_t>(oy) * (w >> 2) + q0;
  BoxWalk p(nq, tid);
  uint32_t v[kPer][NC];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (p.r < static_cast<unsigned>(bh)) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        v[k][j] = __ldg(words + j * (splane >> 2) + static_cast<size_t>(p.r) * (w >> 2) + p.c);
    }
    p.next();
  }
  BoxWalk q(nq, tid);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (q.r < static_cast<unsigned>(bh)) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = static_cast<int>(q.c * 4) + b - lead;
        if (col >= 0 && col < bw) {
          float ch[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j) ch[j] = u8_to_float((v[k][j] >> (8 * b)) & 0xffu);
          put_texel<NC>(box.pix, box.lum, q.r * bw + col, ch, rgb_luma);
        }
      }
    }
    q.next();
  }
}

// Stage the source box [oy, oy + bh) x [ox, ox + bw), all inside the
// image, then its direction terms.  Every thread of the block must call it
// (the choice of loads is the same for the whole block); it ends
// synchronized.
template <typename T, int NC, int kCap>
__device__ __forceinline__ void stage(const Box<NC, kCap>& box, const T* __restrict__ src,
                                      size_t splane, int w, int oy, int ox, int bw, int bh,
                                      int rgb_luma) {
  bool by_words = false;
  if constexpr (std::is_same_v<T, uint8_t>) {
    by_words = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0;
    if (by_words) stage_words(box, src, splane, w, oy, ox, bw, bh, rgb_luma);
  }
  if (!by_words) stage_texels(box, src, splane, w, oy, ox, bw, bh, rgb_luma);
  __syncthreads();
  constexpr int kPer = (kCap + kThreads - 1) / kThreads;
  const unsigned n = bw - 2;
  BoxWalk p(n, thread_rank());
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (p.r < static_cast<unsigned>(bh - 2)) {
      const float* l = box.lum + (p.r + 1) * bw + p.c + 1;
      box.terms[p.r * n + p.c] = dir_terms(l[-bw], l[-1], l[0], l[1], l[bw]);
    }
    p.next();
  }
  __syncthreads();
}

// EASU at fraction (ppx, ppy) past f, which sits at (ly + 1, lx + 1) in a
// staged box of row length bw.
template <int NC, int kCap>
__device__ __forceinline__ void easu_staged(const Box<NC, kCap>& box, int bw, int ly, int lx,
                                            float ppx, float ppy, float (&res)[NC]) {
  const int tw = bw - 2;
  const float4* tt = box.terms + ly * tw + lx;
  const Texel<NC>* p = box.pix + (ly + 1) * bw + (lx + 1);
  easu_resolve<NC>(
      [&](int t, float (&v)[NC]) {
        const Texel<NC> texel = p[tap_y(t) * bw + tap_x(t)];
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = channel<NC>(texel, c);
      },
      tt[0], tt[1], tt[tw], tt[tw + 1], ppx, ppy, res);
}

}  // namespace
