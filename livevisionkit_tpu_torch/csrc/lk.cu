// Sparse pyramidal Lucas-Kanade over a whole pyramid in one launch: the
// hand-written Hopper kernel behind vision/optical_flow.track.
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/lk.py::lk_track (body
// _lk_pyramid_kernel) and, with n_levels = 1, lk_level (_lk_kernel).  It
// tracks the features of S streams in one launch (the grid's y axis), each
// stream through its own pyramids: S = 1 is the solo call, S > 1 the
// torch.func.vmap rule of vision/optical_flow over a batch of streams.  The
// oracle is the XLA path's semantics, vision/optical_flow._track_level,
// whose plain PyTorch version sits beside the wrapper: per level, a
// (win+2)^2 template patch bilinearly sampled at the sub-pixel point with
// replicate-clamped taps, patch-local Scharr gradients, the 2x2 gradient
// matrix with min-eigenvalue rejection, then `iters` frozen-Jacobian
// Gauss-Newton steps that sample the search window from the next level,
// with a closed-form 2x2 solve.  Unlike the XLA path, the search window
// follows the iterate anywhere (no drift clamp) and any window size up to
// 31 is taken.
//
// What bounds it: latency.  A feature is a chain of 15 dependent
// Gauss-Newton steps over a few KB, so its time is the number and length
// of the steps along that chain, not bytes or operations.  One warp per
// feature (two warps a block, so 510 features make 255 blocks) walks the
// levels coarse to fine.  Per level it stages two boxes of texels in
// shared memory in one round trip: the (win+3)^2 template box of `prev`
// and a (win+1+2m)^2 search box of `next` around the level's starting
// iterate, each texel at replicate-clamped coordinates, so a tap read from
// a box is the tap the image gives.  A lane loads a fixed column of each
// box (coalesced along rows) into registers, all loads in flight before
// any store, and every loop over cells or window pixels has a
// compile-time bound and no branch: a cell outside a smaller box writes to
// a spare float, a lane's pixel past the window stands in for pixel 0 with
// zero weight.  (Measured on the H100 by tools/torch_kernels_ab.py: a
// guard per cell, which made the compiler issue the cells one after
// another, or 4-byte cp.async copies made the whole kernel 1.2-1.4x
// slower.)  The template patch, its Scharr gradients and every
// iteration's window are then sampled from shared memory with the plain
// version's arithmetic; the template and gradients of a lane's window
// pixels stay in registers.  An iterate whose window leaves the search
// box has the box staged again around it (the feature is counted in
// `restaged`), so the iterate may drift anywhere.  The lanes
// meet in butterfly shuffles (bx and by in one interleaved butterfly),
// which leave the same sums in every lane, so all lanes step the flow
// identically and every box decision is the warp's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxWindow = 31;
constexpr int kWarpsPerBlock = 2;
constexpr int kMargin = 4;       // m: px the iterate may drift in a level before a re-stage
constexpr int kMaxStaged = 48;   // texels a lane holds at once to stage both boxes in one trip

// Level l of stream s is the row-contiguous (h[l], w[l]) plane at
// img[l] + s * ss[l] (ss[l] = 0: one pyramid shared by every stream).
struct Levels {
  const float* img[kMaxLevels];
  long long ss[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(v) (v already floored) as an int, clamped to +-2^20 so that box
// arithmetic cannot overflow: every tap of a window that far out clamps to
// the same border texel, so the samples are those of the unclamped base.
__device__ __forceinline__ int floor_int(float v) {
  return static_cast<int>(fminf(fmaxf(v, -1048576.0f), 1048576.0f));
}

// 2^e for -126 <= e <= 127, exactly.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

__device__ __forceinline__ float lerp2(float b00, float b01, float b10, float b11, float fx,
                                       float fy) {
  const float top = b00 + (b01 - b00) * fx;
  const float bot = b10 + (b11 - b10) * fx;
  return top + (bot - top) * fy;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float sa = __shfl_xor_sync(0xffffffffu, a, m);
    const float sb = __shfl_xor_sync(0xffffffffu, b, m);
    a += sa;
    b += sb;
  }
}

__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float sa = __shfl_xor_sync(0xffffffffu, a, m);
    const float sb = __shfl_xor_sync(0xffffffffu, b, m);
    const float sc = __shfl_xor_sync(0xffffffffu, c, m);
    a += sa;
    b += sb;
    c += sc;
  }
}

// The largest window whose pixels KP a lane hold: win^2 <= 32 KP, up to 31.
__host__ __device__ constexpr int win_max(int kp) {
  int w = 1;
  while ((w + 1) * (w + 1) <= 32 * kp && w < kMaxWindow) ++w;
  return w;
}

// This lane's cells of an N x N grid: the lane keeps one column, the warp
// covering 16 columns by two rows a step where N <= 16, else 32 columns
// by one row (two column strips where N > 32).  A grid of n < N uses the
// cells with r, j < n; the others stand in with clamped reads and write
// to the warp's spare float, so no loop over cells branches: a branch per
// cell would make the compiler issue the cells one after another.
template <int N>
struct Cells {
  static constexpr int kCols = N <= 16 ? 16 : 32, kStep = 32 / kCols;
  static constexpr int kStrips = (N + kCols - 1) / kCols, kRows = (N + kStep - 1) / kStep;
  static constexpr int kSize = kStrips * kRows;
  __device__ static int col(int c, int lane) { return c / kRows * kCols + lane % kCols; }
  __device__ static int row(int c, int lane) { return c % kRows * kStep + lane / kCols; }
};

// Stage the n x n box (n <= N) of an (h, w) plane at (x0, y0), texel
// (r, j) = img[clamp(y0 + r)][clamp(x0 + j)], into smem[off + r * n + j]:
// `load` issues this lane's loads, all in flight at once, and `store`
// writes them (a cell outside the box to smem[spare]).
template <int N>
struct BoxTexels {
  float v[Cells<N>::kSize];

  __device__ __forceinline__ void load(const float* __restrict__ img, int x0, int y0, int h,
                                       int w, int lane) {
#pragma unroll
    for (int c = 0; c < Cells<N>::kSize; ++c)
      v[c] = __ldg(img + clampi(y0 + Cells<N>::row(c, lane), 0, h - 1) * w +
                   clampi(x0 + Cells<N>::col(c, lane), 0, w - 1));
  }

  __device__ __forceinline__ void store(float* smem, int off, int n, int spare, int lane) const {
#pragma unroll
    for (int c = 0; c < Cells<N>::kSize; ++c) {
      const int r = Cells<N>::row(c, lane), j = Cells<N>::col(c, lane);
      smem[r < n && j < n ? off + r * n + j : spare] = v[c];
    }
  }
};

// KP: window pixels a lane owns (lane + 32k, k < KP); win^2 <= 32 KP.
template <int KP>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    lk_kernel(Levels prev, Levels next, int n_levels, const float* __restrict__ pts,
              long long pts_ss, const float* __restrict__ flow0, long long flow0_ss,
              float* __restrict__ flow_out, uint8_t* __restrict__ good_out, int* restaged, int n,
              int win, int iters, float min_eig_thr) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fid = blockIdx.x * kWarpsPerBlock + warp;
  if (fid >= n) return;  // whole warps only; no block-wide barrier below
  const int stream = blockIdx.y;
  pts += stream * pts_ss;
  flow0 += stream * flow0_ss;
  const float p0x = pts[2 * fid], p0y = pts[2 * fid + 1];
  const float f0x = flow0[2 * fid], f0y = flow0[2 * fid + 1];
  flow_out += static_cast<size_t>(stream) * 2 * n;
  good_out += static_cast<size_t>(stream) * n;
  const int area = win * win, r = win / 2;
  const int bw = win + 2, tb = win + 3, sb = win + 1 + 2 * kMargin;
  constexpr int kBw = win_max(KP) + 2, kTb = kBw + 1, kSb = win_max(KP) + 1 + 2 * kMargin;
  // The warp's region of smem: the template box of prev, the search box of
  // next, the template patch with its halo, and one spare float.
  const int toff = warp * (tb * tb + sb * sb + bw * bw + 1), soff0 = toff + tb * tb;
  const int boff = soff0 + sb * sb, spare = boff + bw * bw;
  const float* tbox = smem + toff;
  const float* sbox = smem + soff0;
  float* bwin = smem + boff;

  // This lane's window pixels: row and column, and offset in the search box.
  int prow[KP], pcol[KP], soff[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int i = lane + 32 * k < area ? lane + 32 * k : 0;
    prow[k] = i / win;
    pcol[k] = i - prow[k] * win;
    soff[k] = prow[k] * sb + pcol[k];
  }

  // Scaling by a power of two is exact, so these products are the quotients.
  float gx = f0x * pow2(1 - n_levels), gy = f0y * pow2(1 - n_levels);
  bool good = true, left = false;

  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    const float px = p0x * pow2(-lvl), py = p0y * pow2(-lvl);
    const float* __restrict__ P = prev.img[lvl] + stream * prev.ss[lvl];
    const float* __restrict__ Q = next.img[lvl] + stream * next.ss[lvl];
    const int h = prev.h[lvl], w = prev.w[lvl];

    // Both boxes in one round trip: the template's texels and the search
    // box around the level's starting iterate.
    const float fpx = floorf(px), fpy = floorf(py);
    const float tfx = px - fpx, tfy = py - fpy;
    int sx0 = floor_int(floorf(px + gx)) - r - kMargin;
    int sy0 = floor_int(floorf(py + gy)) - r - kMargin;
    __syncwarp();  // the previous level's reads of the boxes are done
    if constexpr (Cells<kTb>::kSize + Cells<kSb>::kSize <= kMaxStaged) {
      BoxTexels<kTb> tt;
      BoxTexels<kSb> st;
      tt.load(P, floor_int(fpx) - r - 1, floor_int(fpy) - r - 1, h, w, lane);
      st.load(Q, sx0, sy0, h, w, lane);
      tt.store(smem, toff, tb, spare, lane);
      st.store(smem, soff0, sb, spare, lane);
    } else {  // large windows: one box, then the other
      BoxTexels<kTb> tt;
      tt.load(P, floor_int(fpx) - r - 1, floor_int(fpy) - r - 1, h, w, lane);
      tt.store(smem, toff, tb, spare, lane);
      BoxTexels<kSb> st;
      st.load(Q, sx0, sy0, h, w, lane);
      st.store(smem, soff0, sb, spare, lane);
    }
    __syncwarp();

    // Template patch with a 1-px gradient halo, bilinear from the box.
#pragma unroll
    for (int c = 0; c < Cells<kBw>::kSize; ++c) {
      const int y = Cells<kBw>::row(c, lane), x = Cells<kBw>::col(c, lane);
      const float* b = tbox + min(y, bw - 1) * tb + min(x, bw - 1);
      smem[y < bw && x < bw ? boff + y * bw + x : spare] =
          lerp2(b[0], b[1], b[tb], b[tb + 1], tfx, tfy);
    }
    __syncwarp();

    // Patch-local Scharr gradients (1/32 normalisation) and the gradient
    // matrix; the template and gradients of this lane's pixels in registers.
    float tmpl[KP], gxs[KP], gys[KP];
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const float* b0 = bwin + prow[k] * bw + pcol[k];  // row iy, col ix of the halo patch
      const float* b1 = b0 + bw;
      const float* b2 = b1 + bw;
      const float sv0 = (3.0f * b0[0] + 10.0f * b1[0] + 3.0f * b2[0]) / 32.0f;
      const float sv2 = (3.0f * b0[2] + 10.0f * b1[2] + 3.0f * b2[2]) / 32.0f;
      const bool in = lane + 32 * k < area;
      const float ggx = in ? sv2 - sv0 : 0.0f;
      const float ggy =
          in ? (3.0f * (b2[0] - b0[0]) + 10.0f * (b2[1] - b0[1]) + 3.0f * (b2[2] - b0[2])) / 32.0f
             : 0.0f;
      tmpl[k] = b1[1];
      gxs[k] = ggx;
      gys[k] = ggy;
      sxx += ggx * ggx;
      sxy += ggx * ggy;
      syy += ggy * ggy;
    }
    warp_sum3(sxx, sxy, syy);
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    const float min_eig = (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f))) / 2.0f;
    good = good && (min_eig / area) >= min_eig_thr;
    const float inv_det = det > 1e-12f ? 1.0f / det : 0.0f;

    // Frozen-Jacobian Gauss-Newton, each window sampled from the search box.
    for (int it = 0; it < iters; ++it) {
      const float qx = px + gx, qy = py + gy;
      const float fqx = floorf(qx), fqy = floorf(qy);
      const int wbx = floor_int(fqx) - r, wby = floor_int(fqy) - r;
      const float wfx = qx - fqx, wfy = qy - fqy;
      int ox = wbx - sx0, oy = wby - sy0;
      if (ox < 0 || oy < 0 || ox > 2 * kMargin || oy > 2 * kMargin) {
        // The window left the box: stage one around it (the warp's choice:
        // every lane holds the same iterate).
        left = true;
        sx0 = wbx - kMargin;
        sy0 = wby - kMargin;
        BoxTexels<kSb> st;
        st.load(Q, sx0, sy0, h, w, lane);
        __syncwarp();
        st.store(smem, soff0, sb, spare, lane);
        __syncwarp();
        ox = oy = kMargin;
      }
      const float* sw = sbox + oy * sb + ox;
      float bx = 0.0f, by = 0.0f;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const float* b = sw + soff[k];
        const float rr = tmpl[k] - lerp2(b[0], b[1], b[sb], b[sb + 1], wfx, wfy);
        bx += rr * gxs[k];
        by += rr * gys[k];
      }
      warp_sum2(bx, by);
      gx += (syy * bx - sxy * by) * inv_det;
      gy += (sxx * by - sxy * bx) * inv_det;
    }

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
    if (left && restaged != nullptr) atomicAdd(restaged, 1);
  }
}

using LkKernel = void (*)(Levels, Levels, int, const float*, long long, const float*, long long,
                          float*, uint8_t*, int*, int, int, int, float);

// The instance whose lanes hold win^2 window pixels.
LkKernel lk_for(int win) {
  const int area = win * win;
  if (area <= 32) return lk_kernel<1>;
  if (area <= 64) return lk_kernel<2>;
  if (area <= 128) return lk_kernel<4>;
  if (area <= 256) return lk_kernel<8>;
  if (area <= 512) return lk_kernel<16>;
  return lk_kernel<32>;
}

}  // namespace

// n_streams streams of n features.  prev/next: n_levels device pointers to
// (hs[l], ws[l]) f32 levels, level 0 first, stream s's plane at stream
// stride prev_ss[l] / next_ss[l] elements; pts, flow0: per stream (n, 2) f32
// (x, y) at level-0 scale, stream strides pts_ss / flow0_ss (0 = shared);
// flow: contiguous (n_streams, n, 2) f32; good: (n_streams, n) u8.
// restaged, when not null, is one device int to which the launch adds the
// features whose search window left its staged box at least once.  Returns
// cudaGetLastError() after the launch.
extern "C" int lvk_lk_track_counted(const void* const* prev, const void* const* next,
                                    const long long* prev_ss, const long long* next_ss,
                                    const int* hs, const int* ws, int n_levels, int n_streams,
                                    const void* pts, long long pts_ss, const void* flow0,
                                    long long flow0_ss, void* flow, void* good, int n, int win,
                                    int iters, float min_eig_thr, void* restaged, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_streams < 1 || n_streams > 65535 || win < 1 ||
      win > kMaxWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels p, q;
  for (int l = 0; l < n_levels; ++l) {
    p.img[l] = static_cast<const float*>(prev[l]);
    q.img[l] = static_cast<const float*>(next[l]);
    p.ss[l] = prev_ss[l];
    q.ss[l] = next_ss[l];
    p.h[l] = q.h[l] = hs[l];
    p.w[l] = q.w[l] = ws[l];
  }
  const int tb = win + 3, sb = win + 1 + 2 * kMargin, bw = win + 2;
  // At most 2 x 3,845 floats (win = 31): under the 48 KB a block takes
  // without an opt-in.
  const size_t smem = sizeof(float) * kWarpsPerBlock * (tb * tb + sb * sb + bw * bw + 1);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    const dim3 grid(blocks, n_streams);
    lk_for(win)<<<grid, 32 * kWarpsPerBlock, smem, static_cast<cudaStream_t>(stream)>>>(
        p, q, n_levels, static_cast<const float*>(pts), pts_ss, static_cast<const float*>(flow0),
        flow0_ss, static_cast<float*>(flow), static_cast<uint8_t*>(good),
        static_cast<int*>(restaged), n, win, iters, min_eig_thr);
  }
  return static_cast<int>(cudaGetLastError());
}
