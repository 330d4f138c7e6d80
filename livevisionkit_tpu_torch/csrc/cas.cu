// CAS, AMD FidelityFX Contrast-Adaptive Sharpening (ffx_cas_mod.h:47-170,
// CAS_SLOW + CAS_BETTER_DIAGONALS), on a planar f32 (C, H, W) frame: the
// hand-written Hopper kernel behind ops/cas.cas (K9).
//
// Replaces no TPU kernel: the JAX package leaves livevisionkit_tpu/ops/
// cas.py to XLA, which fuses it into one pass; the port's plain version
// (ops/cas.cas_plain) is ~35 elementwise passes over the frame or strided
// views of its edge pad.  This kernel matches cas_plain bit for bit: the
// same f32 operations in the same order (the cross and box min/max trees
// as written, ((b + d) + f) + h, clamp(mx, 1e-6), 2 - mx), each rounded on
// its own (the __f*_rn intrinsics keep nvcc from fusing a multiply and an
// add), IEEE division and __fsqrt_rn; fminf/fmaxf are torch.minimum/
// maximum and clamp on finite inputs.
//
// What bounds it: memory traffic.  At 3x2160x3840 f32 the frame is read
// once and written once, ~199 MB, 0.059 ms at 3.35 TB/s; its ~35 f32
// operations a channel and pixel are ~0.9 G, ~0.013 ms at 67 TFLOP/s, and
// behind the bytes the issue of its two IEEE divisions and one square
// root a channel and pixel holds it.  Its design is K6's (csrc/rcas.cu):
// a register-blocked vector stencil.  A thread owns a strip of 4 adjacent
// pixels of a row in every channel and walks kRows rows down it, keeping
// the rows above, at and below the output row in registers.  A row is one
// 16-byte load a channel (4 scalar loads where the rows are not 16-byte
// aligned); the left and right neighbours, which are also the diagonals
// of the rows above and below, come from the adjacent lanes by warp
// shuffle, or one scalar load at a warp's edge.  Every pixel is filtered,
// the border included, against the edge-replicated neighbourhood: a row
// or column outside the frame reads the edge's (the reference's texture
// Load clamps), so no padded copy is made.  Each channel has its own
// weight (CAS_SLOW), so nothing is reduced across channels; rows go out
// by 16-byte streaming stores.  S streams (the batched form, behind
// ops/cas's vmap rule) are S z-slices of one grid: each stream reads its
// frame at its own stream stride (0 for a frame every stream shares) and
// writes its slice of the contiguous (S, C, H, W) output.  The 16-byte
// row path is chosen per launch, and only where every stream's planes
// start on 16 bytes.
//
// kRows = 2 and kWarps = 2 (64-thread blocks) measured best on the H100
// of kRows 1, 2, 4, 8 by kWarps 2, 4, 8, every variant bit-equal: 0.0941
// ms at 3x2160x3840 (63% of its byte bound; a torch.clone of the frame
// takes 0.0714) and 0.1750 ms over 8 streams of 3x1080x1920, against
// 0.0950-0.1066 and 0.1764-0.2009 ms for the other eleven.  One row a
// thread reads three rows for every output row; four or eight make fewer,
// longer threads, whose rows load one after another; eight warps a block
// were the slowest at every kRows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 4;  // adjacent pixels of a row a thread owns
constexpr int kRows = 2;   // rows a thread walks down its strip
constexpr int kWarps = 2;  // warps a block, one row band each

// A row of a thread's strip in one channel: its pixels and their left and
// right neighbours, edge-replicated.
struct Row {
  float l, v[kStrip], r;
};

// Row `row` (a (w,) plane row) at columns x0 .. x0 + 3 and their
// neighbours, each column clamped to [0, w - 1].  Every lane of the warp
// calls it; a lane past the right edge holds the edge pixel, which its
// left neighbour takes as its right one.
template <bool VEC>
__device__ __forceinline__ Row load_row(const float* __restrict__ row, int x0, int w, int lane) {
  Row o;
  if (VEC) {  // w is a multiple of 4: a strip lies wholly inside or outside
    if (x0 < w) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + x0));
      o.v[0] = q.x;
      o.v[1] = q.y;
      o.v[2] = q.z;
      o.v[3] = q.w;
    } else {
      const float edge = __ldg(row + w - 1);
#pragma unroll
      for (int k = 0; k < kStrip; ++k) o.v[k] = edge;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStrip; ++k) o.v[k] = __ldg(row + min(x0 + k, w - 1));
  }
  o.l = __shfl_up_sync(0xffffffffu, o.v[kStrip - 1], 1);
  o.r = __shfl_down_sync(0xffffffffu, o.v[0], 1);
  if (lane == 0) o.l = __ldg(row + max(min(x0 - 1, w - 1), 0));
  if (lane == 31) o.r = __ldg(row + min(x0 + kStrip, w - 1));
  return o;
}

// CAS of the pixel whose 3x3 neighbourhood is a b c / d e f / g h i, in
// ops/cas.cas_plain's order; `peak` is cas_peak(sharpness).
__device__ __forceinline__ float cas_pixel(float a, float b, float c, float d, float e, float f,
                                           float g, float h, float i, float peak) {
  // Soft min/max: cross, then the box (ffx_cas_mod.h:84-110).
  float mn = fminf(fminf(fminf(d, e), fminf(f, b)), h);
  const float mn2 = fminf(fminf(mn, fminf(a, c)), fminf(g, i));
  mn = __fadd_rn(mn, mn2);
  float mx = fmaxf(fmaxf(fmaxf(d, e), fmaxf(f, b)), h);
  const float mx2 = fmaxf(fmaxf(mx, fmaxf(a, c)), fmaxf(g, i));
  mx = __fadd_rn(mx, mx2);
  // amp = sqrt(saturate(min(mn, 2 - mx) / mx)) (:119-141).
  const float ratio = __fdiv_rn(fminf(mn, __fsub_rn(2.0f, mx)), fmaxf(mx, 1e-6f));
  const float amp = __fsqrt_rn(fminf(fmaxf(ratio, 0.0f), 1.0f));
  // Filter 0 w 0 / w 1 w / 0 w 0 (CAS_SLOW, :158-168).
  const float wt = __fmul_rn(amp, peak);
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(b, d), f), h);
  const float num = __fadd_rn(__fmul_rn(sum, wt), e);
  const float den = __fadd_rn(__fmul_rn(4.0f, wt), 1.0f);
  return fminf(fmaxf(__fdiv_rn(num, den), 0.0f), 1.0f);
}

template <int NC, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    cas_kernel(const float* __restrict__ src, float* __restrict__ out, long long src_ss, int h,
               int w, float peak) {
  const int lane = threadIdx.x;
  const int x0 = (blockIdx.x * 32 + lane) * kStrip;
  const int y0 = (blockIdx.y * kWarps + threadIdx.y) * kRows;
  if (y0 >= h) return;  // whole warps: threadIdx.y is the warp's
  const size_t plane = static_cast<size_t>(h) * w;
  src += blockIdx.z * src_ss;
  out += blockIdx.z * (plane * NC);
  Row up[NC], mid[NC], dn[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    up[c] = load_row<VEC>(src + c * plane + static_cast<size_t>(y0 > 0 ? y0 - 1 : 0) * w, x0, w,
                          lane);
    mid[c] = load_row<VEC>(src + c * plane + static_cast<size_t>(y0) * w, x0, w, lane);
  }
  const int y_end = y0 + kRows < h ? y0 + kRows : h;
  for (int y = y0; y < y_end; ++y) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dn[c] = load_row<VEC>(src + c * plane + static_cast<size_t>(y + 1 < h ? y + 1 : y) * w, x0,
                            w, lane);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const Row& U = up[c];
      const Row& M = mid[c];
      const Row& D = dn[c];
      float o[kStrip];
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        // Letters follow the reference's 3x3 grid (ffx_cas_mod.h:57-59).
        const float a = k == 0 ? U.l : U.v[k - 1], cc = k == kStrip - 1 ? U.r : U.v[k + 1];
        const float d = k == 0 ? M.l : M.v[k - 1], f = k == kStrip - 1 ? M.r : M.v[k + 1];
        const float g = k == 0 ? D.l : D.v[k - 1], i = k == kStrip - 1 ? D.r : D.v[k + 1];
        o[k] = cas_pixel(a, U.v[k], cc, d, M.v[k], f, g, D.v[k], i, peak);
      }
      float* dst = out + c * plane + static_cast<size_t>(y) * w + x0;
      if (VEC) {
        if (x0 < w) __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int k = 0; k < kStrip; ++k)
          if (x0 + k < w) __stcs(dst + k, o[k]);
      }
      up[c] = mid[c];
      mid[c] = dn[c];
    }
  }
}

template <int NC>
void launch(const float* src, float* out, int n_streams, long long src_ss, int h, int w,
            float peak, bool vec, cudaStream_t stream) {
  const dim3 block(32, kWarps);
  const dim3 grid((w + 32 * kStrip - 1) / (32 * kStrip),
                  (h + kWarps * kRows - 1) / (kWarps * kRows), n_streams);
  if (vec)
    cas_kernel<NC, true><<<grid, block, 0, stream>>>(src, out, src_ss, h, w, peak);
  else
    cas_kernel<NC, false><<<grid, block, 0, stream>>>(src, out, src_ss, h, w, peak);
}

}  // namespace

// src: S (nc, h, w) f32 frames, each contiguous, src_ss elements apart (0:
// one frame shared by every stream); out: contiguous (S, nc, h, w) f32;
// peak: ops/cas.cas_peak(sharpness).  nc <= 4, 1 <= S <= 65535.  Rows go
// by 16-byte loads and stores where every stream's planes start on 16
// bytes: w a multiple of 4, both buffers 16-byte aligned and src_ss a
// multiple of 4 (a shared frame's 0 is).  Returns cudaGetLastError()
// after the launch.
extern "C" int lvk_cas_batched(const void* src, void* out, int n_streams, long long src_ss,
                               int nc, int h, int w, float peak, void* stream) {
  if (nc < 1 || nc > 4 || h < 1 || w < 1 || n_streams < 1 || n_streams > 65535 ||
      (h + kWarps * kRows - 1) / (kWarps * kRows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  const bool vec = w % kStrip == 0 && src_ss % kStrip == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = n_streams;
  switch (nc) {
    case 1: launch<1>(s, o, n, src_ss, h, w, peak, vec, st); break;
    case 2: launch<2>(s, o, n, src_ss, h, w, peak, vec, st); break;
    case 3: launch<3>(s, o, n, src_ss, h, w, peak, vec, st); break;
    default: launch<4>(s, o, n, src_ss, h, w, peak, vec, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
