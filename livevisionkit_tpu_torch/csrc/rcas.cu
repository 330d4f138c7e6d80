// RCAS, Robust Contrast-Adaptive Sharpening (FSR.cl:460-537), on a planar
// f32 (C, H, W) frame: the hand-written Hopper kernel behind ops/rcas.rcas.
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/rcas.py::pallas_rcas.  The
// oracle is ops/rcas.rcas_plain (the JAX package's XLA form), which this
// kernel matches bit for bit: the same operations in the same order, each
// rounded on its own (the __f*_rn intrinsics keep nvcc from fusing a
// multiply and an add) and IEEE division.  The TPU kernel's
// cross-multiplication tournament, which saves divisions there, is not
// carried over.
//
// What bounds it: memory traffic, each input and output element moved
// once (~200 MB at 3x2160x3840), and behind it the issue of the IEEE
// divisions (2 a channel and pixel, 1 a pixel).  Its design is a
// register-blocked vector stencil: a thread owns a strip of 4 adjacent
// pixels of a row in every channel and walks kRows rows down it, keeping
// the rows above, at and below the output row in registers.  A row is one
// 16-byte load a channel (4 scalar loads where the rows are not 16-byte
// aligned); the left and right neighbours come from the adjacent lanes by
// warp shuffle, or one scalar load at a warp's edge.  Per pixel it takes
// the per-channel limiters, reduces the lobe across channels in registers
// and writes every channel with 16-byte streaming stores; border pixels
// are copied in the same pass (FSR.cl:484-491).  kRows = 2 and a rolled
// row loop measured best on the H100: longer walks, a prefetched next row
// or an unrolled walk each hold more registers or more code and leave
// fewer bytes in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 4;  // adjacent pixels of a row a thread owns
constexpr int kRows = 2;   // rows a thread walks down its strip
constexpr int kWarps = 4;  // warps a block, one row band each

// A row of a thread's strip in one channel: its pixels and their left and
// right neighbours.
struct Row {
  float l, v[kStrip], r;
};

// Row `row` (a (w,) plane row) at columns x0 .. x0 + 3 and their
// neighbours; 0 where outside the row.  Every lane of the warp calls it.
template <bool VEC>
__device__ __forceinline__ Row load_row(const float* __restrict__ row, int x0, int w, int lane) {
  Row o;
  if (VEC) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (x0 < w) q = __ldg(reinterpret_cast<const float4*>(row + x0));
    o.v[0] = q.x;
    o.v[1] = q.y;
    o.v[2] = q.z;
    o.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kStrip; ++k) o.v[k] = x0 + k < w ? __ldg(row + x0 + k) : 0.0f;
  }
  o.l = __shfl_up_sync(0xffffffffu, o.v[kStrip - 1], 1);
  o.r = __shfl_down_sync(0xffffffffu, o.v[0], 1);
  if (lane == 0) o.l = x0 > 0 && x0 <= w ? __ldg(row + x0 - 1) : 0.0f;
  if (lane == 31) o.r = x0 + kStrip < w ? __ldg(row + x0 + kStrip) : 0.0f;
  return o;
}

template <int NC, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    rcas_kernel(const float* __restrict__ src, float* __restrict__ out, int h, int w,
                float sharpness) {
  const int lane = threadIdx.x;
  const int x0 = (blockIdx.x * 32 + lane) * kStrip;
  const int y0 = (blockIdx.y * kWarps + threadIdx.y) * kRows;
  if (y0 >= h) return;  // whole warps: threadIdx.y is the warp's
  const size_t plane = static_cast<size_t>(h) * w;
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
    float o[NC][kStrip];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      float sum[NC];
      float lobe = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float b = up[c].v[k], e = mid[c].v[k], hh = dn[c].v[k];
        const float d = k == 0 ? mid[c].l : mid[c].v[k - 1];
        const float f = k == kStrip - 1 ? mid[c].r : mid[c].v[k + 1];
        const float mn4 = fminf(fminf(b, d), fminf(f, hh));
        const float mx4 = fmaxf(fmaxf(b, d), fmaxf(f, hh));
        // Per-channel limiters (FSR.cl:515-526).
        const float hit_min = __fdiv_rn(fminf(mn4, e), __fmul_rn(4.0f, fmaxf(mx4, 1e-6f)));
        const float hit_max = __fdiv_rn(__fsub_rn(1.0f, fmaxf(mx4, e)),
                                        fminf(__fsub_rn(__fmul_rn(4.0f, mn4), 4.0f), -1e-6f));
        lobe = fmaxf(lobe, fmaxf(-hit_min, hit_max));
        sum[c] = __fadd_rn(__fadd_rn(__fadd_rn(b, d), f), hh);
      }
      // Worst case across channels, clamped to the stable range.
      lobe = __fmul_rn(fminf(fmaxf(lobe, -0.1875f), 0.0f), sharpness);
      const float rcp = __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(4.0f, lobe), 1.0f));
      const int x = x0 + k;
      const bool border = x == 0 || x >= w - 1 || y == 0 || y == h - 1;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        o[c][k] = border ? mid[c].v[k]
                         : __fmul_rn(__fadd_rn(__fmul_rn(sum[c], lobe), mid[c].v[k]), rcp);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* dst = out + c * plane + static_cast<size_t>(y) * w + x0;
      if (VEC) {
        if (x0 < w)
          __stcs(reinterpret_cast<float4*>(dst), make_float4(o[c][0], o[c][1], o[c][2], o[c][3]));
      } else {
#pragma unroll
        for (int k = 0; k < kStrip; ++k)
          if (x0 + k < w) __stcs(dst + k, o[c][k]);
      }
      up[c] = mid[c];
      mid[c] = dn[c];
    }
  }
}

template <int NC>
void launch(const float* src, float* out, int h, int w, float sharpness, bool vec,
            cudaStream_t stream) {
  const dim3 block(32, kWarps);
  const dim3 grid((w + 32 * kStrip - 1) / (32 * kStrip),
                  (h + kWarps * kRows - 1) / (kWarps * kRows));
  if (vec)
    rcas_kernel<NC, true><<<grid, block, 0, stream>>>(src, out, h, w, sharpness);
  else
    rcas_kernel<NC, false><<<grid, block, 0, stream>>>(src, out, h, w, sharpness);
}

}  // namespace

// src, out: (nc, h, w) f32, nc <= 4.  Rows go by 16-byte loads and stores
// where w is a multiple of 4 and both buffers are 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int lvk_rcas(const void* src, void* out, int nc, int h, int w, float sharpness,
                        void* stream) {
  if (nc < 1 || nc > 4 || h < 1 || w < 1 || (h + kWarps * kRows - 1) / (kWarps * kRows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  const bool vec = w % kStrip == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1: launch<1>(s, o, h, w, sharpness, vec, st); break;
    case 2: launch<2>(s, o, h, w, sharpness, vec, st); break;
    case 3: launch<3>(s, o, h, w, sharpness, vec, st); break;
    default: launch<4>(s, o, h, w, sharpness, vec, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
