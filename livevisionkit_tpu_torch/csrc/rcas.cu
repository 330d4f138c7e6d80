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
// One thread per pixel reads the cross b (above), d (left), f (right),
// h (below) around e for every channel, takes the per-channel limiters,
// reduces the lobe across channels in registers and writes every channel.
// Border pixels are copied (FSR.cl:484-491).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxC = 4;

__global__ void rcas_kernel(const float* __restrict__ src, float* __restrict__ out, int nc, int h,
                            int w, float sharpness) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t o = static_cast<size_t>(y) * w + x;
  if (x == 0 || y == 0 || x == w - 1 || y == h - 1) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= nc) break;
      out[c * plane + o] = __ldg(src + c * plane + o);
    }
    return;
  }

  float sum[kMaxC], ctr[kMaxC];
  float lobe = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= nc) break;
    const float* p = src + c * plane + o;
    const float b = __ldg(p - w), d = __ldg(p - 1), e = __ldg(p), f = __ldg(p + 1),
                hh = __ldg(p + w);
    const float mn4 = fminf(fminf(b, d), fminf(f, hh));
    const float mx4 = fmaxf(fmaxf(b, d), fmaxf(f, hh));
    // Per-channel limiters (FSR.cl:515-526).
    const float hit_min = __fdiv_rn(fminf(mn4, e), __fmul_rn(4.0f, fmaxf(mx4, 1e-6f)));
    const float hit_max = __fdiv_rn(__fsub_rn(1.0f, fmaxf(mx4, e)),
                                    fminf(__fsub_rn(__fmul_rn(4.0f, mn4), 4.0f), -1e-6f));
    lobe = fmaxf(lobe, fmaxf(-hit_min, hit_max));
    sum[c] = __fadd_rn(__fadd_rn(__fadd_rn(b, d), f), hh);
    ctr[c] = e;
  }
  // Worst case across channels, clamped to the stable range.
  lobe = __fmul_rn(fminf(fmaxf(lobe, -0.1875f), 0.0f), sharpness);
  const float rcp = __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(4.0f, lobe), 1.0f));
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= nc) break;
    out[c * plane + o] = __fmul_rn(__fadd_rn(__fmul_rn(sum[c], lobe), ctr[c]), rcp);
  }
}

}  // namespace

// src, out: (nc, h, w) f32, nc <= 4.  Returns cudaGetLastError() after the
// launch.
extern "C" int lvk_rcas(const void* src, void* out, int nc, int h, int w, float sharpness,
                        void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  rcas_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), nc, h, w, sharpness);
  return static_cast<int>(cudaGetLastError());
}
