// Backward warp of S planar (C, H, W) frames, each by its own absolute
// (2, OH, OW) (y, x) sample map, with the 12-tap EASU filter
// (FSR.cl:362-403) or bilinear filtering: the hand-written Hopper kernel
// behind ops/remap.remap, solo (S = 1) and under torch.func.vmap over
// streams (S > 1).
//
// Replaces livevisionkit_tpu/ops/tpu_kernels/warp.py::pallas_remap (bodies
// _easu_kernel and _kernel) and pallas_remap_batched (bodies
// _easu_kernel_batched and _kernel_batched): the stream axis is the grid's
// z axis, and each operand comes with its own stream stride, 0 for an
// operand that all streams share.  The oracle is the plain version in
// ops/easu.easu_remap and ops/remap.bilinear_sample, which this kernel
// matches exactly, borders included: EASU where its 4x4 support is inside
// (1 <= x0 < w-4, 1 <= y0 < h-4), nearest inside that ring, fill outside.
//
// One thread per output pixel computes all C channels with the EASU core of
// easu.cuh.  Taps are gathered straight from the source through the
// read-only cache; the TPU kernel's shift-select, mean-shift and
// separability machinery has no place on a GPU, which gathers natively.  A u8 source is filtered on its 0..255 scale
// (the scale the oracle's constants, e.g. 1/32768, are applied on) and the
// result is rounded half to even and clipped back to u8.

#include "easu.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

constexpr int kBlockX = 32, kBlockY = 8;

// Stream s reads its contiguous (C, H, W) frame at src + s * src_ss and its
// contiguous (2, OH, OW) map at smap + s * map_ss (a stride of 0: one
// operand shared by every stream) and writes the contiguous (S, C, OH, OW)
// output.  Three blocks a multiprocessor bound the EASU variant to 80
// registers: the stream offsets otherwise take it to 95, two blocks a
// multiprocessor, and a solo 1080p warp 15% longer.
template <typename T, bool kEasu>
__global__ void __launch_bounds__(kBlockX * kBlockY, 3) warp_kernel(const T* __restrict__ src, const float* __restrict__ smap,
                            T* __restrict__ out, long long src_ss, long long map_ss, int nc,
                            int h, int w, int oh, int ow, int has_fill, float fill,
                            int rgb_luma) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const size_t o = static_cast<size_t>(y) * ow + x;
  const size_t oplane = static_cast<size_t>(oh) * ow;
  const size_t splane = static_cast<size_t>(h) * w;
  src += blockIdx.z * src_ss;
  smap += blockIdx.z * map_ss;
  out += blockIdx.z * (oplane * nc);
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
  float res[kMaxC];
  easu_filter(src, nc, splane, w, y0i, x0i, ppx, ppy, rgb_luma, res);
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= nc) break;
    store(out + c * oplane + o, res[c]);
  }
}

template <typename T, bool kEasu>
void launch(const void* src, const float* smap, void* out, int n_streams, long long src_ss,
            long long map_ss, int nc, int h, int w, int oh, int ow, int has_fill, float fill,
            int rgb_luma, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y, n_streams);
  warp_kernel<T, kEasu><<<grid, block, 0, stream>>>(
      static_cast<const T*>(src), smap, static_cast<T*>(out), src_ss, map_ss, nc, h, w, oh, ow,
      has_fill, fill, rgb_luma);
}

}  // namespace

// src: S contiguous (nc, h, w) u8 or f32 frames, src_ss elements apart;
// smap: S contiguous (2, oh, ow) f32 maps, map_ss apart (a stride of 0
// shares the operand across streams); out: contiguous (S, nc, oh, ow) of the
// source dtype.  nc <= 4, 1 <= S <= 65535.  Returns cudaGetLastError()
// after the launch.
extern "C" int lvk_warp(const void* src, const void* smap, void* out, int n_streams,
                        long long src_ss, long long map_ss, int nc, int h, int w, int oh, int ow,
                        int is_u8, int easu, int has_fill, float fill, int rgb_luma,
                        void* stream) {
  if (n_streams < 1 || n_streams > 65535 || nc < 1 || nc > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (oh < 1 || ow < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(smap);
  const int n = n_streams;
  if (is_u8) {
    if (easu) launch<uint8_t, true>(src, m, out, n, src_ss, map_ss, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
    else launch<uint8_t, false>(src, m, out, n, src_ss, map_ss, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
  } else {
    if (easu) launch<float, true>(src, m, out, n, src_ss, map_ss, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
    else launch<float, false>(src, m, out, n, src_ss, map_ss, nc, h, w, oh, ow, has_fill, fill, rgb_luma, s);
  }
  return static_cast<int>(cudaGetLastError());
}
