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
// matches, borders included: EASU where its 4x4 support is inside
// (1 <= x0 < w-4, 1 <= y0 < h-4), nearest inside that ring, fill outside.
// The TPU kernel's shift-select, mean-shift and separability machinery has
// no place on a GPU, which gathers natively.
//
// The EASU warp's bound on the H100 is arithmetic (~430 f32 operations an
// output pixel and 27 a source pixel for its direction terms, against 14
// bytes of map, source and output for u8 YUV): at 1080p about 14 us of the
// card's f32 rate against 9 us of its memory rate.  Its design (csrc/easu.cuh): one kernel per channel count (no dead
// channel); a block of 32 x 8 threads owns a 32 x 32 output tile (4 rows a
// thread), reduces its samples' f to a source box, stages the box as float
// texels with each source pixel's direction terms in shared memory, and
// resolves each output from there; a tile whose box exceeds kBoxCap
// gathers from device memory (lvk_warp_counted counts such tiles).  What holds it back, measured on the H100
// with the resolve removed, is each tile's chain of map reads, staging,
// barriers and stores: about two thirds of the kernel's time.  A u8 source
// is filtered on its 0..255 scale (the scale the oracle's constants, e.g.
// 1/32768, are applied on) and the result is rounded half to even and
// clipped back to u8.  The bilinear mode keeps one thread per output
// gathering its 4 taps through the read-only cache.

#include "easu.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// Output rows per thread: a block's tile is 32 x 32 outputs, so the staging
// and barriers of a tile are shared by 4 outputs a thread.
constexpr int kRows = 4;
constexpr int kTileH = kThreadsY * kRows;
// Source pixels a block stages.  A tile under a stabilization warp (scale
// near 1, a few degrees of rotation) needs about 36 x 36 of them; 30
// degrees of rotation (~48 x 48) or a 0.5x zoom-out (68 x 68) do not fit
// and take the device-memory path.  At 36 B a texel (texel, luma, terms)
// the box is 54 KB (float4 texels), so four blocks fit a multiprocessor.
constexpr int kBoxCap = 1536;

// a[k] for a k known only at run time, with no local-memory copy of a.
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int k) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = k == i ? a[i] : v;
  return v;
}

// Stream s reads its contiguous (C, H, W) frame at src + s * src_ss and its
// contiguous (2, OH, OW) map at smap + s * map_ss (a stride of 0: one
// operand shared by every stream) and writes the contiguous (S, C, OH, OW)
// output.  Four blocks a multiprocessor (64 registers, a few bytes spilled)
// measured faster than three over 8 streams.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreadsX * kThreadsY, 4)
    easu_warp_kernel(const T* __restrict__ src, const float* __restrict__ smap,
                     T* __restrict__ out, long long src_ss, long long map_ss, int h, int w,
                     int oh, int ow, int has_fill, float fill, int rgb_luma,
                     int* __restrict__ paths) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Box<NC, kBoxCap> box(smem);
  __shared__ int4 red[kWarps];
  const size_t oplane = static_cast<size_t>(oh) * ow;
  const size_t splane = static_cast<size_t>(h) * w;
  src += blockIdx.z * src_ss;
  smap += blockIdx.z * map_ss;
  out += blockIdx.z * (oplane * NC);
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  const int y_top = blockIdx.y * kTileH + threadIdx.y;
  float sy[kRows], sx[kRows];
  int4 b = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y_top + r * kThreadsY;
    sy[r] = sx[r] = 0.0f;
    if (x < ow && y < oh) {
      const size_t o = static_cast<size_t>(y) * ow + x;
      sy[r] = smap[o];
      sx[r] = smap[oplane + o];
      const int x0 = static_cast<int>(floorf(sx[r])), y0 = static_cast<int>(floorf(sy[r]));
      if (easu_inside(x0, y0, w, h))
        b = make_int4(min(b.x, x0), max(b.y, x0), min(b.z, y0), max(b.w, y0));
    }
  }
  // The box spans the tile's EASU samples' f with the taps' -1..+2 rim.
  b = block_bounds(b, red);
  const bool any = b.x <= b.y;
  const int bw = any ? b.y - b.x + 4 : 0, bh = any ? b.w - b.z + 4 : 0;
  const bool staged = any && static_cast<long long>(bw) * bh <= kBoxCap;
  if (paths != nullptr && any && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(paths, 1);
    if (!staged) atomicAdd(paths + 1, 1);
  }
  if (staged) stage(box, src, splane, w, b.z - 1, b.x - 1, bw, bh, rgb_luma);

#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const int y = y_top + r * kThreadsY;
    if (x >= ow || y >= oh) continue;
    const float syr = pick(sy, r), sxr = pick(sx, r);
    const float y0 = floorf(syr), x0 = floorf(sxr);
    const float ppy = syr - y0, ppx = sxr - x0;
    const int y0i = static_cast<int>(y0), x0i = static_cast<int>(x0);
    T* dst = out + static_cast<size_t>(y) * ow + x;
    if (!easu_inside(x0i, y0i, w, h)) {
      // Nearest-neighbour ring just inside the border, fill outside (FSR.cl:385-397).
      const bool inside = x0i >= 0 && y0i >= 0 && x0i < w && y0i < h;
      const int yc = clampi(y0i, 0, h - 1), xc = clampi(x0i, 0, w - 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v = (inside || !has_fill) ? load(src + c * splane + yc * w + xc) : fill;
        store(dst + c * oplane, v);
      }
      continue;
    }
    float res[NC];
    if (staged) {
      easu_staged(box, bw, y0i - b.z, x0i - b.x, ppx, ppy, res);
    } else {
      easu_global<NC>(src, splane, w, y0i, x0i, ppx, ppy, rgb_luma, res);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) store(dst + c * oplane, res[c]);
  }
}

constexpr int kMaxC = 4;

// Bilinear, one thread per output pixel, the same stream layout.
template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY, 3)
    bilinear_warp_kernel(const T* __restrict__ src, const float* __restrict__ smap,
                         T* __restrict__ out, long long src_ss, long long map_ss, int nc, int h,
                         int w, int oh, int ow, int has_fill, float fill) {
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
}

template <typename T, int NC>
cudaError_t launch_easu(const void* src, const float* smap, void* out, int n_streams,
                        long long src_ss, long long map_ss, int h, int w, int oh, int ow,
                        int has_fill, float fill, int rgb_luma, int* paths,
                        cudaStream_t stream) {
  const size_t smem = Box<NC, kBoxCap>::kBytes;
  const cudaError_t e = allow_smem(easu_warp_kernel<T, NC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ow + kThreadsX - 1) / kThreadsX, (oh + kTileH - 1) / kTileH, n_streams);
  easu_warp_kernel<T, NC><<<grid, dim3(kThreadsX, kThreadsY), smem, stream>>>(
      static_cast<const T*>(src), smap, static_cast<T*>(out), src_ss, map_ss, h, w, oh, ow,
      has_fill, fill, rgb_luma, paths);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* src, const float* smap, void* out, int n, long long src_ss,
                   long long map_ss, int nc, int h, int w, int oh, int ow, int easu, int has_fill,
                   float fill, int rgb_luma, int* paths, cudaStream_t s) {
  if (!easu) {
    const dim3 grid((ow + kThreadsX - 1) / kThreadsX, (oh + kThreadsY - 1) / kThreadsY, n);
    bilinear_warp_kernel<T><<<grid, dim3(kThreadsX, kThreadsY), 0, s>>>(
        static_cast<const T*>(src), smap, static_cast<T*>(out), src_ss, map_ss, nc, h, w, oh, ow,
        has_fill, fill);
    return cudaGetLastError();
  }
  switch (nc) {
    case 1: return launch_easu<T, 1>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, rgb_luma, paths, s);
    case 2: return launch_easu<T, 2>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, rgb_luma, paths, s);
    case 3: return launch_easu<T, 3>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, rgb_luma, paths, s);
    default: return launch_easu<T, 4>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, rgb_luma, paths, s);
  }
}

}  // namespace

// src: S contiguous (nc, h, w) u8 or f32 frames, src_ss elements apart;
// smap: S contiguous (2, oh, ow) f32 maps, map_ss apart (a stride of 0
// shares the operand across streams); out: contiguous (S, nc, oh, ow) of the
// source dtype.  1 <= nc <= 4, 1 <= S <= 65535.  paths, if not null, is a
// device int[2] to which an EASU launch adds its blocks that hold an EASU
// sample and, of those, the blocks whose source box exceeds kBoxCap and
// which gather from device memory.  Returns cudaGetLastError() after the
// launch.
extern "C" int lvk_warp_counted(const void* src, const void* smap, void* out, int n_streams,
                                long long src_ss, long long map_ss, int nc, int h, int w,
                                int oh, int ow, int is_u8, int easu, int has_fill, float fill,
                                int rgb_luma, void* paths, void* stream) {
  if (n_streams < 1 || n_streams > 65535 || nc < 1 || nc > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (oh < 1 || ow < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(smap);
  int* pc = static_cast<int*>(paths);
  return static_cast<int>(
      is_u8 ? launch<uint8_t>(src, m, out, n_streams, src_ss, map_ss, nc, h, w, oh, ow, easu, has_fill, fill, rgb_luma, pc, s)
            : launch<float>(src, m, out, n_streams, src_ss, map_ss, nc, h, w, oh, ow, easu, has_fill, fill, rgb_luma, pc, s));
}

// The same launch with no counts: the entry point that every version of
// the library exports (tools/torch_kernels_ab.py times versions by it).
extern "C" int lvk_warp(const void* src, const void* smap, void* out, int n_streams,
                        long long src_ss, long long map_ss, int nc, int h, int w, int oh, int ow,
                        int is_u8, int easu, int has_fill, float fill, int rgb_luma,
                        void* stream) {
  return lvk_warp_counted(src, smap, out, n_streams, src_ss, map_ss, nc, h, w, oh, ow, is_u8,
                          easu, has_fill, fill, rgb_luma, nullptr, stream);
}
