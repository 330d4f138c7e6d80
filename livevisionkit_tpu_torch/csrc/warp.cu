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
// clipped back to u8.
//
// The bilinear mode is bound by bytes: 8 bytes of map and 2 x C of u8
// source and output a pixel (at 3x1080x1920 u8 ~8.7 us of the card's
// memory rate against ~1.4 us of its f32 rate).  One thread per output,
// gathering 4 x C single bytes through the read-only cache after its map
// load, spent 15 memory instructions on 14 bytes and reached ~40% of it.
// Its design: a block of 32 x 8 threads owns a 128 x 16 output tile, a
// thread 4 outputs 32 columns apart in each of 2 rows, so that a warp
// loads, reads and stores 32 adjacent columns at a time; a thread first
// issues all its map loads (streaming); the block reduces its samples'
// clamped floors to a source box and stages the box in shared memory as
// floats, planes a fixed stride apart (u8 by 32-bit loads, each pixel
// converted once; f32 by 16-byte cp.async; rows that are not whole aligned
// quads a pixel at a time); each output reads its 4 taps a plane from
// there without bank conflicts and is stored streaming.  A tile whose box
// exceeds kBilCap pixels a plane (a 0.5x zoom-out, a 30-degree rotation)
// gathers its taps from device memory; lvk_warp_counted counts such tiles
// as for EASU.  Every path gives the same bits as the others and as the
// one-thread-per-output kernel it replaced (the same floors, clamped
// indices, inside test and lerps in the same order, the fill after the
// lerp).  Measured on the H100 (tools/torch_kernels_ab.py, PERF.md
// section 6): what is left is each block's two waits on device memory in
// series (its map, then its box), with 64 registers a thread and 4 blocks
// a multiprocessor.  Threads owning 4 adjacent outputs (16-byte map loads,
// 32-bit u8 stores) read their staged taps 4 words apart, a 4-way bank
// conflict, and were slower; so were a persistent block pipelining the
// next tiles' maps and boxes through cp.async, an L2 prefetch of the map
// one wave ahead, and rounding without conversion instructions.

#include "easu.cuh"

namespace {

// u8 outputs are rounded half to even and clipped.
__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint8_t* p, float v) { *p = to_u8(v); }

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

// ---------------------------------------------------------------- bilinear

// A bilinear thread owns kOuts outputs of a row, kThreadsX apart, in each of
// kBilRows rows, kThreadsY apart: a block of 32 x 8 threads owns a 128 x 16
// tile.  A warp's 32 lanes then load, read their taps and store at 32
// adjacent columns at a time: whole 128-byte map rows, shared-memory reads
// without bank conflicts (the taps of adjacent outputs are adjacent words)
// and 32-byte (u8) or 128-byte (f32) stores.
constexpr int kOuts = 4;
constexpr int kBilRows = 2;
constexpr int kBilTileW = kThreadsX * kOuts, kBilTileH = kThreadsY * kBilRows;
// Elements of one vector access of a staged row: a 32-bit word of u8, a
// float4 of f32.
constexpr int kQuad = 4;
// Source pixels a plane a bilinear block stages, as floats, planes kBilCap
// apart (a tap's channels then sit at constant offsets).  A tile under a
// stabilization warp (scale near 1, a few degrees of rotation) needs about
// 136 x 22 of them; a 30-degree rotation (~124 x 80) or a 0.5x zoom-out
// (~260 x 34) does not fit and gathers from device memory.
constexpr int kBilCap = 4096;

template <int NC>
constexpr size_t bilinear_smem() {
  return static_cast<size_t>(NC) * kBilCap * sizeof(float);
}

// Resident blocks a multiprocessor, at most 4 (64 registers a thread), as
// its 228 KB of shared memory (1 KB of it reserved a block) allow.
template <int NC>
constexpr int bilinear_blocks() {
  return 228 * 1024 / (bilinear_smem<NC>() + 1024) < 4
             ? static_cast<int>(228 * 1024 / (bilinear_smem<NC>() + 1024))
             : 4;
}

template <size_t N, typename P>
__device__ __forceinline__ bool aligned(const P* p) {
  return (reinterpret_cast<uintptr_t>(p) & (N - 1)) == 0;
}

// An asynchronous 16-byte copy from device to shared memory (cp.async): no
// register holds it, so every copy of a thread is in flight at once.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The three lerps, in the plain version's order (ops/remap.bilinear_sample).
__device__ __forceinline__ float bilerp(float v00, float v01, float v10, float v11, float wx,
                                        float wy) {
  const float top = v00 + (v01 - v00) * wx;
  const float bot = v10 + (v11 - v10) * wx;
  return top + (bot - top) * wy;
}

// A streaming store of one output: u8 by one conversion (cvt.rni rounds
// half to even and clamps below at 0, NaN to 0, as rintf and the clip do).
__device__ __forceinline__ void store_rn(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_rn(uint8_t* p, float v) {
  __stcs(p, static_cast<uint8_t>(min(__float2uint_rn(v), 255u)));
}

__device__ __forceinline__ float4 u8x4_to_float4(unsigned v) {
  return make_float4(u8_to_float(v & 0xffu), u8_to_float((v >> 8) & 0xffu),
                     u8_to_float((v >> 16) & 0xffu), u8_to_float(v >> 24));
}

// Stage the NC planes' rows [oy, oy + bh) x columns [ox, ox + bw) of src as
// floats into box, rows `pitch` apart and planes kBilCap apart.  With
// `quads` (ox, w and pitch multiples of 4, src aligned to a quad and ox +
// pitch <= w) whole quads at a time: u8 by 32-bit loads, all of a thread's
// issued before its first conversion; f32 by cp.async.  Else an element at
// a time.  Every thread of the block must call it; it ends synchronized.
template <typename T, int NC>
__device__ __forceinline__ void stage_bilinear(float* box, const T* __restrict__ src,
                                               size_t splane, int w, int oy, int ox, int bw,
                                               int bh, int pitch, bool quads) {
  const unsigned tid = thread_rank();
  const T* base = src + static_cast<size_t>(oy) * w + ox;
  const unsigned nq = pitch / kQuad;
  if (quads) {
    if constexpr (std::is_same_v<T, uint8_t>) {
      // A box of at most kBilCap pixels a plane has at most kBilCap / 4
      // quads, kPer a thread.
      constexpr int kPer = kBilCap / kQuad / kThreads;
      const unsigned* words = reinterpret_cast<const unsigned*>(base);
      const size_t wplane = splane / kQuad, wrow = w / kQuad;
      unsigned v[kPer][NC];
      BoxWalk p(nq, tid);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (p.r < static_cast<unsigned>(bh)) {
#pragma unroll
          for (int c = 0; c < NC; ++c) v[k][c] = __ldg(words + c * wplane + p.r * wrow + p.c);
        }
        p.next();
      }
      BoxWalk q(nq, tid);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (q.r < static_cast<unsigned>(bh)) {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            *reinterpret_cast<float4*>(box + c * kBilCap + q.r * pitch + kQuad * q.c) =
                u8x4_to_float4(v[k][c]);
        }
        q.next();
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        for (BoxWalk p(nq, tid); p.r < static_cast<unsigned>(bh); p.next())
          cp_async16(box + c * kBilCap + p.r * pitch + kQuad * p.c,
                     base + c * splane + static_cast<size_t>(p.r) * w + kQuad * p.c);
      cp_async_wait_all();
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      for (BoxWalk p(bw, tid); p.r < static_cast<unsigned>(bh); p.next())
        box[c * kBilCap + p.r * pitch + p.c] =
            load(base + c * splane + static_cast<size_t>(p.r) * w + p.c);
  }
  __syncthreads();
}

// Resolve and store a thread's outputs: taps read from the staged box
// (kStaged; planes kBilCap apart, tap (y, x) at (y - oy) * pitch + x - ox)
// or gathered from the frame.  The floors, clamped indices, inside test
// and weights are the plain version's; with a fill (kFill) a sample
// outside the frame takes it and reads nothing, and a sample inside needs
// no clamp.
template <bool kStaged, bool kFill, typename T, int NC>
__device__ __forceinline__ void resolve_bilinear(
    const float (&sy)[kBilRows][kOuts], const float (&sx)[kBilRows][kOuts],
    const float* __restrict__ box, int pitch, int oy, int ox, const T* __restrict__ src,
    size_t splane, T* __restrict__ out, size_t oplane, int x_first, int y_top, int h, int w,
    int oh, int ow, float fill) {
#pragma unroll
  for (int r = 0; r < kBilRows; ++r) {
    const int y = y_top + r * kThreadsY;
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      const int x = x_first + k * kThreadsX;
      if (y >= oh || x >= ow) continue;
      const float y0f = floorf(sy[r][k]), x0f = floorf(sx[r][k]);
      const float wy = sy[r][k] - y0f, wx = sx[r][k] - x0f;
      int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
      if (!kFill) y0 = clampi(y0, 0, h - 1), x0 = clampi(x0, 0, w - 1);
      const int dy = min(y0 + 1, h - 1) - y0, dx = min(x0 + 1, w - 1) - x0;
      const bool inside = sy[r][k] >= 0.0f && sy[r][k] <= h - 1.0f && sx[r][k] >= 0.0f &&
                          sx[r][k] <= w - 1.0f;
      float v[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) v[c] = fill;
      if (inside || !kFill) {
        if constexpr (kStaged) {
          const float* p = box + (y0 - oy) * pitch + x0 - ox;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float* q = p + c * kBilCap;
            v[c] = bilerp(q[0], q[dx], q[dy * pitch], q[dy * pitch + dx], wx, wy);
          }
        } else {
          const T* p = src + static_cast<size_t>(y0) * w + x0;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const T* q = p + c * splane;
            v[c] = bilerp(load(q), load(q + dx), load(q + dy * w), load(q + dy * w + dx), wx, wy);
          }
        }
      }
      T* dst = out + static_cast<size_t>(y) * ow + x;
#pragma unroll
      for (int c = 0; c < NC; ++c) store_rn(dst + c * oplane, v[c]);
    }
  }
}

// Bilinear over the same stream layout as the EASU kernel.  Each thread
// first loads all its outputs' samples (streaming loads); the block
// reduces the taps they need to a source box, stages it in shared memory
// as floats when it holds at most kBilCap pixels a plane (else the taps are
// gathered from device memory; `paths` counts both as the EASU kernel
// does) and resolves each output from there.
template <typename T, int NC, bool kFill>
__global__ void __launch_bounds__(kThreadsX * kThreadsY, (bilinear_blocks<NC>()))
    bilinear_warp_kernel(const T* __restrict__ src, const float* __restrict__ smap,
                         T* __restrict__ out, long long src_ss, long long map_ss, int h, int w,
                         int oh, int ow, float fill, int* __restrict__ paths) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const box = reinterpret_cast<float*>(smem);
  __shared__ int4 red[kWarps];
  const size_t oplane = static_cast<size_t>(oh) * ow;
  const size_t splane = static_cast<size_t>(h) * w;
  src += blockIdx.z * src_ss;
  smap += blockIdx.z * map_ss;
  out += blockIdx.z * (oplane * NC);
  const int x_first = blockIdx.x * kBilTileW + threadIdx.x;
  const int y_top = blockIdx.y * kBilTileH + threadIdx.y;

  float sy[kBilRows][kOuts], sx[kBilRows][kOuts];
#pragma unroll
  for (int r = 0; r < kBilRows; ++r) {
    const int y = y_top + r * kThreadsY;
    const float* m = smap + static_cast<size_t>(y) * ow + x_first;
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      sy[r][k] = sx[r][k] = 0.0f;
      if (y < oh && x_first + k * kThreadsX < ow) {
        sy[r][k] = __ldcs(m + k * kThreadsX);
        sx[r][k] = __ldcs(m + oplane + k * kThreadsX);
      }
    }
  }

  // The box of the taps the tile needs (its samples inside the frame, or
  // all of them under replicate borders): the clamped floors' range
  // [x_lo, x_hi + 1] x [y_lo, y_hi + 1], clamped as the taps are.  A float
  // clamp to [0, h - 1] before the floor gives the clamped integer floor
  // (NaN to 0, as the integer conversion does), so a thread reduces its
  // samples as floats and floors only its four extremes.
  const float hm1 = h - 1.0f, wm1 = w - 1.0f;
  float ylo = INFINITY, yhi = -INFINITY, xlo = INFINITY, xhi = -INFINITY;
#pragma unroll
  for (int r = 0; r < kBilRows; ++r) {
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      if (y_top + r * kThreadsY >= oh || x_first + k * kThreadsX >= ow) continue;
      float cy = sy[r][k], cx = sx[r][k];
      if (kFill) {
        if (!(cy >= 0.0f && cy <= hm1 && cx >= 0.0f && cx <= wm1)) continue;
      } else {
        cy = fminf(fmaxf(cy, 0.0f), hm1), cx = fminf(fmaxf(cx, 0.0f), wm1);
      }
      ylo = fminf(ylo, cy), yhi = fmaxf(yhi, cy), xlo = fminf(xlo, cx), xhi = fmaxf(xhi, cx);
    }
  }
  int4 b = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  if (ylo <= yhi)
    b = make_int4(static_cast<int>(floorf(xlo)), static_cast<int>(floorf(xhi)),
                  static_cast<int>(floorf(ylo)), static_cast<int>(floorf(yhi)));
  b = block_bounds(b, red);
  const bool any = b.x <= b.y;
  // A source of whole aligned quads is staged a quad at a time from the
  // quad that holds the box's first column.
  const bool quads = (w & 3) == 0 && aligned<kQuad * sizeof(T)>(src);
  const int ox = quads ? b.x & ~(kQuad - 1) : b.x;
  const int bw = any ? min(b.y + 1, w - 1) - ox + 1 : 0;
  const int bh = any ? min(b.w + 1, h - 1) - b.z + 1 : 0;
  const int pitch = (bw + kQuad - 1) & ~(kQuad - 1);
  const bool staged = any && pitch * bh <= kBilCap;
  if (paths != nullptr && any && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(paths, 1);
    if (!staged) atomicAdd(paths + 1, 1);
  }
  if (staged) {
    stage_bilinear<T, NC>(box, src, splane, w, b.z, ox, bw, bh, pitch, quads);
    resolve_bilinear<true, kFill, T, NC>(sy, sx, box, pitch, b.z, ox, src, splane, out, oplane,
                                         x_first, y_top, h, w, oh, ow, fill);
  } else {
    resolve_bilinear<false, kFill, T, NC>(sy, sx, box, 0, 0, 0, src, splane, out, oplane,
                                          x_first, y_top, h, w, oh, ow, fill);
  }
}

template <typename T, int NC, bool kFill>
cudaError_t launch_bilinear(const void* src, const float* smap, void* out, int n_streams,
                            long long src_ss, long long map_ss, int h, int w, int oh, int ow,
                            float fill, int* paths, cudaStream_t stream) {
  constexpr size_t smem = bilinear_smem<NC>();
  const cudaError_t e = allow_smem(bilinear_warp_kernel<T, NC, kFill>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ow + kBilTileW - 1) / kBilTileW, (oh + kBilTileH - 1) / kBilTileH, n_streams);
  bilinear_warp_kernel<T, NC, kFill><<<grid, dim3(kThreadsX, kThreadsY), smem, stream>>>(
      static_cast<const T*>(src), smap, static_cast<T*>(out), src_ss, map_ss, h, w, oh, ow, fill,
      paths);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_bilinear(const void* src, const float* smap, void* out, int n_streams,
                            long long src_ss, long long map_ss, int h, int w, int oh, int ow,
                            int has_fill, float fill, int* paths, cudaStream_t stream) {
  return has_fill ? launch_bilinear<T, NC, true>(src, smap, out, n_streams, src_ss, map_ss, h, w,
                                                 oh, ow, fill, paths, stream)
                  : launch_bilinear<T, NC, false>(src, smap, out, n_streams, src_ss, map_ss, h,
                                                  w, oh, ow, fill, paths, stream);
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
    switch (nc) {
      case 1: return launch_bilinear<T, 1>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, paths, s);
      case 2: return launch_bilinear<T, 2>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, paths, s);
      case 3: return launch_bilinear<T, 3>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, paths, s);
      default: return launch_bilinear<T, 4>(src, smap, out, n, src_ss, map_ss, h, w, oh, ow, has_fill, fill, paths, s);
    }
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
// device int[2] to which a launch adds its blocks that hold a sample that
// reads the source (EASU: an EASU sample; bilinear: a sample inside the
// frame, or any under replicate borders) and, of those, the blocks whose
// source box exceeds the mode's capacity (kBoxCap, kBilCap) and which
// gather from device memory.  Returns cudaGetLastError() after the
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
