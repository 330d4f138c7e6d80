// RANSAC + IRLS global motion, one thread block per stream: the hand-written
// Hopper kernel behind vision/ransac.estimate (K7).
//
// Replaces no TPU kernel: the JAX package leaves vision/ransac.estimate to
// XLA, which fuses it.  The port's plain version, vision/ransac.
// estimate_plain, spells it out in ~1,100 small PyTorch ops (the 4-point
// DLT's unrolled Gauss-Jordan, the K x N transfer errors, the truncated-
// quadratic scores, and per IRLS round both weighted models, a Cholesky and
// two triangular solves), which in a captured step are ~1,100 graph nodes
// of ~1.6 us each.  This kernel runs everything after the random draw in
// one launch and keeps the plain version's rules: f32, the same minimal
// sets, the same pivot order, a non-finite model scoring -inf, the first
// maximum with torch.argmax's NaN rule, a non-PD normal block or a
// non-finite refinement keeping the previous model, the identity fallback.
//
// What bounds it: latency.  At the main path's shapes (N = 510 features,
// K = 256 hypotheses, 4 rounds) the work is ~6.6 M f32 operations (most of
// it the K x N scores) over ~17 KB of operands, far too little to fill 132
// SMs; the time is the chain of dependent phases.  Its design: a cluster
// of 8 blocks of 512 threads per stream, every operand in shared memory,
// reductions by warp shuffles in a fixed order (no atomics, so every
// launch gives the same bits):
//
//   1. Every block stages the N point pairs (as float4) and valid flags.
//   2. Each block takes K/8 of the hypotheses, one thread per model: the
//      4-point DLT with dlt4's exact pivot order in registers (the row swap
//      is a select per element, so the matrix never leaves registers), bit
//      for bit the plain arithmetic, and the 2-point similarity.
//   3. A warp per hypothesis, its lanes over the points: both models'
//      scores, reduced by a butterfly.
//   4. Each block's best of its hypotheses (first maximum, NaN above
//      all); the cluster's first block reads the others' through
//      distributed shared memory and keeps the best of the bests, the same
//      first maximum over all K.  The other blocks then leave.
//   5. refine_iterations IRLS rounds of the selected model only (the plain
//      version computes both and keeps one with torch.where: the same
//      result): per-point weights, Hartley normalisations, the 29 distinct
//      non-zero sums of the 9x9 normal matrix (a transposing warp
//      reduction), then an 8x8 Cholesky, two triangular solves and the
//      de-normalisation on one thread; or the similarity's closed form.
//   6. The inlier mask, the stability, `ok` and the identity fallback.
//
// S streams are S clusters of one launch (torch.func.vmap's rule).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 2048;   // ops/cuda_kernels/ransac.py: _MAX_POINTS
constexpr int kMaxK = 1024;   // _MAX_HYPOTHESES
constexpr int kMaxSums = 29;  // the widest block reduction: the normal matrix's sums
constexpr int kCluster = 8;   // blocks a stream: each scores 1/8 of the hypotheses
constexpr int kScratch = 17 * 32 + 32;  // block_sum's floats

struct Args {
  const float* src;  // (N, 2) per stream
  const float* dst;
  const uint8_t* valid;  // (N,) bool
  const long long* idx;  // (K, 4) int64
  const uint8_t* use_h;  // 0-d bool
  long long src_ss, dst_ss, valid_ss, idx_ss, use_h_ss;  // stream strides (elements)
  int n, k, rounds, min_samples;
  float tau2, inv_tau2;
  float* model;       // (S, 3, 3)
  uint8_t* inliers;   // (S, N) bool
  float* stability;   // (S,)
  uint8_t* ok;        // (S,) bool
  long long* best;    // (S, 2) int64: argmax of the homography and similarity scores
};

__device__ __forceinline__ float nanf_() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Separately rounded products and sums: where the plain version runs one
// PyTorch op per arithmetic step, these keep the compiler from fusing two
// into an FMA, so the result is the plain version's bit for bit.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// `python_float / tensor` in PyTorch is reciprocal(tensor) * python_float.
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

__device__ __forceinline__ bool finite9(const float* h) {
  bool f = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) f = f && isfinite(h[i]);
  return f;
}

// torch.clamp(v, min=0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// Squared forward-transfer error |H(p) - q|^2 of the pair p = (x, y), q =
// (z, w) (ransac._transfer_errors_sq; the einsum's three products summed
// in order, as a matrix product does).
__device__ __forceinline__ float transfer_sq(const float* h, float4 p) {
  const float ox = fmaf(h[1], p.y, h[0] * p.x) + h[2];
  const float oy = fmaf(h[4], p.y, h[3] * p.x) + h[5];
  const float oz = fmaf(h[7], p.y, h[6] * p.x) + h[8];
  const float safe = fabsf(oz) > 1e-8f ? oz : 1e-8f;
  const float ex = ox / safe - p.z;
  const float ey = oy / safe - p.w;
  return add(mul(ex, ex), mul(ey, ey));
}

// torch.argmax's order: a NaN above everything, then the larger value, then
// the lower index.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// The best (value, index) of a warp's lanes by `beats`, in every lane.
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, m);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
    if (beats(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// One step of a transposing warp reduction over 2W values a[0, 2W): a lane
// keeps the half its lane bit W selects and adds its partner's copy of it,
// leaving W values in a[0, W).  Unrolled by the template, so `a` stays in
// registers.
template <int W>
__device__ __forceinline__ void transpose_step(float (&a)[32], int lane) {
  const bool up = (lane & W) != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float give = up ? a[j] : a[j + W];
    const float keep = up ? a[j + W] : a[j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, give, W);
  }
}

// Sum NV <= 32 values over the block, every thread's v[] replaced by the
// totals, in a fixed order (no atomics).  In each warp, lane j ends with
// the warp's sum of value j: for a few values by a butterfly per value, for
// many by a transposing reduction (at each step a lane keeps half of its
// values and hands the other half to its partner: 31 shuffles for 32
// values in place of 160).  Then half a warp per value adds the warps' sums
// by a butterfly.  `scratch` holds kScratch floats: the warps' sums at
// stride 17, so neither the writes nor the reads share a bank.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch) {
  static_assert(NV <= 32 && kWarps == 16, "half a warp adds a value's 16 warp sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mine;
  if constexpr (NV > 8) {
    float a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = j < NV ? v[j] : 0.0f;
    transpose_step<16>(a, lane);
    transpose_step<8>(a, lane);
    transpose_step<4>(a, lane);
    transpose_step<2>(a, lane);
    transpose_step<1>(a, lane);
    mine = a[0];
  } else {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], m);
    }
    mine = v[0];
#pragma unroll
    for (int j = 1; j < NV; ++j) mine = lane == j ? v[j] : mine;
  }
  if (lane < NV) scratch[17 * lane + warp] = mine;
  __syncthreads();
  if (threadIdx.x < ((16 * NV + 31) & ~31)) {  // whole warps, for the shuffles
    const int j = threadIdx.x >> 4, part = threadIdx.x & 15;
    float t = j < NV ? scratch[17 * j + part] : 0.0f;
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
    if (part == 0 && j < NV) scratch[17 * 32 + j] = t;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = scratch[17 * 32 + j];
}

// models.homography.dlt4 of one quad, every step as the plain version takes
// it: the 1/256 conditioning, partially pivoted Gauss-Jordan with the first
// maximum (NaN first) as pivot, rows swapped, the pivot row scaled by the
// pivot's reciprocal (NaN below 1e-12), every other row less its multiple.
// Columns left of the pivot are never read again, so they are not updated.
__device__ __forceinline__ void dlt4(const float4* pts, const long long* q, int n, float* h) {
  constexpr float c = 1.0f / 256.0f;
  float a[8][9];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long j = q[i];
    j = j < 0 ? 0 : (j >= n ? n - 1 : j);
    const float4 p = pts[j];
    const float x = p.x * c, y = p.y * c, u = p.z * c, v = p.w * c;  // exact: c = 2^-8
    const float ru[9] = {x, y, 1.0f, 0.0f, 0.0f, 0.0f, mul(-u, x), mul(-u, y), u};
    const float rv[9] = {0.0f, 0.0f, 0.0f, x, y, 1.0f, mul(-v, x), mul(-v, y), v};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      a[i][k] = ru[k];
      a[4 + i][k] = rv[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int r = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const float v = fabsf(a[i][k]);
      if (!isnan(best) && (isnan(v) || v > best)) {
        best = v;
        r = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const bool sw = i == r;
#pragma unroll
      for (int j = k; j < 9; ++j) {
        const float t = a[k][j];
        a[k][j] = sw ? a[i][j] : t;
        a[i][j] = sw ? t : a[i][j];
      }
    }
    const float piv = a[k][k];
    const float inv = fabsf(piv) > 1e-12f ? rcp(piv) : nanf_();
    float row[9];
#pragma unroll
    for (int j = k + 1; j < 9; ++j) row[j] = mul(a[k][j], inv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i == k) continue;
      const float f = a[i][k];
#pragma unroll
      for (int j = k + 1; j < 9; ++j) a[i][j] = sub(a[i][j], mul(f, row[j]));
    }
#pragma unroll
    for (int j = k + 1; j < 9; ++j) a[k][j] = row[j];
  }
  // H = S^-1 Hn S, S = diag(c, c, 1): exact scalings by powers of two.
  h[0] = a[0][8];
  h[1] = a[1][8];
  h[2] = a[2][8] * 256.0f;
  h[3] = a[3][8];
  h[4] = a[4][8];
  h[5] = a[5][8] * 256.0f;
  h[6] = a[6][8] * c;
  h[7] = a[7][8] * c;
  h[8] = 1.0f;
}

// ransac._similarity_from_2pts of the pairs a, b, the plain arithmetic.
__device__ __forceinline__ void similarity2(float4 p, float4 q, float* h) {
  const float dpx = sub(q.x, p.x), dpy = sub(q.y, p.y);
  const float dqx = sub(q.z, p.z), dqy = sub(q.w, p.w);
  const float denom = add(mul(dpx, dpx), mul(dpy, dpy));
  const float inv = denom > 1e-12f ? rcp(denom) : nanf_();
  const float a = mul(add(mul(dqx, dpx), mul(dqy, dpy)), inv);
  const float b = mul(sub(mul(dqy, dpx), mul(dqx, dpy)), inv);
  h[0] = a;
  h[1] = -b;
  h[2] = sub(p.z, sub(mul(a, p.x), mul(b, p.y)));
  h[3] = b;
  h[4] = a;
  h[5] = sub(p.w, add(mul(b, p.x), mul(a, p.y)));
  h[6] = 0.0f;
  h[7] = 0.0f;
  h[8] = 1.0f;
}

// models.homography._adjugate and ransac._inv3.
__device__ __forceinline__ void inv3(const float* m, float* out) {
  float adj[9] = {
      sub(mul(m[4], m[8]), mul(m[5], m[7])), sub(mul(m[2], m[7]), mul(m[1], m[8])),
      sub(mul(m[1], m[5]), mul(m[2], m[4])), sub(mul(m[5], m[6]), mul(m[3], m[8])),
      sub(mul(m[0], m[8]), mul(m[2], m[6])), sub(mul(m[2], m[3]), mul(m[0], m[5])),
      sub(mul(m[3], m[7]), mul(m[4], m[6])), sub(mul(m[1], m[6]), mul(m[0], m[7])),
      sub(mul(m[0], m[4]), mul(m[1], m[3]))};
  const float det = add(add(mul(m[0], adj[0]), mul(m[1], adj[3])), mul(m[2], adj[6]));
  const float d = fabsf(det) > 1e-20f ? det : nanf_();
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = adj[i] / d;
}

__device__ __forceinline__ void matmul3(const float* a, const float* b, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = fmaf(a[3 * i + 2], b[6 + j], fmaf(a[3 * i + 1], b[3 + j], a[3 * i] * b[j]));
  }
}

// ransac._normalization's matrix from the weighted mean and mean distance.
__device__ __forceinline__ void normalization(float mx, float my, float mean_d, float* t) {
  const float s = mean_d > 1e-6f ? mul(rcp(mean_d), 1.41421356237309515f) : 1.0f;
  t[0] = s;
  t[1] = 0.0f;
  t[2] = mul(-s, mx);
  t[3] = 0.0f;
  t[4] = s;
  t[5] = mul(-s, my);
  t[6] = 0.0f;
  t[7] = 0.0f;
  t[8] = 1.0f;
}

// The 29 sums of the weighted DLT's normal matrix M = A^T W A that the
// solve reads, A's rows r1 = (x, y, 1, 0, 0, 0, -ux, -uy, -u) and r2 = (0,
// 0, 0, x, y, 1, -vx, -vy, -v) for the normalised pair; each term is
// (a_i w) a_j, as the plain product forms it.  Layout: [0, 6) the lower
// triangle of the (x, y, 1) block, which is both M[0:3, 0:3] and M[3:6,
// 3:6]; [6, 12) M[6:8, 0:3] (r1); [12, 18) M[6:8, 3:6] (r2); [18, 21)
// M[6][6], M[7][6], M[7][7]; [21, 29) M[0:8, 8].
__device__ __forceinline__ void normal_terms(float x, float y, float u, float v, float w,
                                             float* s) {
  const float p[3] = {x, y, 1.0f};
  const float ru[3] = {mul(-u, x), mul(-u, y), -u};  // r1's columns 6, 7, 8
  const float rv[3] = {mul(-v, x), mul(-v, y), -v};  // r2's
  int o = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) s[o++] += mul(mul(p[i], w), p[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) s[6 + 3 * i + j] += mul(mul(ru[i], w), p[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) s[12 + 3 * i + j] += mul(mul(rv[i], w), p[j]);
  }
  s[18] += mul(mul(ru[0], w), ru[0]);
  s[18] += mul(mul(rv[0], w), rv[0]);
  s[19] += mul(mul(ru[1], w), ru[0]);
  s[19] += mul(mul(rv[1], w), rv[0]);
  s[20] += mul(mul(ru[1], w), ru[1]);
  s[20] += mul(mul(rv[1], w), rv[1]);
#pragma unroll
  for (int i = 0; i < 3; ++i) s[21 + i] += mul(mul(p[i], w), ru[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) s[24 + i] += mul(mul(p[i], w), rv[2]);
  s[27] += mul(mul(ru[0], w), ru[2]);
  s[27] += mul(mul(rv[0], w), rv[2]);
  s[28] += mul(mul(ru[1], w), ru[2]);
  s[28] += mul(mul(rv[1], w), rv[2]);
}

// ransac._weighted_dlt's solve from the sums: the 8x8 block's Cholesky (NaN
// throughout where it is not positive definite, as cholesky_ex's status
// makes it), the two triangular solves against -M[0:8, 8], then H = Td^-1
// Hn Ts / its (2, 2) entry.
__device__ __forceinline__ void dlt_solve(const float* s, const float* ts, const float* td,
                                          float* out) {
  float m[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) m[i][j] = 0.0f;
  }
  int o = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      m[i][j] = s[o];
      m[3 + i][3 + j] = s[o];
      ++o;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m[6 + i][j] = s[6 + 3 * i + j];
      m[6 + i][3 + j] = s[12 + 3 * i + j];
    }
  }
  m[6][6] = s[18];
  m[7][6] = s[19];
  m[7][7] = s[20];
  // The diagonal's reciprocals turn the column scalings and both solves'
  // divisions into products, off the chain of dependent steps.
  float l[8][8], rl[8];
  bool pd = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float d = m[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= l[j][k] * l[j][k];
    pd = pd && d > 0.0f;
    l[j][j] = sqrtf(d);
    rl[j] = rcp(l[j][j]);
#pragma unroll
    for (int i = j + 1; i < 8; ++i) {
      float t = m[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t * rl[j];
    }
  }
  float y[8], h[9];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float t = -s[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= l[i][k] * y[k];
    y[i] = t * rl[i];
  }
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < 8; ++k) t -= l[k][i] * h[k];
    h[i] = t * rl[i];
  }
  h[8] = 1.0f;
  if (!pd) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = nanf_();
  }
  float tdi[9], t1[9], full[9];
  inv3(td, tdi);
  matmul3(tdi, h, t1);
  matmul3(t1, ts, full);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = full[i] / full[8];
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    ransac_kernel(Args g) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = g.n, k = g.k, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / kCluster;
  const int per = (k + kCluster - 1) / kCluster;  // hypotheses a block of the cluster takes
  const int h0 = rank * per;
  const int mine = max(0, min(k, h0 + per) - h0);
  float4* pts = smem4;                                    // (N,) (src x, y, dst x, y)
  float* vf = reinterpret_cast<float*>(pts + n);          // (N,) valid as 0 / 1
  float* wt = vf + n;                                     // (N,) IRLS weights
  float* hyp_h = wt + n;                                  // (per, 9) this block's hypotheses
  float* hyp_s = hyp_h + 9 * per;                         // (per, 9)
  float* score_h = hyp_s + 9 * per;                       // (per,)
  float* score_s = score_h + per;                         // (per,)
  float* scratch = score_s + per;                         // kScratch
  float* model = scratch + kScratch;  // (9,)
  float* best_v = model + 9;                              // (2,) this block's best scores
  int* best_i = reinterpret_cast<int*>(best_v + 2);       // (2,) and their indices
  int* picked = best_i + 2;                               // (2,) the winners

  const float* src = g.src + s * g.src_ss;
  const float* dst = g.dst + s * g.dst_ss;
  const uint8_t* valid = g.valid + s * g.valid_ss;
  const long long* idx = g.idx + (s * g.idx_ss + 4LL * h0);
  const bool use_h = g.use_h[s * g.use_h_ss] != 0;

  // 1. Stage (every block of the cluster: each scores its share of the
  // hypotheses over all the points).
  for (int i = tid; i < n; i += kThreads) {
    pts[i] = make_float4(src[2 * i], src[2 * i + 1], dst[2 * i], dst[2 * i + 1]);
    vf[i] = valid[i] ? 1.0f : 0.0f;
  }
  __syncthreads();

  // 2. This block's hypotheses: threads [0, mine) the homographies, [mine,
  // 2 mine) the similarities.
  for (int j = tid; j < 2 * mine; j += kThreads) {
    if (j < mine) {
      dlt4(pts, idx + 4 * j, n, hyp_h + 9 * j);
    } else {
      const long long* q = idx + 4 * (j - mine);
      long long a = q[0], b = q[1];
      a = a < 0 ? 0 : (a >= n ? n - 1 : a);
      b = b < 0 ? 0 : (b >= n ? n - 1 : b);
      similarity2(pts[a], pts[b], hyp_s + 9 * (j - mine));
    }
  }
  __syncthreads();

  // 3. Scores: a warp per hypothesis, both models at once.  The scoring's
  // one division is a reciprocal and two products (1 ulp from the plain
  // quotient, a rounding step like the order of the sums); a similarity's
  // third row is exactly (0, 0, 1), so its projective division is by 1 and
  // is left out.
  for (int h = warp; h < mine; h += kWarps) {
    float mh[9], ms[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      mh[i] = hyp_h[9 * h + i];
      ms[i] = hyp_s[9 * h + i];
    }
    float acc_h = 0.0f, acc_s = 0.0f;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const float4 p = pts[i];
      const float v = vf[i];
      const float ox = fmaf(mh[1], p.y, mh[0] * p.x) + mh[2];
      const float oy = fmaf(mh[4], p.y, mh[3] * p.x) + mh[5];
      const float oz = fmaf(mh[7], p.y, mh[6] * p.x) + mh[8];
      const float r = rcp(fabsf(oz) > 1e-8f ? oz : 1e-8f);
      const float ex = ox * r - p.z, ey = oy * r - p.w;
      const float eh = add(mul(ex, ex), mul(ey, ey));
      acc_h += clamp0(1.0f - eh * g.inv_tau2) * v;
      const float sx = fmaf(ms[1], p.y, ms[0] * p.x) + ms[2] - p.z;
      const float sy = fmaf(ms[4], p.y, ms[3] * p.x) + ms[5] - p.w;
      const float es = add(mul(sx, sx), mul(sy, sy));
      acc_s += clamp0(1.0f - es * g.inv_tau2) * v;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      acc_h += __shfl_xor_sync(0xffffffffu, acc_h, m);
      acc_s += __shfl_xor_sync(0xffffffffu, acc_s, m);
    }
    if (lane == 0) {
      score_h[h] = finite9(mh) ? acc_h : neg_inf();
      score_s[h] = finite9(ms) ? acc_s : neg_inf();
    }
  }
  __syncthreads();

  // 4. Winners: warp 0 over the homographies, warp 1 over the similarities,
  // first the best of this block's (global index h0 + i), then, in the
  // cluster's first block, the best of the blocks', read from their shared
  // memory; the same order throughout (torch.argmax's), so the winner is
  // the first maximum over all K.  The other blocks wait until their
  // winners and models have been read, then leave.
  if (warp < 2) {
    const float* sc = warp == 0 ? score_h : score_s;
    float bv = neg_inf();
    int bi = 0x7fffffff;
    for (int i = lane; i < mine; i += 32) {
      if (beats(sc[i], h0 + i, bv, bi)) {
        bv = sc[i];
        bi = h0 + i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      best_v[warp] = bv;
      best_i[warp] = bi;
    }
  }
  cluster.sync();
  if (rank == 0) {
    if (warp < 2) {
      float bv = neg_inf();
      int bi = 0x7fffffff;
      if (lane < kCluster) {
        bv = cluster.map_shared_rank(best_v, lane)[warp];
        bi = cluster.map_shared_rank(best_i, lane)[warp];
      }
      warp_best(bv, bi);
      if (lane == 0) picked[warp] = bi;
    }
    __syncthreads();
    if (tid < 9) {
      const int w = use_h ? picked[0] : picked[1];
      model[tid] = cluster.map_shared_rank(use_h ? hyp_h : hyp_s, w / per)[9 * (w % per) + tid];
    }
  }
  cluster.sync();
  if (rank != 0) return;

  // 5. IRLS on the selected model.
  for (int round = 0; round < g.rounds; ++round) {
    float cur[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) cur[i] = model[i];
    float m5[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < n; i += kThreads) {
      const float4 p = pts[i];
      const float w = mul(vf[i], clamp0(sub(1.0f, transfer_sq(cur, p) * g.inv_tau2)));
      wt[i] = w;
      m5[0] += w;
      m5[1] += mul(p.x, w);
      m5[2] += mul(p.y, w);
      m5[3] += mul(p.z, w);
      m5[4] += mul(p.w, w);
    }
    block_sum(m5, scratch);
    const float wsum = m5[0] < 1e-6f ? 1e-6f : m5[0];  // clamp(min=1e-6); NaN stays
    const float msx = m5[1] / wsum, msy = m5[2] / wsum, mdx = m5[3] / wsum, mdy = m5[4] / wsum;
    float refined[9];
    if (use_h) {
      float d2[2] = {0.0f, 0.0f};
      for (int i = tid; i < n; i += kThreads) {
        const float4 p = pts[i];
        const float w = wt[i];
        const float ax = sub(p.x, msx), ay = sub(p.y, msy), bx = sub(p.z, mdx), by = sub(p.w, mdy);
        d2[0] += mul(sqrtf(add(mul(ax, ax), mul(ay, ay))), w);
        d2[1] += mul(sqrtf(add(mul(bx, bx), mul(by, by))), w);
      }
      block_sum(d2, scratch);
      float ts[9], td[9];
      normalization(msx, msy, d2[0] / wsum, ts);
      normalization(mdx, mdy, d2[1] / wsum, td);
      float sums[kMaxSums];
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) sums[j] = 0.0f;
      for (int i = tid; i < n; i += kThreads) {
        const float4 p = pts[i];
        normal_terms(fmaf(ts[0], p.x, ts[2]), fmaf(ts[4], p.y, ts[5]), fmaf(td[0], p.z, td[2]),
                     fmaf(td[4], p.w, td[5]), wt[i], sums);
      }
      block_sum(sums, scratch);
      if (tid == 0) dlt_solve(sums, ts, td, refined);
    } else {
      float c3[3] = {0.0f, 0.0f, 0.0f};
      for (int i = tid; i < n; i += kThreads) {
        const float4 p = pts[i];
        const float w = wt[i];
        const float sx = sub(p.x, msx), sy = sub(p.y, msy), dx = sub(p.z, mdx), dy = sub(p.w, mdy);
        c3[0] += mul(w, add(mul(sx, sx), mul(sy, sy)));
        c3[1] += mul(w, add(mul(dx, sx), mul(dy, sy)));
        c3[2] += mul(w, sub(mul(dy, sx), mul(dx, sy)));
      }
      block_sum(c3, scratch);
      if (tid == 0) {
        // ransac._weighted_similarity's closed form.
        const float inv = c3[0] > 1e-9f ? rcp(c3[0]) : 0.0f;
        const float a = mul(c3[1], inv), b = mul(c3[2], inv);
        refined[0] = a;
        refined[1] = -b;
        refined[2] = sub(mdx, sub(mul(a, msx), mul(b, msy)));
        refined[3] = b;
        refined[4] = a;
        refined[5] = sub(mdy, add(mul(b, msx), mul(a, msy)));
        refined[6] = 0.0f;
        refined[7] = 0.0f;
        refined[8] = 1.0f;
      }
    }
    if (tid == 0 && finite9(refined)) {
#pragma unroll
      for (int i = 0; i < 9; ++i) model[i] = refined[i];
    }
    __syncthreads();
  }

  // 6. Inliers, stability, ok.
  float cur[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) cur[i] = model[i];
  uint8_t* inl = g.inliers + static_cast<long long>(s) * n;
  float cnt[2] = {0.0f, 0.0f};
  for (int i = tid; i < n; i += kThreads) {
    const bool in = transfer_sq(cur, pts[i]) < g.tau2 && vf[i] != 0.0f;
    inl[i] = in ? 1 : 0;
    cnt[0] += in ? 1.0f : 0.0f;
    cnt[1] += vf[i];
  }
  block_sum(cnt, scratch);
  const bool ok = finite9(cur) && cnt[1] >= static_cast<float>(g.min_samples) &&
                  cnt[0] >= static_cast<float>(g.min_samples);
  if (tid < 9) g.model[9 * s + tid] = ok ? cur[tid] : (tid % 4 == 0 ? 1.0f : 0.0f);
  if (tid == 0) {
    g.stability[s] = cnt[0] / (cnt[1] < 1.0f ? 1.0f : cnt[1]);
    g.ok[s] = ok ? 1 : 0;
    g.best[2 * s] = picked[0];
    g.best[2 * s + 1] = picked[1];
  }
}

size_t smem_bytes(int n, int k) {
  const int per = (k + kCluster - 1) / kCluster;
  return sizeof(float4) * n +
         sizeof(float) * (2 * n + 20 * per + kScratch + 11) + 4 * sizeof(int);
}

}  // namespace

// One launch over n_streams streams, a cluster of kCluster blocks each.  Pointers and stream
// strides (elements) as the wrapper lays them out; tau2 = tau * tau.
// Returns the launch's CUDA status (cudaErrorInvalidValue for shapes the
// kernel does not take).
extern "C" int lvk_ransac(const void* src, long long src_ss, const void* dst, long long dst_ss,
                          const void* valid, long long valid_ss, const void* idx,
                          long long idx_ss, const void* use_h, long long use_h_ss, int n_streams,
                          int n, int k, float tau2, int rounds, int min_samples, void* model,
                          void* inliers, void* stability, void* ok, void* best, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || k > kMaxK || rounds < 0 || n_streams < 1 ||
      n_streams > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.src = static_cast<const float*>(src);
  g.dst = static_cast<const float*>(dst);
  g.valid = static_cast<const uint8_t*>(valid);
  g.idx = static_cast<const long long*>(idx);
  g.use_h = static_cast<const uint8_t*>(use_h);
  g.src_ss = src_ss;
  g.dst_ss = dst_ss;
  g.valid_ss = valid_ss;
  g.idx_ss = idx_ss;
  g.use_h_ss = use_h_ss;
  g.n = n;
  g.k = k;
  g.rounds = rounds;
  g.min_samples = min_samples;
  g.tau2 = tau2;
  g.inv_tau2 = 1.0f / tau2;
  g.model = static_cast<float*>(model);
  g.inliers = static_cast<uint8_t*>(inliers);
  g.stability = static_cast<float*>(stability);
  g.ok = static_cast<uint8_t*>(ok);
  g.best = static_cast<long long*>(best);
  const size_t smem = smem_bytes(n, k);
  if (smem > 48 * 1024) {
    // Only shapes far beyond the main path's (N = 510, K = 256: ~17 KB)
    // need the opt-in; it is a host-side setting, legal inside a capture.
    const cudaError_t err = cudaFuncSetAttribute(
        ransac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ransac_kernel<<<n_streams * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
