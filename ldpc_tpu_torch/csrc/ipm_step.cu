// The IPM Newton step's elementwise and per-lane work, for NVIDIA Hopper
// (sm_90a): three kernels around the step's matvecs, normal matrix, factor
// and solves.
//
// No Pallas kernel stands behind these. In ldpc_tpu/ops/ipm_solver.py XLA
// fuses the step's elementwise work and its per-lane sums (`newton`,
// :165-267): the residuals and mu, the diagonal scalings, the directions'
// targets and back-substitutions, the step lengths (`_pos_step`, :39),
// mu_aff and sigma, and the masked update with its interior clamp. Eager
// PyTorch ran them as about 100 small kernels a Newton step; here they are
// three launches. ldpc_tpu_torch/ops/ipm_kernel.py wraps them and picks the
// launch plan (`ipm_step_plan`); the plain twins are `ipm_prep_ref`,
// `ipm_predict_ref` and `ipm_correct_ref` in ldpc_tpu_torch/ops/ipm_ref.py,
// the eager ops they replace, unchanged. A Newton step
// (ops/ipm_solver.py `_newton`) is twelve launches:
//
//   A^T y, ipm_prep, the normal matrix, its factor,
//   rhs = -rd - A^T v + rl - ru (csrc/gemv.cu's A^T y with its epilogue),
//   the solve, A dx, ipm_predict, the same three for the corrector,
//   ipm_correct.
//
//   ipm_prep_kernel: rp = A x + s - b, rd = c + A^T y - zl + zu, mu, the
//     scalings y / s, zl / x, zu / w (clamped to [1e-10, 1e10]) and the
//     normal matrix's diagonal zl / x + zu / w, and the predictor's targets
//     ry = (0 - 0) / s - y, rl, ru and v = ry + (y / s) rp, A^T's input of
//     its right-hand side.
//   ipm_predict_kernel: from the predictor's dx and A dx, its ds, dy, dzl,
//     dzu, its step lengths, mu_aff = the complementarity after the step,
//     sigma = (mu_aff / mu)^3 clamped to [0, 1], and the corrector's
//     targets (sigma mu - dy ds) / s - y, ... and its v.
//   ipm_correct_kernel: the corrector's directions and step lengths and
//     the masked update: a lane whose dx or dy is not finite keeps its
//     iterate, then the floors, the clamp of x and w = 1 - x, in place.
//
// The layout (one plan for all three): one block a lane, of `threads`
// threads (the fewest warps, up to 1024, that give each thread 4 floats of
// each of the lane's arrays). A thread walks the lane in passes of
// 4 * threads floats, holding 4 floats of each array a pass: along the rows
// one float4 (16-byte loads and stores, `vec` 4, where T and n are
// multiples of 4 and every row array starts on 16 bytes) or 4 floats
// `threads` apart (`vec` 1); along the columns always 4 floats `threads`
// apart, so that the columns' work spreads over all of the lane's threads
// and not the first n / 4. One pass covers T and n up to 4096, every shape
// the solve runs. A kernel issues every load of a pass before its first
// use and keeps a pass's values in registers from one stage to the next
// (the step lengths, then the sums, then the targets or the update); where
// a lane takes several passes a stage reloads and recomputes them, which
// gives the same bits.
//
// The per-lane reductions: a thread folds its entries in pass order, a
// warp its threads by a butterfly of shuffles, then every thread folds the
// warps' results in warp order from shared memory. The minima are exact in
// any order; the sums (mu's and mu_aff's three: y s, zl x, zu w) run in
// this one fixed order, so a launch of a plan gives the same bits every
// time, and agree with the twin's sums to float32 rounding
// ((R + 2n) 2^-23 sum |terms| at most).
//
// What bounds them on the solve's path: the bytes are few (at B = 128,
// T = 1408, n = 280 a kernel moves 6-8 MB, 2-3 us at 3.35 TB/s) and the
// Newton step has just written most of them, so they come from the 50 MB
// L2. What is left is the launch, a round trip to L2 a stage, the chain of
// IEEE divisions a thread runs, and the reductions' barriers. chip_smoke.py
// phase 7 times each kernel beside its twin, the launch floor (an empty
// kernel of the same grid, `ldpc_ipm_empty`) and its bytes bound.
//
// Bit for bit with the twins, in any layout, for every elementwise output:
//  * each operation is the twin's in the twin's order: __fadd_rn, __fsub_rn,
//    __fmul_rn and __fdiv_rn (IEEE, rounded once each); nvcc would
//    contract a multiply and an add into one FMA, which rounds once where
//    eager PyTorch rounds twice, and ops/_build.py passes no fast-math flag;
//  * a minimum and a clamp keep NaN as PyTorch's do (NaN wins a minimum and
//    passes through a clamp), and are exact in any order;
//  * fl(frac * a) is monotone in a, so min(1, frac * min(all ratios))
//    equals the minimum of the three clamped `_pos_step`s;
//  * the bounds come from the wrapper as float32, converted as PyTorch
//    converts its scalar arguments (1.0 - 1e-12 rounds to 1.0f);
//  * the predictor's zero targets are computed as the twin computes them,
//    (0 - 0) / s - y.
// Outputs that follow a sum (mu_aff, sigma and the corrector's targets)
// equal the twin's given the kernel's sums.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Threads a block: each kernel is built twice, bounded for blocks of up
// to 512 threads (up to 128 registers a thread) and of up to 1024 (64
// registers; a lane that wide takes more than 2048 rows or columns)
constexpr int kMaxThreads = 1024;
constexpr int kSmallBlock = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPer = 4;           // floats of each array a thread holds

// torch.minimum and amin: NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// the ratio of `_pos_step`: -v / dv where dv < 0, else inf (divided
// either way, so that no branch keeps a thread's divisions apart)
__device__ __forceinline__ float ratio(float v, float dv) {
  const float q = __fdiv_rn(-v, dv);
  return dv < 0.0f ? q : INFINITY;
}

// torch.clamp_min / clamp_max / clamp with scalar bounds: NaN passes
__device__ __forceinline__ float floor_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float top_nan(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return top_nan(floor_nan(v, lo), hi);
}

// v + a * dv rounded twice, as eager PyTorch computes it
__device__ __forceinline__ float axpy(float v, float a, float dv) {
  return __fadd_rn(v, __fmul_rn(a, dv));
}

// a complementarity target: (sig_mu - extra) / v - z
__device__ __forceinline__ float target(float sig_mu, float extra, float v,
                                        float z) {
  return __fsub_rn(__fdiv_rn(__fsub_rn(sig_mu, extra), v), z);
}

// The index in its lane's array of float r of the thread's 4 in `pass`
// (the float is there where the index is below the array's length; at
// `vec` 4 the length is a multiple of 4, so a float4 is all in or all out).
template <int VEC>
__device__ __forceinline__ int at(int pass, int r) {
  const int k = static_cast<int>(threadIdx.x);
  const int m = static_cast<int>(blockDim.x);
  return VEC == 4 ? 4 * (pass * m + k) + r : (pass * kPer + r) * m + k;
}

// A thread's 4 floats of one array of a lane (`a` at the lane's start) in
// `pass`; kNc: through the read-only path (arrays the kernel does not
// write).
template <int VEC, bool kNc>
__device__ __forceinline__ void load(const float* a, int pass, int len,
                                     float (&v)[kPer]) {
  if (VEC == 4) {
    const int i = at<4>(pass, 0);
    if (i < len) {
      const float4* q = reinterpret_cast<const float4*>(a + i);
      const float4 f = kNc ? __ldg(q) : *q;
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = at<1>(pass, r);
      if (i < len) v[r] = kNc ? __ldg(a + i) : a[i];
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* a, int pass, int len,
                                      const float (&v)[kPer]) {
  if (VEC == 4) {
    const int i = at<4>(pass, 0);
    if (i < len)
      *reinterpret_cast<float4*>(a + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = at<1>(pass, r);
      if (i < len) a[i] = v[r];
    }
  }
}

// passes of 4 * blockDim.x floats that cover a lane of T rows, n columns
__device__ __forceinline__ int passes(int t, int n) {
  const int span = kPer * static_cast<int>(blockDim.x);
  return (max(t, n) + span - 1) / span;
}

// The block's fold of K values a thread, by `kSum` a sum (__fadd_rn) or a
// NaN-keeping minimum: a warp's butterfly, then every thread folds the
// warps' results in warp order. Every thread gets the same bits. `red`
// holds K x kMaxWarps floats; the block may reuse it on return.
template <int K, bool kSum>
__device__ __forceinline__ void block_fold(float (&v)[K],
                                           float (*red)[kMaxWarps]) {
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int wl = static_cast<int>(threadIdx.x) & 31;
  const int warps = static_cast<int>(blockDim.x) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = kSum ? __fadd_rn(v[k], o) : min_nan(v[k], o);
    }
    if (wl == 0) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float a = red[k][0];
    for (int i = 1; i < warps; ++i)
      a = kSum ? __fadd_rn(a, red[k][i]) : min_nan(a, red[k][i]);
    v[k] = a;
  }
  __syncthreads();
}

// A thread's values of one pass: the iterate's and a direction's.
struct Pass {
  // along the rows
  float s[kPer], y[kPer], rp[kPer], dys[kPer], ds[kPer], dy[kPer],
      ax[kPer], adx[kPer];
  // along the columns
  float x[kPer], w[kPer], zl[kPer], zu[kPer], dx[kPer], dzl[kPer],
      dzu[kPer];
};

// What the predict and the correct read of the prep's and of one
// direction's results (each (B, T) or (B, n)).
struct Terms {
  const float* rp;
  const float* dy_s;
  const float* dxl;
  const float* dxu;
  const float* ry;
  const float* rl;
  const float* ru;
  const float* dx;
  const float* adx;
};

// The iterate (x, w, s, y, zl, zu, ax); the correct writes it in place.
struct Iterate {
  float* x;
  float* w;
  float* s;
  float* y;
  float* zl;
  float* zu;
  float* ax;
};

// One pass of a direction's values from its dx and A dx, with the
// iterate's beside them (kNc: the iterate is read-only in this kernel; kAx:
// A x is read too):
//   ds = -rp - A dx, dy = ry - (y / s) ds, dzl = rl - (zl / x) dx,
//   dzu = ru + (zu / w) dx.
template <int VEC, bool kNc, bool kAx>
__device__ __forceinline__ void directions(Pass& p, const Iterate& it,
                                           const Terms& tm, size_t rt,
                                           size_t rn, int pass, int t,
                                           int n) {
  float ry[kPer] = {}, rl[kPer] = {}, ru[kPer] = {}, dxl[kPer] = {},
        dxu[kPer] = {};
  load<VEC, kNc>(it.s + rt, pass, t, p.s);
  load<VEC, kNc>(it.y + rt, pass, t, p.y);
  if (kAx) load<VEC, kNc>(it.ax + rt, pass, t, p.ax);
  load<VEC, true>(tm.rp + rt, pass, t, p.rp);
  load<VEC, true>(tm.dy_s + rt, pass, t, p.dys);
  load<VEC, true>(tm.ry + rt, pass, t, ry);
  load<VEC, true>(tm.adx + rt, pass, t, p.adx);
  load<1, kNc>(it.x + rn, pass, n, p.x);
  load<1, kNc>(it.w + rn, pass, n, p.w);
  load<1, kNc>(it.zl + rn, pass, n, p.zl);
  load<1, kNc>(it.zu + rn, pass, n, p.zu);
  load<1, true>(tm.dx + rn, pass, n, p.dx);
  load<1, true>(tm.dxl + rn, pass, n, dxl);
  load<1, true>(tm.dxu + rn, pass, n, dxu);
  load<1, true>(tm.rl + rn, pass, n, rl);
  load<1, true>(tm.ru + rn, pass, n, ru);
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    p.ds[r] = __fsub_rn(-p.rp[r], p.adx[r]);
    p.dy[r] = __fsub_rn(ry[r], __fmul_rn(p.dys[r], p.ds[r]));
    p.dzl[r] = __fsub_rn(rl[r], __fmul_rn(dxl[r], p.dx[r]));
    p.dzu[r] = __fadd_rn(ru[r], __fmul_rn(dxu[r], p.dx[r]));
  }
}

// The smallest primal and dual ratios of one pass (`_pos_step`'s), folded
// into m[0] and m[1].
template <int VEC>
__device__ __forceinline__ void ratios(const Pass& p, int pass, int t,
                                       int n, float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (at<VEC>(pass, r) < t) {
      m[0] = min_nan(m[0], ratio(p.s[r], p.ds[r]));
      m[1] = min_nan(m[1], ratio(p.y[r], p.dy[r]));
    }
    if (at<1>(pass, r) < n) {
      m[0] = min_nan(m[0], ratio(p.x[r], p.dx[r]));
      m[0] = min_nan(m[0], ratio(p.w[r], -p.dx[r]));
      m[1] = min_nan(m[1], ratio(p.zl[r], p.dzl[r]));
      m[1] = min_nan(m[1], ratio(p.zu[r], p.dzu[r]));
    }
  }
}

template <int VEC, int kBound>
__global__ void __launch_bounds__(kBound)
    ipm_prep_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ s, const float* __restrict__ y,
                    const float* __restrict__ zl,
                    const float* __restrict__ zu,
                    const float* __restrict__ ax,
                    const float* __restrict__ aty,
                    const float* __restrict__ cs,
                    const float* __restrict__ be,
                    const float* __restrict__ n_compl,
                    float* __restrict__ rp, float* __restrict__ rd,
                    float* __restrict__ mu, float* __restrict__ dy_s,
                    float* __restrict__ dxl, float* __restrict__ dxu,
                    float* __restrict__ dxx, float* __restrict__ ry,
                    float* __restrict__ rl, float* __restrict__ ru,
                    float* __restrict__ v, int t, int n, float lo,
                    float hi) {
  __shared__ float red[3][kMaxWarps];
  const size_t rt = static_cast<size_t>(blockIdx.x) * t;
  const size_t rn = static_cast<size_t>(blockIdx.x) * n;
  const int count = passes(t, n);
  float sum[3] = {0.0f, 0.0f, 0.0f};  // y s, zl x, zu w
  for (int pass = 0; pass < count; ++pass) {
    float vax[kPer] = {}, vs[kPer] = {}, vbe[kPer] = {}, vy[kPer] = {};
    float vx[kPer] = {}, vw[kPer] = {}, vzl[kPer] = {}, vzu[kPer] = {},
          vcs[kPer] = {}, vaty[kPer] = {};
    load<VEC, true>(ax + rt, pass, t, vax);
    load<VEC, true>(s + rt, pass, t, vs);
    load<VEC, true>(be + rt, pass, t, vbe);
    load<VEC, true>(y + rt, pass, t, vy);
    load<1, true>(x + rn, pass, n, vx);
    load<1, true>(w + rn, pass, n, vw);
    load<1, true>(zl + rn, pass, n, vzl);
    load<1, true>(zu + rn, pass, n, vzu);
    load<1, true>(cs + rn, pass, n, vcs);
    load<1, true>(aty + rn, pass, n, vaty);
    float orp[kPer], ody[kPer], ory[kPer], ov[kPer];
    float ord[kPer], odl[kPer], odu[kPer], odx[kPer], orl[kPer], oru[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      orp[r] = __fsub_rn(__fadd_rn(vax[r], vs[r]), vbe[r]);
      ody[r] = clamp_nan(__fdiv_rn(vy[r], vs[r]), lo, hi);
      ory[r] = target(0.0f, 0.0f, vs[r], vy[r]);
      ov[r] = axpy(ory[r], ody[r], orp[r]);
      if (at<VEC>(pass, r) < t)
        sum[0] = __fadd_rn(sum[0], __fmul_rn(vy[r], vs[r]));
      ord[r] = __fadd_rn(__fsub_rn(__fadd_rn(vcs[r], vaty[r]), vzl[r]),
                         vzu[r]);
      odl[r] = clamp_nan(__fdiv_rn(vzl[r], vx[r]), lo, hi);
      odu[r] = clamp_nan(__fdiv_rn(vzu[r], vw[r]), lo, hi);
      odx[r] = __fadd_rn(odl[r], odu[r]);
      orl[r] = target(0.0f, 0.0f, vx[r], vzl[r]);
      oru[r] = target(0.0f, 0.0f, vw[r], vzu[r]);
      if (at<1>(pass, r) < n) {
        sum[1] = __fadd_rn(sum[1], __fmul_rn(vzl[r], vx[r]));
        sum[2] = __fadd_rn(sum[2], __fmul_rn(vzu[r], vw[r]));
      }
    }
    store<VEC>(rp + rt, pass, t, orp);
    store<VEC>(dy_s + rt, pass, t, ody);
    store<VEC>(ry + rt, pass, t, ory);
    store<VEC>(v + rt, pass, t, ov);
    store<1>(rd + rn, pass, n, ord);
    store<1>(dxl + rn, pass, n, odl);
    store<1>(dxu + rn, pass, n, odu);
    store<1>(dxx + rn, pass, n, odx);
    store<1>(rl + rn, pass, n, orl);
    store<1>(ru + rn, pass, n, oru);
  }
  block_fold<3, true>(sum, red);
  if (threadIdx.x == 0)
    mu[blockIdx.x] = __fdiv_rn(__fadd_rn(__fadd_rn(sum[0], sum[1]), sum[2]),
                               __ldg(n_compl));
}

template <int VEC, int kBound>
__global__ void __launch_bounds__(kBound)
    ipm_predict_kernel(Iterate it, Terms tm, const float* __restrict__ mu,
                       const float* __restrict__ n_compl,
                       float* __restrict__ ap, float* __restrict__ ad,
                       float* __restrict__ mu_aff, float* __restrict__ ry_c,
                       float* __restrict__ rl_c, float* __restrict__ ru_c,
                       float* __restrict__ v_c, int t, int n, float frac,
                       float mu_lo) {
  __shared__ float red[3][kMaxWarps];
  const size_t rt = static_cast<size_t>(blockIdx.x) * t;
  const size_t rn = static_cast<size_t>(blockIdx.x) * n;
  const int count = passes(t, n);
  Pass p = {};
  // 1. the step lengths
  float m[2] = {INFINITY, INFINITY};
  for (int pass = 0; pass < count; ++pass) {
    directions<VEC, true, false>(p, it, tm, rt, rn, pass, t, n);
    ratios<VEC>(p, pass, t, n, m);
  }
  block_fold<2, false>(m, red);
  const float a_p = top_nan(__fmul_rn(frac, m[0]), 1.0f);
  const float a_d = top_nan(__fmul_rn(frac, m[1]), 1.0f);
  // 2. mu_aff: the complementarity after the affine step
  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int pass = 0; pass < count; ++pass) {
    if (count > 1) directions<VEC, true, false>(p, it, tm, rt, rn, pass, t, n);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (at<VEC>(pass, r) < t)
        sum[0] = __fadd_rn(sum[0], __fmul_rn(axpy(p.y[r], a_d, p.dy[r]),
                                             axpy(p.s[r], a_p, p.ds[r])));
      if (at<1>(pass, r) < n) {
        sum[1] = __fadd_rn(sum[1], __fmul_rn(axpy(p.zl[r], a_d, p.dzl[r]),
                                             axpy(p.x[r], a_p, p.dx[r])));
        sum[2] = __fadd_rn(
            sum[2], __fmul_rn(axpy(p.zu[r], a_d, p.dzu[r]),
                              __fsub_rn(p.w[r], __fmul_rn(a_p, p.dx[r]))));
      }
    }
  }
  block_fold<3, true>(sum, red);
  const float maff = __fdiv_rn(__fadd_rn(__fadd_rn(sum[0], sum[1]), sum[2]),
                               __ldg(n_compl));
  const float mu_l = __ldg(mu + blockIdx.x);
  const float q = __fdiv_rn(maff, floor_nan(mu_l, mu_lo));
  const float sig_mu =
      __fmul_rn(clamp_nan(__fmul_rn(q, __fmul_rn(q, q)), 0.0f, 1.0f), mu_l);
  // 3. the corrector's targets and v
  for (int pass = 0; pass < count; ++pass) {
    if (count > 1) directions<VEC, true, false>(p, it, tm, rt, rn, pass, t, n);
    float ory[kPer], ov[kPer], orl[kPer], oru[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      ory[r] = target(sig_mu, __fmul_rn(p.dy[r], p.ds[r]), p.s[r], p.y[r]);
      ov[r] = axpy(ory[r], p.dys[r], p.rp[r]);
      orl[r] = target(sig_mu, __fmul_rn(p.dzl[r], p.dx[r]), p.x[r], p.zl[r]);
      oru[r] = target(sig_mu, __fmul_rn(-p.dzu[r], p.dx[r]), p.w[r],
                      p.zu[r]);
    }
    store<VEC>(ry_c + rt, pass, t, ory);
    store<VEC>(v_c + rt, pass, t, ov);
    store<1>(rl_c + rn, pass, n, orl);
    store<1>(ru_c + rn, pass, n, oru);
  }
  if (threadIdx.x == 0) {
    ap[blockIdx.x] = a_p;
    ad[blockIdx.x] = a_d;
    mu_aff[blockIdx.x] = maff;
  }
}

template <int VEC, int kBound>
__global__ void __launch_bounds__(kBound)
    ipm_correct_kernel(Iterate it, Terms tm, float* __restrict__ ap,
                       float* __restrict__ ad, int t, int n, float frac,
                       float lo, float hi) {
  __shared__ float red[2][kMaxWarps];
  const size_t rt = static_cast<size_t>(blockIdx.x) * t;
  const size_t rn = static_cast<size_t>(blockIdx.x) * n;
  const int count = passes(t, n);
  Pass p = {};
  // 1. the step lengths, and whether the lane's dx and dy are finite
  float m[2] = {INFINITY, INFINITY};
  int fin = 1;
  for (int pass = 0; pass < count; ++pass) {
    directions<VEC, false, true>(p, it, tm, rt, rn, pass, t, n);
    ratios<VEC>(p, pass, t, n, m);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (at<VEC>(pass, r) < t && !isfinite(p.dy[r])) fin = 0;
      if (at<1>(pass, r) < n && !isfinite(p.dx[r])) fin = 0;
    }
  }
  block_fold<2, false>(m, red);
  const bool ok = __syncthreads_and(fin) != 0;
  const float a_p = top_nan(__fmul_rn(frac, m[0]), 1.0f);
  const float a_d = top_nan(__fmul_rn(frac, m[1]), 1.0f);
  // 2. the masked update, in place
  for (int pass = 0; pass < count; ++pass) {
    if (count > 1) directions<VEC, false, true>(p, it, tm, rt, rn, pass, t, n);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (ok) {
        p.ax[r] = axpy(p.ax[r], a_p, p.adx[r]);
        p.x[r] = axpy(p.x[r], a_p, p.dx[r]);
        p.s[r] = axpy(p.s[r], a_p, p.ds[r]);
        p.y[r] = axpy(p.y[r], a_d, p.dy[r]);
        p.zl[r] = axpy(p.zl[r], a_d, p.dzl[r]);
        p.zu[r] = axpy(p.zu[r], a_d, p.dzu[r]);
      }
      p.x[r] = clamp_nan(p.x[r], lo, hi);
      p.w[r] = __fsub_rn(1.0f, p.x[r]);
      p.s[r] = floor_nan(p.s[r], lo);
      p.y[r] = floor_nan(p.y[r], lo);
      p.zl[r] = floor_nan(p.zl[r], lo);
      p.zu[r] = floor_nan(p.zu[r], lo);
    }
    store<VEC>(it.ax + rt, pass, t, p.ax);
    store<VEC>(it.s + rt, pass, t, p.s);
    store<VEC>(it.y + rt, pass, t, p.y);
    store<1>(it.x + rn, pass, n, p.x);
    store<1>(it.w + rn, pass, n, p.w);
    store<1>(it.zl + rn, pass, n, p.zl);
    store<1>(it.zu + rn, pass, n, p.zu);
  }
  if (threadIdx.x == 0) {
    ap[blockIdx.x] = a_p;
    ad[blockIdx.x] = a_d;
  }
}

__global__ void empty_kernel() {}

// Whether (vec, threads) is a legal launch for `batch` lanes of T rows and
// n columns: threads a multiple of 32 up to kMaxThreads, a lane's indices
// within int, and 16-byte access only where T and n are multiples of 4 and
// every row array's lanes start on 16 bytes.
bool plan_ok(int batch, int t, int n, int vec, int threads,
             const void* const* rows, int count) {
  const int len = t > n ? t : n;
  if (batch < 1 || t < 1 || n < 1 || threads < 32 || threads % 32 ||
      threads > kMaxThreads || len > INT_MAX - kPer * kMaxThreads)
    return false;
  if (vec == 1) return true;
  if (vec != 4 || t % 4 || n % 4) return false;
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(rows[i]) % 16) return false;
  return true;
}

// The kernel built for the plan's width and block size.
template <class K>
K pick(int vec, int threads, K v4s, K v4l, K v1s, K v1l) {
  const bool small = threads <= kSmallBlock;
  return vec == 4 ? (small ? v4s : v4l) : (small ? v1s : v1l);
}

const float* cf(const void* p) { return static_cast<const float*>(p); }
float* mf(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

// ipm_prep for `batch` lanes (T rows, n columns each, every array
// contiguous float32): reads the iterate (x, w, s, y, zl, zu, ax), A^T y,
// the scaled objective cs, the rhs be and n_compl (one float: R + 2n);
// writes rp, rd, mu (batch,), dy_s, dxl, dxu, dxx, ry, rl, ru and v, the
// scalings clamped to [lo, hi]; on `stream` by the plan (vec, threads) of
// ops/ipm_kernel.py's `ipm_step_plan`. Returns the cudaError_t of the
// launch, cudaErrorInvalidValue for a plan that is not legal for the shape
// and pointers. Does not synchronise.
int ldpc_ipm_prep(const void* x, const void* w, const void* s, const void* y,
                  const void* zl, const void* zu, const void* ax,
                  const void* aty, const void* cs, const void* be,
                  const void* n_compl, void* rp, void* rd, void* mu,
                  void* dy_s, void* dxl, void* dxu, void* dxx, void* ry,
                  void* rl, void* ru, void* v, int batch, int t, int n,
                  float lo, float hi, int vec, int threads, void* stream) {
  const void* rows[] = {s, y, ax, be, rp, dy_s, ry, v};
  if (!plan_ok(batch, t, n, vec, threads, rows, 8))
    return cudaErrorInvalidValue;
  auto kernel = pick(vec, threads, &ipm_prep_kernel<4, kSmallBlock>,
                     &ipm_prep_kernel<4, kMaxThreads>,
                     &ipm_prep_kernel<1, kSmallBlock>,
                     &ipm_prep_kernel<1, kMaxThreads>);
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cf(x), cf(w), cf(s), cf(y), cf(zl), cf(zu), cf(ax), cf(aty), cf(cs),
      cf(be), cf(n_compl), mf(rp), mf(rd), mf(mu), mf(dy_s), mf(dxl),
      mf(dxu), mf(dxx), mf(ry), mf(rl), mf(ru), mf(v), t, n, lo, hi);
  return cudaGetLastError();
}

// ipm_predict for `batch` lanes: reads the iterate (x, w, s, y, zl, zu),
// the prep's rp, dy_s, dxl, dxu, ry, rl, ru and mu, the predictor's dx and
// A dx, and n_compl; writes the predictor's step lengths ap and ad, mu_aff
// (each (batch,)) and the corrector's ry_c, rl_c, ru_c and v_c; mu floored
// at `mu_lo` in sigma's ratio; by the same plan. Returns as above.
int ldpc_ipm_predict(const void* x, const void* w, const void* s,
                     const void* y, const void* zl, const void* zu,
                     const void* rp, const void* dy_s, const void* dxl,
                     const void* dxu, const void* ry, const void* rl,
                     const void* ru, const void* dx, const void* adx,
                     const void* mu, const void* n_compl, void* ap, void* ad,
                     void* mu_aff, void* ry_c, void* rl_c, void* ru_c,
                     void* v_c, int batch, int t, int n, float frac,
                     float mu_lo, int vec, int threads, void* stream) {
  const void* rows[] = {s, y, rp, dy_s, ry, adx, ry_c, v_c};
  if (!plan_ok(batch, t, n, vec, threads, rows, 8))
    return cudaErrorInvalidValue;
  auto kernel = pick(vec, threads, &ipm_predict_kernel<4, kSmallBlock>,
                     &ipm_predict_kernel<4, kMaxThreads>,
                     &ipm_predict_kernel<1, kSmallBlock>,
                     &ipm_predict_kernel<1, kMaxThreads>);
  // the iterate is only read here
  const Iterate it{const_cast<float*>(cf(x)), const_cast<float*>(cf(w)),
                   const_cast<float*>(cf(s)), const_cast<float*>(cf(y)),
                   const_cast<float*>(cf(zl)), const_cast<float*>(cf(zu)),
                   nullptr};
  const Terms tm{cf(rp), cf(dy_s), cf(dxl), cf(dxu), cf(ry),
                 cf(rl), cf(ru), cf(dx), cf(adx)};
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      it, tm, cf(mu), cf(n_compl), mf(ap), mf(ad), mf(mu_aff), mf(ry_c),
      mf(rl_c), mf(ru_c), mf(v_c), t, n, frac, mu_lo);
  return cudaGetLastError();
}

// ipm_correct for `batch` lanes: the corrector's directions from the
// predictor's rp, dy_s, dxl, dxu, its own ry, rl, ru, dx and A dx; its step
// lengths into ap and ad; the iterate (x, w, s, y, zl, zu, ax) updated in
// place, floored at `lo` and x clamped to [lo, hi]; by the same plan.
// Returns as above.
int ldpc_ipm_correct(void* x, void* w, void* s, void* y, void* zl, void* zu,
                     void* ax, const void* rp, const void* dy_s,
                     const void* dxl, const void* dxu, const void* ry,
                     const void* rl, const void* ru, const void* dx,
                     const void* adx, void* ap, void* ad, int batch, int t,
                     int n, float frac, float lo, float hi, int vec,
                     int threads, void* stream) {
  const void* rows[] = {s, y, ax, rp, dy_s, ry, adx};
  if (!plan_ok(batch, t, n, vec, threads, rows, 7))
    return cudaErrorInvalidValue;
  auto kernel = pick(vec, threads, &ipm_correct_kernel<4, kSmallBlock>,
                     &ipm_correct_kernel<4, kMaxThreads>,
                     &ipm_correct_kernel<1, kSmallBlock>,
                     &ipm_correct_kernel<1, kMaxThreads>);
  const Iterate it{mf(x), mf(w), mf(s), mf(y), mf(zl), mf(zu), mf(ax)};
  const Terms tm{cf(rp), cf(dy_s), cf(dxl), cf(dxu), cf(ry),
                 cf(rl), cf(ru), cf(dx), cf(adx)};
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      it, tm, mf(ap), mf(ad), t, n, frac, lo, hi);
  return cudaGetLastError();
}

// An empty kernel on `blocks` blocks of `threads` on `stream`: the launch
// floor the three kernels are measured against.
int ldpc_ipm_empty(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
