// The IPM Newton step's two elementwise passes, for NVIDIA Hopper (sm_90a).
//
// No Pallas kernel stands behind these two. In ldpc_tpu/ops/ipm_solver.py
// XLA fuses the step's elementwise work: the step lengths (`_pos_step`,
// :39, used six times per direction at :222-227 and :239-243) and the
// masked update with its interior clamp (:247-267). Eager PyTorch runs
// them as about 50 and 30 small kernels per Newton step; here each is one
// launch. ldpc_tpu_torch/ops/ipm_kernel.py wraps them; the plain twins are
// `ipm_step_len_ref` and `ipm_update_ref` in ldpc_tpu_torch/ops/ipm_ref.py.
//
// ipm_step_len_kernel: one block per lane. Each thread takes every
// kThreads-th entry of the lane's rows (s, ds, y, dy: T entries) and
// columns (x, dx, w, zl, dzl, zu, dzu: n entries), forms each ratio
// -v / dv where dv < 0 (else inf), keeps the primal and the dual minimum,
// and the block reduces both (warp shuffles, then one warp over the warps'
// minima). Thread 0 writes ap = min(1, frac * min) and ad the same way.
//
// ipm_update_kernel: one block per lane. The block first decides whether
// the lane's dx (n) and dy (T) are all finite (one __syncthreads_and),
// then each thread updates its entries in place: ax, s, y along the rows,
// x, zl, zu along the columns, where the lane is finite; then the floors,
// the clamp of x and w = 1 - x.
//
// What bounds them: bytes, and below that the launch. At B = 128,
// T = 1408, n = 280 the step lengths read (4 T + 7 n) floats a lane
// (3.9 MB, 1.2 us at 3.35 TB/s) and the update reads (6 T + 6 n) and
// writes (3 T + 4 n) floats a lane (8.0 MB, 2.4 us). Both are a few
// microseconds of work; the design takes one launch each and plain
// coalesced loads (neighbouring threads on neighbouring floats).
//
// Bit for bit with the twins:
//  * a minimum and a clamp are exact and do not depend on the order of
//    the entries; both keep NaN as PyTorch's do (NaN wins a minimum and
//    passes through a clamp);
//  * fl(frac * a) is monotone in a, so min(1, frac * min(all ratios))
//    equals the minimum of the three clamped `_pos_step`s;
//  * the division is IEEE (__fdiv_rn; ops/_build.py passes no fast-math
//    flag either);
//  * a multiply then an add is __fmul_rn then __fadd_rn: nvcc would
//    contract v + a * dv into one FMA, which rounds once where eager
//    PyTorch rounds twice;
//  * the floor and the top of the box come from the wrapper as float32
//    (1e-12f and 1.0f - 1e-12 == 1.0f), converted as PyTorch converts its
//    scalar arguments.
// A lane whose dx or dy holds NaN or inf keeps its iterate (then floored,
// as the twin does).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// torch.minimum and amin: NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// the ratio of `_pos_step`: -v / dv where dv < 0, else inf
__device__ __forceinline__ float ratio(float v, float dv) {
  return dv < 0.0f ? __fdiv_rn(-v, dv) : INFINITY;
}

// torch.clamp_min / clamp_max / clamp with scalar bounds: NaN passes
__device__ __forceinline__ float floor_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float top_nan(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// v + a * dv rounded twice, as eager PyTorch computes it
__device__ __forceinline__ float axpy(float v, float a, float dv) {
  return __fadd_rn(v, __fmul_rn(a, dv));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    ipm_step_len_kernel(const float* __restrict__ s,
                        const float* __restrict__ ds,
                        const float* __restrict__ x,
                        const float* __restrict__ dx,
                        const float* __restrict__ w,
                        const float* __restrict__ y,
                        const float* __restrict__ dy,
                        const float* __restrict__ zl,
                        const float* __restrict__ dzl,
                        const float* __restrict__ zu,
                        const float* __restrict__ dzu,
                        float* __restrict__ ap, float* __restrict__ ad,
                        int t, int n, float frac) {
  __shared__ float red[2][kWarps];
  const int lane = blockIdx.x;
  const size_t rt = static_cast<size_t>(lane) * t;
  const size_t rn = static_cast<size_t>(lane) * n;
  float p = INFINITY, d = INFINITY;
  for (int j = threadIdx.x; j < t; j += kThreads) {
    p = min_nan(p, ratio(s[rt + j], ds[rt + j]));
    d = min_nan(d, ratio(y[rt + j], dy[rt + j]));
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float dxi = dx[rn + i];
    p = min_nan(p, ratio(x[rn + i], dxi));
    p = min_nan(p, ratio(w[rn + i], -dxi));
    d = min_nan(d, ratio(zl[rn + i], dzl[rn + i]));
    d = min_nan(d, ratio(zu[rn + i], dzu[rn + i]));
  }
  p = warp_min(p);
  d = warp_min(d);
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  if (wl == 0) {
    red[0][warp] = p;
    red[1][warp] = d;
  }
  __syncthreads();
  if (warp == 0) {
    p = warp_min(wl < kWarps ? red[0][wl] : INFINITY);
    d = warp_min(wl < kWarps ? red[1][wl] : INFINITY);
    if (wl == 0) {
      ap[lane] = top_nan(__fmul_rn(frac, p), 1.0f);
      ad[lane] = top_nan(__fmul_rn(frac, d), 1.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ipm_update_kernel(float* __restrict__ x, float* __restrict__ w,
                      float* __restrict__ s, float* __restrict__ y,
                      float* __restrict__ zl, float* __restrict__ zu,
                      float* __restrict__ ax,
                      const float* __restrict__ dx,
                      const float* __restrict__ dy,
                      const float* __restrict__ ds,
                      const float* __restrict__ dzl,
                      const float* __restrict__ dzu,
                      const float* __restrict__ adx,
                      const float* __restrict__ ap,
                      const float* __restrict__ ad, int t, int n, float lo,
                      float hi) {
  const int lane = blockIdx.x;
  const size_t rt = static_cast<size_t>(lane) * t;
  const size_t rn = static_cast<size_t>(lane) * n;
  int fin = 1;
  for (int i = threadIdx.x; i < n; i += kThreads)
    fin &= isfinite(dx[rn + i]) ? 1 : 0;
  for (int j = threadIdx.x; j < t; j += kThreads)
    fin &= isfinite(dy[rt + j]) ? 1 : 0;
  const bool ok = __syncthreads_and(fin) != 0;
  const float a_p = ap[lane], a_d = ad[lane];
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const size_t k = rt + j;
    float axj = ax[k], sj = s[k], yj = y[k];
    if (ok) {
      axj = axpy(axj, a_p, adx[k]);
      sj = axpy(sj, a_p, ds[k]);
      yj = axpy(yj, a_d, dy[k]);
    }
    ax[k] = axj;
    s[k] = floor_nan(sj, lo);
    y[k] = floor_nan(yj, lo);
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const size_t k = rn + i;
    float xi = x[k], zli = zl[k], zui = zu[k];
    if (ok) {
      xi = axpy(xi, a_p, dx[k]);
      zli = axpy(zli, a_d, dzl[k]);
      zui = axpy(zui, a_d, dzu[k]);
    }
    xi = top_nan(floor_nan(xi, lo), hi);
    x[k] = xi;
    w[k] = __fsub_rn(1.0f, xi);
    zl[k] = floor_nan(zli, lo);
    zu[k] = floor_nan(zui, lo);
  }
}

}  // namespace

extern "C" {

// The step lengths of `batch` lanes (T rows, n columns each, every array
// contiguous float32) on `stream`; returns the cudaError_t of the launch.
// Does not synchronise.
int ldpc_ipm_step_len(const void* s, const void* ds, const void* x,
                      const void* dx, const void* w, const void* y,
                      const void* dy, const void* zl, const void* dzl,
                      const void* zu, const void* dzu, void* ap, void* ad,
                      int batch, int t, int n, float frac, void* stream) {
  if (batch <= 0) return cudaSuccess;
  ipm_step_len_kernel<<<batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(ds),
      static_cast<const float*>(x), static_cast<const float*>(dx),
      static_cast<const float*>(w), static_cast<const float*>(y),
      static_cast<const float*>(dy), static_cast<const float*>(zl),
      static_cast<const float*>(dzl), static_cast<const float*>(zu),
      static_cast<const float*>(dzu), static_cast<float*>(ap),
      static_cast<float*>(ad), t, n, frac);
  return cudaGetLastError();
}

// The masked update of `batch` lanes in place (x, w, s, y, zl, zu, ax),
// floors at `lo` and the top of the box at `hi`, on `stream`; returns the
// cudaError_t of the launch. Does not synchronise.
int ldpc_ipm_update(void* x, void* w, void* s, void* y, void* zl, void* zu,
                    void* ax, const void* dx, const void* dy, const void* ds,
                    const void* dzl, const void* dzu, const void* adx,
                    const void* ap, const void* ad, int batch, int t, int n,
                    float lo, float hi, void* stream) {
  if (batch <= 0) return cudaSuccess;
  ipm_update_kernel<<<batch, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(w),
      static_cast<float*>(s), static_cast<float*>(y),
      static_cast<float*>(zl), static_cast<float*>(zu),
      static_cast<float*>(ax), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<const float*>(ds),
      static_cast<const float*>(dzl), static_cast<const float*>(dzu),
      static_cast<const float*>(adx), static_cast<const float*>(ap),
      static_cast<const float*>(ad), t, n, lo, hi);
  return cudaGetLastError();
}

}  // extern "C"
