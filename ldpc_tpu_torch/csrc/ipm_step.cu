// The IPM Newton step's two elementwise passes, for NVIDIA Hopper (sm_90a).
//
// No Pallas kernel stands behind these two. In ldpc_tpu/ops/ipm_solver.py
// XLA fuses the step's elementwise work: the step lengths (`_pos_step`,
// :39, used six times per direction at :222-227 and :239-243) and the
// masked update with its interior clamp (:247-267). Eager PyTorch runs
// them as about 50 and 30 small kernels per Newton step; here each is one
// launch. ldpc_tpu_torch/ops/ipm_kernel.py wraps them and picks the launch
// plan (`ipm_step_plan`); the plain twins are `ipm_step_len_ref` and
// `ipm_update_ref` in ldpc_tpu_torch/ops/ipm_ref.py.
//
// The layout (both kernels, one plan): one block a lane, of `threads`
// threads (the fewest warps, up to 1024, that give each thread 4 floats of
// each of the lane's arrays). A thread walks the lane in passes of
// 4 * threads floats, holding 4 floats of each array a pass: one float4
// (16-byte loads and stores, `vec` 4, where T and n are multiples of 4 and
// every array starts on 16 bytes) or 4 floats `threads` apart (`vec` 1).
// One pass covers T and n up to 4096, every shape the solve runs.
//
// ipm_step_len_kernel: in each pass a thread issues every load of its rows
// (s, ds, y, dy; float4s at `vec` 4) and columns (x, dx, w, zl, dzl, zu,
// dzu; always 4 floats `threads` apart, so that the columns' four ratios a
// float spread over all of the lane's threads and not the first n / 4)
// before its first ratio -v / dv (where dv < 0, else inf), and keeps the
// primal and the dual minimum; the block reduces both (warp shuffles, then
// the first warp over the warps' minima) and writes ap = min(1, frac * min)
// and ad the same way.
//
// ipm_update_kernel: each thread loads all of its first pass's entries, dx
// and dy included, and tests dx and dy for finiteness (and those of any
// later pass); the lane's verdict is __syncthreads_and before any write.
// Then each thread updates its entries from registers and stores them in
// place: ax, s, y along the rows, x, zl, zu along the columns, where the
// lane is finite; then the floors, the clamp of x and w = 1 - x. Where a
// lane fits one pass, dx and dy are read once.
//
// What bounds them on the solve's path. The bytes are few: at B = 128,
// T = 1408, n = 280 the step lengths read (4 T + 7 n) floats a lane
// (3.9 MB, 1.2 us at 3.35 TB/s) and the update reads (6 T + 6 n) and
// writes (3 T + 4 n) floats a lane (8.0 MB, 2.4 us), and the Newton step
// has just written them, so they come from the 50 MB L2. What is left is
// the launch, the latency of the loads and, in the step lengths, the
// chain of IEEE divisions and minima a thread runs. The first design's
// threads walked a strided loop of 4-byte loads, each step's loads
// waiting on the one before, and reread dx and dy; here every load a
// thread makes in a pass is in flight at once, so a kernel pays one round
// trip to L2 (or HBM), at most 12 divisions a thread at AGC-ALP's deepest
// tier, its reductions, and the launch floor (an empty kernel of the same
// grid as a CUDA-graph node, about 1.3 us on an H100; chip_smoke.py
// phase 7 measures it beside both, and times both with their inputs in
// L2, as on the path, and out of it, against the HBM bytes bound).
//
// Bit for bit with the twins, in any layout:
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
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Threads a block: each kernel is built twice, bounded for blocks of up
// to 512 threads (up to 128 registers a thread: the width-1 update needs
// 74) and of up to 1024 (64 registers, a little spill)
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

template <int VEC, int kBound>
__global__ void __launch_bounds__(kBound)
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
                        float* __restrict__ ap, float* __restrict__ ad, int t,
                        int n, float frac) {
  __shared__ float red[2][kMaxWarps];
  const size_t rt = static_cast<size_t>(blockIdx.x) * t;
  const size_t rn = static_cast<size_t>(blockIdx.x) * n;
  const int count = passes(t, n);
  float p = INFINITY, d = INFINITY;
  for (int pass = 0; pass < count; ++pass) {
    float vs[kPer] = {}, vds[kPer] = {}, vy[kPer] = {}, vdy[kPer] = {};
    float vx[kPer] = {}, vdx[kPer] = {}, vw[kPer] = {}, vzl[kPer] = {},
          vdzl[kPer] = {}, vzu[kPer] = {}, vdzu[kPer] = {};
    load<VEC, true>(s + rt, pass, t, vs);
    load<VEC, true>(ds + rt, pass, t, vds);
    load<VEC, true>(y + rt, pass, t, vy);
    load<VEC, true>(dy + rt, pass, t, vdy);
    // the columns' four ratios a float over all of the lane's threads
    load<1, true>(x + rn, pass, n, vx);
    load<1, true>(dx + rn, pass, n, vdx);
    load<1, true>(w + rn, pass, n, vw);
    load<1, true>(zl + rn, pass, n, vzl);
    load<1, true>(dzl + rn, pass, n, vdzl);
    load<1, true>(zu + rn, pass, n, vzu);
    load<1, true>(dzu + rn, pass, n, vdzu);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (at<VEC>(pass, r) < t) {
        p = min_nan(p, ratio(vs[r], vds[r]));
        d = min_nan(d, ratio(vy[r], vdy[r]));
      }
      if (at<1>(pass, r) < n) {
        p = min_nan(p, ratio(vx[r], vdx[r]));
        p = min_nan(p, ratio(vw[r], -vdx[r]));
        d = min_nan(d, ratio(vzl[r], vdzl[r]));
        d = min_nan(d, ratio(vzu[r], vdzu[r]));
      }
    }
  }
  p = warp_min(p);
  d = warp_min(d);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int wl = static_cast<int>(threadIdx.x) & 31;
  if (wl == 0) {
    red[0][warp] = p;
    red[1][warp] = d;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = static_cast<int>(blockDim.x) >> 5;
    p = warp_min(wl < warps ? red[0][wl] : INFINITY);
    d = warp_min(wl < warps ? red[1][wl] : INFINITY);
    if (wl == 0) {
      ap[blockIdx.x] = top_nan(__fmul_rn(frac, p), 1.0f);
      ad[blockIdx.x] = top_nan(__fmul_rn(frac, d), 1.0f);
    }
  }
}

template <int VEC, int kBound>
__global__ void __launch_bounds__(kBound)
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
  const size_t rt = static_cast<size_t>(blockIdx.x) * t;
  const size_t rn = static_cast<size_t>(blockIdx.x) * n;
  const int count = passes(t, n);
  float vax[kPer] = {}, vadx[kPer] = {}, vs[kPer] = {}, vds[kPer] = {},
        vy[kPer] = {}, vdy[kPer] = {};
  float vx[kPer] = {}, vdx[kPer] = {}, vzl[kPer] = {}, vdzl[kPer] = {},
        vzu[kPer] = {}, vdzu[kPer] = {}, vw[kPer];
  // every entry of a pass, into registers
  auto load_all = [&](int pass) {
    load<VEC, true>(dy + rt, pass, t, vdy);
    load<VEC, true>(dx + rn, pass, n, vdx);
    load<VEC, false>(ax + rt, pass, t, vax);
    load<VEC, true>(adx + rt, pass, t, vadx);
    load<VEC, false>(s + rt, pass, t, vs);
    load<VEC, true>(ds + rt, pass, t, vds);
    load<VEC, false>(y + rt, pass, t, vy);
    load<VEC, false>(x + rn, pass, n, vx);
    load<VEC, false>(zl + rn, pass, n, vzl);
    load<VEC, true>(dzl + rn, pass, n, vdzl);
    load<VEC, false>(zu + rn, pass, n, vzu);
    load<VEC, true>(dzu + rn, pass, n, vdzu);
  };
  // whether a pass's dy (along the rows) and dx (along the columns) are
  // finite
  auto finite = [&](int pass, const float(&ey)[kPer],
                    const float(&ex)[kPer]) {
    int fin = 1;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (at<VEC>(pass, r) < t && !isfinite(ey[r])) fin = 0;
      if (at<VEC>(pass, r) < n && !isfinite(ex[r])) fin = 0;
    }
    return fin;
  };
  load_all(0);
  const float a_p = __ldg(ap + blockIdx.x);
  const float a_d = __ldg(ad + blockIdx.x);
  int fin = finite(0, vdy, vdx);
  for (int pass = 1; pass < count; ++pass) {
    float ey[kPer] = {}, ex[kPer] = {};
    load<VEC, true>(dy + rt, pass, t, ey);
    load<VEC, true>(dx + rn, pass, n, ex);
    fin &= finite(pass, ey, ex);
  }
  const bool ok = __syncthreads_and(fin) != 0;
  for (int pass = 0; pass < count; ++pass) {
    if (pass > 0) load_all(pass);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (ok) {
        vax[r] = axpy(vax[r], a_p, vadx[r]);
        vs[r] = axpy(vs[r], a_p, vds[r]);
        vy[r] = axpy(vy[r], a_d, vdy[r]);
        vx[r] = axpy(vx[r], a_p, vdx[r]);
        vzl[r] = axpy(vzl[r], a_d, vdzl[r]);
        vzu[r] = axpy(vzu[r], a_d, vdzu[r]);
      }
      vs[r] = floor_nan(vs[r], lo);
      vy[r] = floor_nan(vy[r], lo);
      vx[r] = top_nan(floor_nan(vx[r], lo), hi);
      vw[r] = __fsub_rn(1.0f, vx[r]);
      vzl[r] = floor_nan(vzl[r], lo);
      vzu[r] = floor_nan(vzu[r], lo);
    }
    store<VEC>(ax + rt, pass, t, vax);
    store<VEC>(s + rt, pass, t, vs);
    store<VEC>(y + rt, pass, t, vy);
    store<VEC>(x + rn, pass, n, vx);
    store<VEC>(w + rn, pass, n, vw);
    store<VEC>(zl + rn, pass, n, vzl);
    store<VEC>(zu + rn, pass, n, vzu);
  }
}

__global__ void empty_kernel() {}

// Whether (vec, threads) is a legal launch for `batch` lanes of T rows and
// n columns: threads a multiple of 32 up to kMaxThreads, a lane's indices
// within int, and 16-byte access only where T and n are multiples of 4 and
// every array's lanes start on 16 bytes.
bool plan_ok(int batch, int t, int n, int vec, int threads,
             const void* const* arrays, int count) {
  const int len = t > n ? t : n;
  if (batch < 1 || t < 1 || n < 1 || threads < 32 || threads % 32 ||
      threads > kMaxThreads || len > INT_MAX - kPer * kMaxThreads)
    return false;
  if (vec == 1) return true;
  if (vec != 4 || t % 4 || n % 4) return false;
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(arrays[i]) % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// The step lengths of `batch` lanes (T rows, n columns each, every array
// contiguous float32) on `stream` by the plan (vec, threads) of
// ops/ipm_kernel.py's `ipm_step_plan`; returns the cudaError_t of the
// launch, cudaErrorInvalidValue for a plan that is not legal for the shape
// and pointers. Does not synchronise.
int ldpc_ipm_step_len(const void* s, const void* ds, const void* x,
                      const void* dx, const void* w, const void* y,
                      const void* dy, const void* zl, const void* dzl,
                      const void* zu, const void* dzu, void* ap, void* ad,
                      int batch, int t, int n, float frac, int vec,
                      int threads, void* stream) {
  const void* arrays[] = {s, ds, x, dx, w, y, dy, zl, dzl, zu, dzu};
  if (!plan_ok(batch, t, n, vec, threads, arrays, 11))
    return cudaErrorInvalidValue;
  const bool small = threads <= kSmallBlock;
  auto kernel = vec == 4 ? (small ? &ipm_step_len_kernel<4, kSmallBlock>
                                  : &ipm_step_len_kernel<4, kMaxThreads>)
                         : (small ? &ipm_step_len_kernel<1, kSmallBlock>
                                  : &ipm_step_len_kernel<1, kMaxThreads>);
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
// floors at `lo` and the top of the box at `hi`, on `stream`, by the same
// plan; returns the cudaError_t of the launch (cudaErrorInvalidValue as
// above). Does not synchronise.
int ldpc_ipm_update(void* x, void* w, void* s, void* y, void* zl, void* zu,
                    void* ax, const void* dx, const void* dy, const void* ds,
                    const void* dzl, const void* dzu, const void* adx,
                    const void* ap, const void* ad, int batch, int t, int n,
                    float lo, float hi, int vec, int threads, void* stream) {
  const void* arrays[] = {x, w, s, y, zl, zu, ax, dx, dy, ds, dzl, dzu, adx};
  if (!plan_ok(batch, t, n, vec, threads, arrays, 13))
    return cudaErrorInvalidValue;
  const bool small = threads <= kSmallBlock;
  auto kernel = vec == 4 ? (small ? &ipm_update_kernel<4, kSmallBlock>
                                  : &ipm_update_kernel<4, kMaxThreads>)
                         : (small ? &ipm_update_kernel<1, kSmallBlock>
                                  : &ipm_update_kernel<1, kMaxThreads>);
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// An empty kernel on `blocks` blocks of `threads` on `stream`: the launch
// floor the two kernels are measured against.
int ldpc_ipm_empty(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
