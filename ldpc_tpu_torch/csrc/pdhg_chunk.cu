// One PDHG chunk per LP lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ldpc_tpu/ops/pallas/pdhg_kernel.py
// (called by `pdhg_chunk_pallas`): `iters` preconditioned PDHG steps of
//
//     x <- clip_[0,1](x - tau * (c + A^T y))
//     y <- max(0, y + sigma * (A (2x' - x) - b))
//
// on every lane's own cut matrix A (T x n, rows +-1/0), then the lane's
// combined error max(max(A x - b, 0), relative duality gap) and, with
// `average`, the chunk's ergodic mean kept when its error is smaller. The
// plain PyTorch twin is ldpc_tpu_torch/ops/pdhg_ref.py (`pdhg_chunk_ref`).
//
// Design. One thread block per lane; the grid is the batch. The lane's
// vectors live in shared memory for the whole chunk: x, 2x'-x, c, tau (n
// each), y, b, sigma (T each), plus the running sums of x and y with
// `average`; 19.5 KB at n = 280, T = 896. Each step is two phases:
//   1. A^T y, one thread per column looping over the T rows: neighbouring
//      threads read neighbouring addresses of the row-major (T, n) slice;
//      the thread then applies the x update to its column;
//   2. A (2x' - x), one warp per row with a shuffle reduction; lane 0 of
//      the warp applies the y update to its row.
// A barrier closes each phase. The error at the end is one more pair of
// matvecs and block reductions for the violation, pobj and dobj.
//
// The TPU kernel grouped G lanes per program (`pick_group_size`) because one
// lane's rank-1 matmul left the MXU idle, and padded n and T to 128 for its
// tiles. Neither applies here: any n and any T >= 1, one lane per block, and
// the wrapper checks the shared-memory need against the card's opt-in limit
// and raises when it is over. An inactive lane (per lane, not per group)
// copies x and y through and writes error 0.
//
// What bounds it. A is read from device memory (through L2) twice per step:
// 8 T n bytes per lane-step, against 4 T n flops. At the ALP path's mid tier
// (T = 256, n = 280, 256 lanes) the batch's slices are 73 MB, more than the
// 50 MB L2, so each step streams 147 MB and the chunk is bound by device
// memory bandwidth (about 44 us per step at 3.35 TB/s). At the first tier
// (T = 128, 37 MB) the slices fit L2. Keeping A in shared memory (as int8,
// exact for +-1/0 rows) would remove that traffic; that is later work.
//
// float32 throughout with FMA contraction and IEEE division; no fast math and
// no TF32. The TPU stored A in bf16, which was exact there only because its
// MXU rounded the vector operand to bf16 anyway; here the reference is f32.
// The sums run in another order than the twin's torch.bmm, so the two agree
// to float32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 256;
constexpr int kScratch = 32;  // one float per warp for block reductions
constexpr int kDefaultSmemLimit = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (kMax false) or max (kMax true) of one value per thread,
// returned to every thread. blockDim.x is a multiple of 32.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // every thread has read the previous result
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : 0.f;
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

// max(max(A x - b, 0), (pobj - dobj) / (1 + |pobj| + |dobj|)) of one lane,
// with pobj = c.x and dobj = -b.y + sum(min(c + A^T y, 0)).
__device__ float lane_err(const float* __restrict__ a, const float* x,
                          const float* y, const float* c, const float* b,
                          int n, int t, float* scratch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  float viol = 0.f;
  for (int r = warp; r < t; r += nwarps) {
    const float* row = a + static_cast<size_t>(r) * n;
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) acc = fmaf(row[j], x[j], acc);
    acc = warp_sum(acc);
    viol = fmaxf(viol, acc - b[r]);
  }
  float cx = 0.f, rc_neg = 0.f, by = 0.f;
  for (int j = tid; j < n; j += nt) {
    float aty = 0.f;
    for (int r = 0; r < t; ++r)
      aty = fmaf(a[static_cast<size_t>(r) * n + j], y[r], aty);
    cx = fmaf(c[j], x[j], cx);
    rc_neg += fminf(c[j] + aty, 0.f);
  }
  for (int r = tid; r < t; r += nt) by = fmaf(b[r], y[r], by);
  viol = block_reduce<true>(viol, scratch);
  const float pobj = block_reduce<false>(cx, scratch);
  const float dobj = -block_reduce<false>(by, scratch) +
                     block_reduce<false>(rc_neg, scratch);
  const float gap = (pobj - dobj) / (1.f + fabsf(pobj) + fabsf(dobj));
  return fmaxf(viol, gap);
}

// c, tau, x_in, x_out (B, n); a (B, T, n) with lane stride `lane_stride`
// elements and rows contiguous; b, sigma, y_in, y_out (B, T); active (B,)
// bytes or null; err (B,). All float32 except `active`.
template <bool kAverage>
__global__ void pdhg_chunk_kernel(const float* __restrict__ c,
                                  const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ tau,
                                  const float* __restrict__ sigma,
                                  const float* __restrict__ x_in,
                                  const float* __restrict__ y_in,
                                  const uint8_t* __restrict__ active,
                                  float* __restrict__ x_out,
                                  float* __restrict__ y_out,
                                  float* __restrict__ err_out, int n, int t,
                                  long long lane_stride, int iters) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t l = blockIdx.x;
  const size_t vn = l * n, vt = l * t;
  if (active != nullptr && active[l] == 0) {
    for (int j = tid; j < n; j += nt) x_out[vn + j] = x_in[vn + j];
    for (int r = tid; r < t; r += nt) y_out[vt + r] = y_in[vt + r];
    if (tid == 0) err_out[l] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  float* sx = smem;              // x [n]
  float* sxbar = sx + n;         // 2x' - x [n]
  float* sc = sxbar + n;         // c [n]
  float* stau = sc + n;          // tau [n]
  float* sy = stau + n;          // y [t]
  float* sb = sy + t;            // b [t]
  float* ssig = sb + t;          // sigma [t]
  float* scratch = ssig + t;     // [kScratch]
  float* ssum_x = scratch + kScratch;  // running sum of x [n] (kAverage)
  float* ssum_y = ssum_x + n;          // running sum of y [t] (kAverage)

  const float* al = a + l * static_cast<size_t>(lane_stride);
  for (int j = tid; j < n; j += nt) {
    sx[j] = x_in[vn + j];
    sc[j] = c[vn + j];
    stau[j] = tau[vn + j];
    if (kAverage) ssum_x[j] = 0.f;
  }
  for (int r = tid; r < t; r += nt) {
    sy[r] = y_in[vt + r];
    sb[r] = b[vt + r];
    ssig[r] = sigma[vt + r];
    if (kAverage) ssum_y[r] = 0.f;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int it = 0; it < iters; ++it) {
    // 1. x <- clip(x - tau (c + A^T y)), one thread per column
    for (int j = tid; j < n; j += nt) {
      float aty = 0.f;
#pragma unroll 8
      for (int r = 0; r < t; ++r)
        aty = fmaf(al[static_cast<size_t>(r) * n + j], sy[r], aty);
      const float xo = sx[j];
      const float xn = fminf(fmaxf(xo - stau[j] * (sc[j] + aty), 0.f), 1.f);
      sx[j] = xn;
      sxbar[j] = 2.f * xn - xo;
      if (kAverage) ssum_x[j] += xn;
    }
    __syncthreads();
    // 2. y <- max(0, y + sigma (A (2x' - x) - b)), one warp per row
    for (int r = warp; r < t; r += nwarps) {
      const float* row = al + static_cast<size_t>(r) * n;
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) acc = fmaf(row[j], sxbar[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float yn = fmaxf(0.f, sy[r] + ssig[r] * (acc - sb[r]));
        sy[r] = yn;
        if (kAverage) ssum_y[r] += yn;
      }
    }
    __syncthreads();
  }

  const float e_last = lane_err(al, sx, sy, sc, sb, n, t, scratch);
  bool take_avg = false;
  float e = e_last;
  if (kAverage) {
    const float inv = 1.f / static_cast<float>(iters);
    for (int j = tid; j < n; j += nt) ssum_x[j] *= inv;
    for (int r = tid; r < t; r += nt) ssum_y[r] *= inv;
    __syncthreads();
    const float e_avg = lane_err(al, ssum_x, ssum_y, sc, sb, n, t, scratch);
    take_avg = e_avg < e_last;
    e = fminf(e_avg, e_last);
  }
  const float* xs = take_avg ? ssum_x : sx;
  const float* ys = take_avg ? ssum_y : sy;
  for (int j = tid; j < n; j += nt) x_out[vn + j] = xs[j];
  for (int r = tid; r < t; r += nt) y_out[vt + r] = ys[r];
  if (tid == 0) err_out[l] = e;
}

int threads_for(int n) {
  int threads = (n + 31) / 32 * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return threads;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
long long ldpc_pdhg_chunk_smem_bytes(int n, int t, int average) {
  const long long floats = 4LL * n + 3LL * t + kScratch +
                           (average ? static_cast<long long>(n) + t : 0LL);
  return floats * static_cast<long long>(sizeof(float));
}

// The largest dynamic shared memory a block may opt in to on `device`, or
// -1 when the attribute cannot be read.
int ldpc_smem_optin_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Launches one chunk for `batch` lanes on `stream`; returns the cudaError_t
// of the launch (0 on success). Does not synchronise. `active` may be null.
int ldpc_pdhg_chunk(const void* c, const void* a, const void* b,
                    const void* tau, const void* sigma, const void* x,
                    const void* y, const void* active, void* x_out,
                    void* y_out, void* err, int batch, int n, int t,
                    long long lane_stride, int iters, int average,
                    void* stream) {
  if (batch <= 0) return cudaSuccess;
  const int threads = threads_for(n);
  const long long smem = ldpc_pdhg_chunk_smem_bytes(n, t, average);
  auto kernel = average ? pdhg_chunk_kernel<true> : pdhg_chunk_kernel<false>;
  if (smem > kDefaultSmemLimit) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<batch, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(tau),
      static_cast<const float*>(sigma), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const uint8_t*>(active),
      static_cast<float*>(x_out), static_cast<float*>(y_out),
      static_cast<float*>(err), n, t, lane_stride, iters);
  return cudaGetLastError();
}

}  // extern "C"
