// Batched matvecs against each lane's cut slice, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_tr_kernel` in
// ldpc_tpu/ops/pallas/gemv_kernel.py (called by `batched_gemv` and
// `batched_gemv_t`): per lane, A x -> (T,) and A^T y -> (n,), where A is the
// lane's (T, n) float32 cut slice. The IPM (ldpc_tpu_torch/ops/ipm_solver.py)
// makes five such products per Newton step and two per chunk boundary. The
// plain PyTorch twins are `gemv_ref` and `gemv_t_ref` in
// ldpc_tpu_torch/ops/gemv_ref.py (torch.bmm).
//
// A is read in place: lane stride `lane_stride` elements (the decoder solves
// on a_buf[:, :T] of a (B, capacity, n) buffer), rows contiguous. The TPU
// kernel read a transposed bf16 copy (`prepare_gemv`), a choice of its vector
// unit's layout; bf16 or int8 storage is exact for +-1/0 cut rows and would
// halve or quarter the bytes, but needs a guard on the values, so it is later
// work.
//
// What bounds it: each product reads all of A once, 4 T n bytes per lane
// against 2 T n flops, so both kernels are bound by device memory (or L2)
// bandwidth: 202 MB per call at AGC-ALP's deepest tier (128 lanes,
// T = 1408, n = 280), about 60 us at 3.35 TB/s. The design keeps every load
// coalesced and many loads in flight:
//   - forward: one warp per row, lanes striding along n (128 B per warp
//     load), shuffle reduction; 8 rows per block, grid (ceil(T/8), B);
//   - transposed: a block owns 32 consecutive columns of one lane; its 8
//     warps each walk every 8th row (128 B per warp load, y[r] broadcast),
//     then sum their 8 partials through shared memory in a fixed order;
//     grid (ceil(n/32), B). No atomics, so the result does not change from
//     run to run.
//
// float32 with FMA throughout; no fast math, no TF32. The sums run in
// another order than the twin's, so the two agree to float32 rounding, not
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdRows = 8;     // rows (warps) per forward block
constexpr int kTrCols = 32;     // columns per transposed block
constexpr int kTrGroups = 8;    // row groups (warps) per transposed block
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out (B, T) = A x; a lane-strided, x (B, n), out (B, T) contiguous.
__global__ void gemv_fwd_kernel(const float* __restrict__ a,
                                const float* __restrict__ x,
                                float* __restrict__ out, int t, int n,
                                long long lane_stride) {
  extern __shared__ float sx[];  // this lane's x [n]
  const size_t l = blockIdx.y;
  const float* xl = x + l * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) sx[j] = xl[j];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kFwdRows + warp;
  if (r >= t) return;
  const float* row = a + l * static_cast<size_t>(lane_stride) +
                     static_cast<size_t>(r) * n;
  float acc = 0.f;
  for (int j = lane; j < n; j += 32) acc = fmaf(row[j], sx[j], acc);
  acc = warp_sum(acc);
  if (lane == 0) out[l * t + r] = acc;
}

// out (B, n) = A^T y; a lane-strided, y (B, T), out (B, n) contiguous.
__global__ void gemv_tr_kernel(const float* __restrict__ a,
                               const float* __restrict__ y,
                               float* __restrict__ out, int t, int n,
                               long long lane_stride) {
  __shared__ float part[kTrGroups][kTrCols + 1];
  const size_t l = blockIdx.y;
  const int j = blockIdx.x * kTrCols + threadIdx.x;
  const float* al = a + l * static_cast<size_t>(lane_stride);
  const float* yl = y + l * t;
  float acc = 0.f;
  if (j < n) {
#pragma unroll 4
    for (int r = threadIdx.y; r < t; r += kTrGroups)
      acc = fmaf(al[static_cast<size_t>(r) * n + j], yl[r], acc);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float s = part[0][threadIdx.x];
    for (int g = 1; g < kTrGroups; ++g) s += part[g][threadIdx.x];
    out[l * n + j] = s;
  }
}

}  // namespace

extern "C" {

// Launch A x for `batch` lanes on `stream`; returns the cudaError_t of the
// launch (0 on success). Does not synchronise.
int ldpc_gemv_fwd(const void* a, const void* x, void* out, int batch, int t,
                  int n, long long lane_stride, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (batch > kMaxGridY) return cudaErrorInvalidConfiguration;
  const dim3 grid((t + kFwdRows - 1) / kFwdRows, batch);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  gemv_fwd_kernel<<<grid, kFwdRows * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(out), t, n, lane_stride);
  return cudaGetLastError();
}

// Launch A^T y for `batch` lanes on `stream`; returns the cudaError_t of the
// launch (0 on success). Does not synchronise.
int ldpc_gemv_tr(const void* a, const void* y, void* out, int batch, int t,
                 int n, long long lane_stride, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (batch > kMaxGridY) return cudaErrorInvalidConfiguration;
  const dim3 grid((n + kTrCols - 1) / kTrCols, batch);
  const dim3 block(kTrCols, kTrGroups);
  gemv_tr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<float*>(out), t, n, lane_stride);
  return cudaGetLastError();
}

}  // extern "C"
