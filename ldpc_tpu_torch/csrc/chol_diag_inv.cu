// Factor and invert the diagonal blocks of the blocked Cholesky, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_diag_inv_kernel` in
// ldpc_tpu/ops/pallas/chol_kernel.py (called by `_chol_diag_inv`): for every
// lane, factor one SPD (nb, nb) diagonal block D = L L^T and invert the
// triangle, V = L^{-1}. ldpc_tpu_torch/ops/chol.py calls it once per block
// column of the IPM's normal matrix (five times per factorization at
// n = 280, nb = 64). The plain PyTorch twin is `chol_diag_inv_ref` in
// ldpc_tpu_torch/ops/chol_ref.py (torch.linalg.cholesky_ex and
// solve_triangular).
//
// Design: one block of 256 threads per lane; the block and its inverse stay
// in shared memory (2 nb (nb + 1) floats, 33 KB at nb = 64; rows padded by
// one float so that walking down a column hits 32 different banks).
//   1. Column recurrence (right-looking): for each column k, the pivot
//      s = sqrtf(D_kk) and r = 1 / s; column k below the diagonal is scaled
//      by r; the trailing lower triangle takes the rank-1 update
//      D_ij -= L_ik L_jk. One barrier after each of the two phases.
//   2. Forward substitution by rows for V: V_i. = (e_i - sum_{j<i} L_ij V_j.)
//      times 1 / L_ii, one thread per column, one barrier per row.
// Both are sequential in k and i (2 x 64 steps), so the kernel is bound by
// barrier latency, not by memory (32 KB in and out per lane) or flops
// (~nb^3 / 3 per lane): the TPU kernel instead ran every lane at once on its
// vector lanes; here the lanes run in parallel blocks.
//
// A pivot that is not positive gives NaN (sqrtf of a negative number, or
// 0 * inf), which spreads through the rest of that lane's factor and
// inverse and no further; there is no clamp. The IPM freezes such a lane.
//
// Square root: sqrtf and an IEEE division 1 / s, both correctly rounded
// (no fast math), not rsqrtf, whose approximation is off by up to 2 ulp; the
// TPU kernel used rsqrt. The cost is a few instructions per column, 64 per
// block. The twin's LAPACK factor divides by the pivot instead of
// multiplying by its reciprocal, so the two agree to float32 rounding of
// the recurrence, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chol_diag_inv_kernel(const float* __restrict__ d, float* __restrict__ l_out,
                     float* __restrict__ inv_out, int nb) {
  extern __shared__ float sm[];
  const int ld = nb + 1;
  float* m = sm;             // D, then L in its lower triangle [nb][ld]
  float* v = sm + nb * ld;   // V = L^{-1} [nb][ld]
  const size_t off = static_cast<size_t>(blockIdx.x) * nb * nb;
  const int tid = threadIdx.x;
  for (int e = tid; e < nb * nb; e += kThreads) {
    m[(e / nb) * ld + e % nb] = d[off + e];
  }
  __syncthreads();

  for (int k = 0; k < nb; ++k) {
    const float s = sqrtf(m[k * ld + k]);
    const float r = 1.f / s;
    __syncthreads();  // every thread has read the pivot
    if (tid == 0) m[k * ld + k] = s;
    for (int i = k + 1 + tid; i < nb; i += kThreads) m[i * ld + k] *= r;
    __syncthreads();
    const int w = nb - k - 1;
    for (int e = tid; e < w * w; e += kThreads) {
      const int i = k + 1 + e / w, j = k + 1 + e % w;
      if (j <= i) m[i * ld + j] -= m[i * ld + k] * m[j * ld + k];
    }
    __syncthreads();
  }

  for (int i = 0; i < nb; ++i) {
    const float inv_lii = 1.f / m[i * ld + i];
    for (int c = tid; c < nb; c += kThreads) {
      float out = 0.f;
      if (c == i) {
        out = inv_lii;
      } else if (c < i) {
        float acc = 0.f;
        for (int j = c; j < i; ++j)
          acc = fmaf(m[i * ld + j], v[j * ld + c], acc);
        out = -acc * inv_lii;
      }
      v[i * ld + c] = out;
    }
    __syncthreads();
  }

  for (int e = tid; e < nb * nb; e += kThreads) {
    const int i = e / nb, j = e % nb;
    l_out[off + e] = j <= i ? m[i * ld + j] : 0.f;
    inv_out[off + e] = v[i * ld + j];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
long long ldpc_chol_diag_inv_smem_bytes(int nb) {
  return 2LL * nb * (nb + 1) * static_cast<long long>(sizeof(float));
}

// Launch the factor and inverse of `batch` (nb, nb) blocks on `stream`;
// returns the cudaError_t of the launch (0 on success). Does not
// synchronise.
int ldpc_chol_diag_inv(const void* d, void* l, void* inv, int batch, int nb,
                       void* stream) {
  if (batch <= 0) return cudaSuccess;
  const long long smem = ldpc_chol_diag_inv_smem_bytes(nb);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chol_diag_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  chol_diag_inv_kernel<<<batch, kThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(l),
      static_cast<float*>(inv), nb);
  return cudaGetLastError();
}

}  // extern "C"
