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
// What bounds it. The work is small (32 KB in and out, ~nb^3 / 3 flops per
// lane) and sequential: 64 dependent columns, each a square root, a
// division and a rank-1 update. The time is the latency of that chain. A
// block of 256 threads per lane with three block barriers per column (the
// first version of this kernel) spent it waiting at 256 barriers.
//
// Design: one warp per lane, two lanes per block (kLanesPerBlock; 1, 2, 4
// and 8 were measured as variant builds, PERF.md), and no block barrier at
// all (the lanes of a block share nothing).
//   1. The warp stages its lane's block through shared memory (coalesced
//      16-byte loads when nb is 64 and the pointers are 16-byte aligned,
//      else one float at a time) and each thread takes two rows into
//      registers: row t (columns 0..31, all a row below 32 needs) and row
//      t + 32 (columns 0..63). A block smaller than 64 is padded with the
//      identity, whose factor and inverse are the identity and never touch
//      the lane's rows.
//   2. Right-looking column recurrence, fully unrolled so that every
//      register index is a constant: the threads write column k to one of
//      two small shared buffers, one __syncwarp, and every thread reads
//      the pivot and the column back as broadcasts, takes s = sqrtf(pivot)
//      and r = 1 / s, scales its rows' entry k, and updates its rows with
//      L_jk = D_jk * r. One __syncwarp per column orders the steps (the
//      double buffer spares the second); nothing else synchronises.
//   3. L goes back to the lane's shared memory (one __syncwarp) and the
//      inverse goes by columns: thread t solves L v = e_c for c = t (rows
//      0..63) and c = t + 32 (rows 32..63) by forward substitution in
//      registers, reading each L_ij as a broadcast. Columns are independent,
//      so the inverse needs no barrier at all. The sums run over j = c .. i-1
//      in order (the zeros above c add nothing), as in the first version.
//   4. L (zero above the diagonal) and V leave through shared memory with
//      coalesced 16-byte stores (or one float at a time, as in step 1).
// A row pitch of 68 floats keeps rows 16-byte aligned and makes both a
// thread's row loads and a warp's column stores free of bank conflicts.
//
// A pivot that is not positive gives NaN (sqrtf of a negative number, or
// 0 * inf), which spreads through the rest of that lane's factor and
// inverse and no further; there is no clamp. The IPM freezes such a lane.
//
// Square root: sqrtf and an IEEE division 1 / s, both correctly rounded
// (no fast math), not rsqrtf, whose approximation is off by up to 2 ulp; the
// TPU kernel used rsqrt. The twin's LAPACK factor divides by the pivot
// instead of multiplying by its reciprocal, so the two agree to float32
// rounding of the recurrence, not bit for bit. Repeat calls are
// bit-identical.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNb = 64;               // the block the kernel factors
constexpr int kLd = kNb + 4;          // row pitch in shared memory, floats
// the block, 1 / L_ii, and two column buffers
constexpr int kLaneFloats = kNb * kLd + 3 * kNb;
constexpr int kLanesPerBlock = 2;
constexpr int kSmemBytes = kLanesPerBlock * kLaneFloats * sizeof(float);
static_assert(kSmemBytes <= 48 * 1024,
              "more lanes per block need the opt-in to more shared memory");

// vec: nb == 64 and d, l_out, inv_out 16-byte aligned (float4 accesses)
__global__ void __launch_bounds__(kLanesPerBlock * 32)
chol_diag_inv_kernel(const float* __restrict__ d, float* __restrict__ l_out,
                     float* __restrict__ inv_out, int batch, int nb,
                     bool vec) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x & 31;
  const long long lane = static_cast<long long>(blockIdx.x) * kLanesPerBlock +
                         (threadIdx.x >> 5);
  if (lane >= batch) return;
  float* buf = sm + (threadIdx.x >> 5) * kLaneFloats;  // [kNb][kLd]
  float* dinv = buf + kNb * kLd;                        // [kNb]
  float* cols = dinv + kNb;                             // [2][kNb]
  const size_t off = static_cast<size_t>(lane) * nb * nb;

  // 1. stage the block, identity outside nb
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(d + off);
    for (int e = t; e < kNb * kNb / 4; e += 32) {
      const int i = e >> 4, c = (e & 15) * 4;
      *reinterpret_cast<float4*>(buf + i * kLd + c) = __ldg(src + e);
    }
  } else {
    for (int e = t; e < kNb * kNb; e += 32) {
      const int i = e / kNb, j = e % kNb;
      buf[i * kLd + j] = (i < nb && j < nb) ? __ldg(d + off + i * nb + j)
                                            : (i == j ? 1.f : 0.f);
    }
  }
  __syncwarp();
  float a0[32];  // row t, columns 0..31
  float a1[64];  // row t + 32, columns 0..63
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(buf + t * kLd + 4 * q);
    a0[4 * q] = v.x;
    a0[4 * q + 1] = v.y;
    a0[4 * q + 2] = v.z;
    a0[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(buf + (t + 32) * kLd + 4 * q);
    a1[4 * q] = v.x;
    a1[4 * q + 1] = v.y;
    a1[4 * q + 2] = v.z;
    a1[4 * q + 3] = v.w;
  }

  // 2. the factor: column k of rows i > k scaled by 1 / L_kk, then
  // D_ij -= L_ik L_jk for k < j <= i. Column k goes through one of two
  // shared buffers (the other may still be read by the previous step), is
  // read back as broadcasts, and each L_jk = D_jk * r is the same product
  // its owner makes. Entries above the diagonal take the same update with
  // garbage and are never read.
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float* col = cols + (k & 1) * kNb;
    if (k < 32) col[t] = a0[k & 31];
    col[t + 32] = a1[k];
    __syncwarp();
    const float s = sqrtf(col[k]);
    const float r = 1.f / s;
    if (k < 32)
      a0[k & 31] = t > k ? a0[k & 31] * r : (t == k ? s : a0[k & 31]);
    a1[k] = t + 32 > k ? a1[k] * r : (t + 32 == k ? s : a1[k]);
#pragma unroll
    for (int j = k + 1; j < kNb; ++j) {
      const float ljk = col[j] * r;
      if (j < 32) a0[j & 31] = fmaf(-a0[k & 31], ljk, a0[j & 31]);
      a1[j] = fmaf(-a1[k], ljk, a1[j]);
    }
  }

  // 3. L to shared memory, 1 / L_ii beside it
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q)
    *reinterpret_cast<float4*>(buf + t * kLd + 4 * q) =
        make_float4(a0[4 * q], a0[4 * q + 1], a0[4 * q + 2], a0[4 * q + 3]);
#pragma unroll
  for (int q = 0; q < 16; ++q)
    *reinterpret_cast<float4*>(buf + (t + 32) * kLd + 4 * q) =
        make_float4(a1[4 * q], a1[4 * q + 1], a1[4 * q + 2], a1[4 * q + 3]);
  dinv[t] = 1.f / buf[t * kLd + t];
  dinv[t + 32] = 1.f / buf[(t + 32) * kLd + t + 32];
  __syncwarp();

  // L out, zero above the diagonal
  if (vec) {
    float4* dst = reinterpret_cast<float4*>(l_out + off);
    for (int e = t; e < kNb * kNb / 4; e += 32) {
      const int i = e >> 4, c = (e & 15) * 4;
      float4 v = *reinterpret_cast<const float4*>(buf + i * kLd + c);
      v.x = c <= i ? v.x : 0.f;
      v.y = c + 1 <= i ? v.y : 0.f;
      v.z = c + 2 <= i ? v.z : 0.f;
      v.w = c + 3 <= i ? v.w : 0.f;
      dst[e] = v;
    }
  } else {
    for (int e = t; e < nb * nb; e += 32) {
      const int i = e / nb, j = e % nb;
      l_out[off + e] = j <= i ? buf[i * kLd + j] : 0.f;
    }
  }

  // 4. the inverse by columns: v_c = 1 / L_cc, v_i = -(sum_j L_ij v_j) / L_ii
  float v0[64];  // column t, rows 0..63
  float v1[32];  // column t + 32, rows 32..63
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    const float di = dinv[i];
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int q = 0; q < (i + 3) / 4; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(buf + i * kLd + 4 * q);
      const float lw[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * q + u;
        if (j < i) {
          acc0 = fmaf(lw[u], v0[j], acc0);
          if (j >= 32) acc1 = fmaf(lw[u], v1[j - 32], acc1);
        }
      }
    }
    v0[i] = t == i ? di : (t < i ? -acc0 * di : 0.f);
    if (i >= 32)
      v1[i - 32] = t + 32 == i ? di : (t + 32 < i ? -acc1 * di : 0.f);
  }

  // V out through shared memory
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    buf[i * kLd + t] = v0[i];
    buf[i * kLd + 32 + t] = i >= 32 ? v1[i - 32] : 0.f;
  }
  __syncwarp();
  if (vec) {
    float4* dst = reinterpret_cast<float4*>(inv_out + off);
    for (int e = t; e < kNb * kNb / 4; e += 32) {
      const int i = e >> 4, c = (e & 15) * 4;
      dst[e] = *reinterpret_cast<const float4*>(buf + i * kLd + c);
    }
  } else {
    for (int e = t; e < nb * nb; e += 32)
      inv_out[off + e] = buf[(e / nb) * kLd + e % nb];
  }
}

}  // namespace

extern "C" {

// Launch the factor and inverse of `batch` (nb, nb) blocks, nb <= 64, one
// warp per lane and kLanesPerBlock lanes per block, on `stream`; returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for an nb
// the kernel does not take). Does not synchronise.
int ldpc_chol_diag_inv(const void* d, void* l, void* inv, int batch, int nb,
                       void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (nb < 1 || nb > kNb) return cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(d) |
                         reinterpret_cast<uintptr_t>(l) |
                         reinterpret_cast<uintptr_t>(inv)) & 15u) == 0;
  const int blocks = (batch + kLanesPerBlock - 1) / kLanesPerBlock;
  chol_diag_inv_kernel<<<blocks, 32 * kLanesPerBlock, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(l),
      static_cast<float*>(inv), batch, nb, nb == kNb && aligned);
  return cudaGetLastError();
}

}  // extern "C"
