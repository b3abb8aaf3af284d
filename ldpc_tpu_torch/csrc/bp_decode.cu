// Fused early-exit sum-product BP decode for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ldpc_tpu/ops/pallas/bp_kernel.py
// (built by `make_bp_pallas_decoder`): the whole flooding-BP decode of a
// codeword runs inside one launch, with every message resident on chip.
//
// Design. One thread block decodes one codeword; the grid is the batch, so a
// batch of 8192 gives 8192 blocks for the card's 132 SMs. Shared memory holds
// the codeword's state: llr[n] and the edge messages v2c[m*dc] and c2v[m*dc]
// as float32 in the padded row layout, and bits[n] as bytes (9,080 bytes per
// codeword for the 160x280 optimalH code, dc = 6). The index tables (row_col,
// col_from_row) are read-only and shared by all blocks, so they are read
// through the read-only data cache. Device memory is touched once to read
// the LLRs and once to write the outputs.
//
// The TPU kernel expresses the row reduction and the edge re-broadcast as
// one-hot matmuls (R/R^T, S/S^T) only because Mosaic cannot reshape
// (Bt, m*dc) -> (Bt, m, dc). Here they are gathers in shared memory:
//   1. row phase, one thread per check row: phi-sum and negative count over
//      the row's slots, then c2v = sign * phi(sum - phi(|v2c|)) per slot;
//   2. column phase, one thread per variable: total = llr + sum of the
//      column's c2v (over col_from_row), the hard decision total <= 0, and
//      v2c = total - c2v written back to the column's edges;
//   3. syndrome, one thread per row: the parity of the row's bits, and a
//      block-wide "all rows even" test (__syncthreads_and).
// Both sums run in slot order, one add at a time, which is the order the
// plain PyTorch twin (ops/bp_ref.py) uses.
//
// Early exit. A block returns the moment its codeword's syndrome is zero.
// This is finer than the TPU kernel's per-tile exit and gives the same
// outputs: after a lane's first success its bits, done flag and iteration
// count never change (the freeze in ldpc_tpu/decoders/bp.py `_run_loop` and
// bp_kernel.py `body`), so the iterations a tile would still run for its
// other lanes cannot alter this lane's result.
//
// What bounds it. Per edge per iteration the kernel evaluates phi twice
// (a logf and a tanhf each, 1,800 phi per codeword-iteration on optimalH)
// and makes about nine shared-memory accesses. There are no matmuls and no
// device-memory traffic inside the loop, so the transcendentals and the
// shared-memory gathers are the cost; the design keeps them on chip, spends
// no work on pad slots, and stops each codeword at its own first success.
// The math is float32 throughout and the file is compiled without
// --use_fast_math, so logf/tanhf stay within a few ulp of torch's.
//
// No wgmma or TMA: the decode is a loop with a data-dependent exit over
// gathers, not a matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPhiArgMin = 1e-9f;   // ops/phi.py PHI_ARG_MIN
constexpr float kPhiArgMax = 31.0f;   // ops/phi.py PHI_ARG_MAX
constexpr float kNeutralLlr = 64.0f;  // ops/bp_ref.py NEUTRAL_LLR
constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmemLimit = 48 * 1024;

__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, kPhiArgMin), kPhiArgMax);
  return -logf(tanhf(0.5f * x));
}

// llr (B, n) f32; row_col (m, dc) i32, pad == n; col_from_row (n, dv) i32,
// pad == m*dc. Outputs: bits (B, n) u8, success (B,) u8, iterations (B,) i32.
__global__ void bp_decode_kernel(const float* __restrict__ llr,
                                 const int* __restrict__ row_col,
                                 const int* __restrict__ col_from_row,
                                 uint8_t* __restrict__ bits_out,
                                 uint8_t* __restrict__ success_out,
                                 int* __restrict__ iters_out,
                                 int n, int m, int dc, int dv, int max_iter) {
  extern __shared__ float smem[];
  const int md = m * dc;
  float* v2c = smem;                                       // [md]
  float* c2v = smem + md;                                  // [md]
  float* lam = smem + 2 * md;                              // [n]
  uint8_t* bits = reinterpret_cast<uint8_t*>(smem + 2 * md + n);  // [n]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t cw = blockIdx.x;
  const float* llr_cw = llr + cw * n;

  for (int j = tid; j < n; j += nt) {
    const float x = llr_cw[j];
    lam[j] = x;
    bits[j] = x <= 0.f;
  }
  __syncthreads();
  // the first v->c message is the channel LLR of the edge's column
  for (int e = tid; e < md; e += nt) {
    const int j = __ldg(row_col + e);
    v2c[e] = j < n ? lam[j] : kNeutralLlr;
  }
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    // 1. check rows: c2v[e] holds phi(|v2c|) until the second pass
    for (int r = tid; r < m; r += nt) {
      const int base = r * dc;
      float s = 0.f;
      int nneg = 0;
      for (int k = 0; k < dc; ++k) {
        if (__ldg(row_col + base + k) >= n) continue;
        const float x = v2c[base + k];
        nneg += x <= 0.f;
        const float mag = phi(fabsf(x));
        c2v[base + k] = mag;
        s += mag;
      }
      const float sign_tot = (nneg & 1) ? -1.f : 1.f;
      for (int k = 0; k < dc; ++k) {
        if (__ldg(row_col + base + k) >= n) continue;
        const float sgn = v2c[base + k] <= 0.f ? -sign_tot : sign_tot;
        c2v[base + k] = sgn * phi(s - c2v[base + k]);
      }
    }
    __syncthreads();

    // 2. variables: posterior, hard decision, and the next v->c messages
    for (int j = tid; j < n; j += nt) {
      const int* edges = col_from_row + j * dv;
      float acc = 0.f;
      for (int t = 0; t < dv; ++t) {
        const int e = __ldg(edges + t);
        if (e < md) acc += c2v[e];
      }
      const float total = lam[j] + acc;
      bits[j] = total <= 0.f;
      for (int t = 0; t < dv; ++t) {
        const int e = __ldg(edges + t);
        if (e < md) v2c[e] = total - c2v[e];
      }
    }
    __syncthreads();

    // 3. syndrome: every row's parity even -> this codeword is done
    int even = 1;
    for (int r = tid; r < m; r += nt) {
      int parity = 0;
      for (int k = 0; k < dc; ++k) {
        const int j = __ldg(row_col + r * dc + k);
        if (j < n) parity ^= bits[j];
      }
      even &= parity == 0;
    }
    if (__syncthreads_and(even)) {
      for (int j = tid; j < n; j += nt) bits_out[cw * n + j] = bits[j];
      if (tid == 0) {
        success_out[cw] = 1;
        iters_out[cw] = it + 1;
      }
      return;
    }
  }

  for (int j = tid; j < n; j += nt) bits_out[cw * n + j] = bits[j];
  if (tid == 0) {
    success_out[cw] = 0;
    iters_out[cw] = max_iter;
  }
}

}  // namespace

extern "C" {

// Launches the decode of `batch` codewords on `stream`; returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
int ldpc_bp_decode(const void* llr, const void* row_col,
                   const void* col_from_row, void* bits, void* success,
                   void* iterations, int batch, int n, int m, int dc, int dv,
                   int max_iter, void* stream) {
  if (batch <= 0) return cudaSuccess;
  int threads = (m > n ? m : n);
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (2 * static_cast<size_t>(m) * dc + n) * sizeof(float) +
                      static_cast<size_t>(n);
  if (smem > kDefaultSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bp_decode_kernel<<<batch, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<const int*>(row_col),
      static_cast<const int*>(col_from_row), static_cast<uint8_t*>(bits),
      static_cast<uint8_t*>(success), static_cast<int*>(iterations), n, m, dc,
      dv, max_iter);
  return cudaGetLastError();
}

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
