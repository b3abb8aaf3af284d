// Fused early-exit sum-product BP decode for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ldpc_tpu/ops/pallas/bp_kernel.py
// (built by `make_bp_pallas_decoder`): the whole flooding-BP decode of a
// codeword runs inside one launch, with every message resident on chip.
//
// What bounds it. Per edge and iteration the decode evaluates phi twice, a
// logf and a tanhf each (1,800 phi per codeword-iteration on the 160 x 280
// optimalH code, ~55 instructions each); the rest is a few shared-memory
// accesses per edge. There is no matrix product and no device-memory
// traffic inside the loop: the SM's instruction issue, and how well phi's
// long dependent chains overlap, bound it. A codeword keeps a whole block:
// with one warp per codeword, a codeword that never converges runs its 100
// iterations 60 phi deep per thread and sets a high-SNR launch's time.
//
// Design: one block per codeword, block_threads(m) threads: one per check
// row, rounded up to a warp.
//   - the index tables (row_col, col_from_row) are staged once per block
//     into shared memory as 16-bit indices (5.3 KB for optimalH);
//   - shared memory holds the check-to-variable messages c2v in the padded
//     row layout, the posterior total and the channel LLRs (6 KB). The
//     variable-to-check message of an edge is not stored: the row phase
//     makes it as total - c2v, the plain version's float32 subtraction;
//   - per iteration, three phases and three block barriers: (1) rows, a
//     thread per row: v = total[col] - c2v for every slot, the sign
//     parity, phi(|v|) per slot, the row sum in slot order, then
//     c2v = sign * phi(sum - mag); (2) columns, the threads striding over
//     them: total = llr + the column's c2v in slot order; (3) the syndrome,
//     a thread per row, on the hard decisions total <= 0, reduced by the
//     barrier itself (__syncthreads_or);
//   - the row's slots are unrolled for the common row degrees (kDc = 4 ... 8,
//     any other dc takes a loop), so a thread's dc phi of each pass are
//     independent instruction streams that overlap, and pad slots take
//     the neutral LLR (phi 0) instead of a branch.
// Both sums run in slot order, one add at a time, the order of the plain
// PyTorch twin (ops/bp_ref.py).
//
// Early exit. A block returns the moment its codeword's syndrome is zero.
// This is finer than the TPU kernel's per-tile exit and gives the same
// outputs: after a lane's first success its bits, done flag and iteration
// count never change (the freeze in ldpc_tpu/decoders/bp.py `_run_loop` and
// bp_kernel.py `body`), so the iterations a tile would still run for its
// other lanes cannot alter this lane's result.
//
// phi is -logf(tanhf(0.5f * x)) on the clamped argument, as in ops/phi.py,
// and the file is compiled without --use_fast_math, so logf/tanhf are those
// of torch's own CUDA kernels and the decode equals bp_ref's bit for bit.
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
constexpr int kMaxDc = 32;            // the sign parity is a 32-bit mask
constexpr int kMaxIndex = 65535;      // 16-bit table entries
constexpr int kDefaultSmemLimit = 48 * 1024;

// Threads of a block: one per check row, rounded up to a warp. Variant
// builds with max(m, n) (one per row or column), 96 and 192 threads were
// slower on the -3 dB main path (PERF.md).
int block_threads(int m) {
  const int t = (m + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, kPhiArgMin), kPhiArgMax);
  return -logf(tanhf(0.5f * x));
}

// Bytes of the block's tables, row_col [m * dc] and col_from_row [n * dv]
// as 16-bit indices, rounded up to 16.
__host__ __device__ inline size_t table_bytes(int n, int m, int dc, int dv) {
  const size_t b = (static_cast<size_t>(m) * dc +
                    static_cast<size_t>(n) * dv) * sizeof(uint16_t);
  return (b + 15) / 16 * 16;
}

// Floats of the codeword's state: c2v [m * dc], total [n], llr [n].
__host__ __device__ inline size_t codeword_floats(int n, int m, int dc) {
  return static_cast<size_t>(m) * dc + 2 * static_cast<size_t>(n);
}

// Shared memory of one block, in bytes.
size_t smem_bytes(int n, int m, int dc, int dv) {
  return table_bytes(n, m, dc, dv) +
         codeword_floats(n, m, dc) * sizeof(float);
}

// The check update of row r: c2v <- sign * phi(sum - phi(|v|)) over its
// slots, v = total[col] - c2v. kDc > 0: exactly kDc slots, unrolled; 0: dc
// slots in a loop, phi(|v|) parked in c2v between the passes.
template <int kDc>
__device__ __forceinline__ void check_row(int r, int dc, int n,
                                          const uint16_t* rc, float* c2v,
                                          const float* total) {
  const int base = r * dc;
  float s = 0.f;
  unsigned neg = 0u;
  if (kDc > 0) {
    float mag[kDc > 0 ? kDc : 1];
#pragma unroll
    for (int k = 0; k < kDc; ++k) {
      const int j = rc[base + k];
      const float v = j < n ? total[j] - c2v[base + k] : kNeutralLlr;
      neg |= static_cast<unsigned>(v <= 0.f) << k;
      mag[k] = phi(fabsf(v));
    }
#pragma unroll
    for (int k = 0; k < kDc; ++k) s += mag[k];
    const unsigned odd = __popc(neg) & 1u;
#pragma unroll
    for (int k = 0; k < kDc; ++k) {
      const float out = phi(s - mag[k]);
      c2v[base + k] = ((neg >> k) & 1u) ^ odd ? -out : out;
    }
  } else {
    for (int k = 0; k < dc; ++k) {
      const int j = rc[base + k];
      const float v = j < n ? total[j] - c2v[base + k] : kNeutralLlr;
      neg |= static_cast<unsigned>(v <= 0.f) << k;
      const float mag = phi(fabsf(v));
      c2v[base + k] = mag;
      s += mag;
    }
    const unsigned odd = __popc(neg) & 1u;
    for (int k = 0; k < dc; ++k) {
      const float out = phi(s - c2v[base + k]);
      c2v[base + k] = ((neg >> k) & 1u) ^ odd ? -out : out;
    }
  }
}

// llr (B, n) f32; row_col (m, dc) i32, pad == n; col_from_row (n, dv) i32,
// pad == m*dc. Outputs: bits (B, n) u8, success (B,) u8, iterations (B,) i32.
template <int kDc>
__global__ void __launch_bounds__(kMaxThreads)
bp_decode_kernel(const float* __restrict__ llr,
                 const int* __restrict__ row_col,
                 const int* __restrict__ col_from_row,
                 uint8_t* __restrict__ bits_out,
                 uint8_t* __restrict__ success_out,
                 int* __restrict__ iters_out, int n, int m, int dc, int dv,
                 int max_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int md = m * dc;
  const int tid = threadIdx.x, nt = blockDim.x;
  uint16_t* rc = reinterpret_cast<uint16_t*>(smem);   // [md]
  uint16_t* cfr = rc + md;                            // [n * dv]
  float* c2v = reinterpret_cast<float*>(smem + table_bytes(n, m, dc, dv));
  float* total = c2v + md;                            // [n]
  float* lam = total + n;                             // [n]
  const size_t cw = blockIdx.x;

  for (int e = tid; e < md; e += nt) {
    rc[e] = row_col[e];
    c2v[e] = 0.f;  // with c2v = 0, total - c2v is the channel LLR
  }
  for (int e = tid; e < n * dv; e += nt) cfr[e] = col_from_row[e];
  for (int j = tid; j < n; j += nt) {
    const float x = llr[cw * n + j];
    lam[j] = x;
    total[j] = x;
  }
  __syncthreads();

  int it = 0;
  bool ok = false;
  while (it < max_iter) {
    // 1. check rows
    for (int r = tid; r < m; r += nt)
      check_row<kDc>(r, dc, n, rc, c2v, total);
    __syncthreads();
    // 2. variables: the posterior, whose sign is the hard decision
    for (int j = tid; j < n; j += nt) {
      float acc = 0.f;
      for (int t = 0; t < dv; ++t) {
        const int e = cfr[j * dv + t];
        if (e < md) acc += c2v[e];
      }
      total[j] = lam[j] + acc;
    }
    __syncthreads();
    ++it;
    // 3. syndrome: any row's parity odd -> go on
    int odd = 0;
    for (int r = tid; r < m; r += nt) {
      unsigned parity = 0u;
      for (int k = 0; k < dc; ++k) {
        const int j = rc[r * dc + k];
        if (j < n) parity ^= total[j] <= 0.f;
      }
      odd |= static_cast<int>(parity);
    }
    if (!__syncthreads_or(odd)) {
      ok = true;
      break;
    }
  }
  for (int j = tid; j < n; j += nt) bits_out[cw * n + j] = total[j] <= 0.f;
  if (tid == 0) {
    success_out[cw] = ok;
    iters_out[cw] = ok ? it : max_iter;
  }
}

using Kernel = void (*)(const float*, const int*, const int*, uint8_t*,
                        uint8_t*, int*, int, int, int, int, int);

Kernel pick(int dc) {
  switch (dc) {
    case 4: return bp_decode_kernel<4>;
    case 5: return bp_decode_kernel<5>;
    case 6: return bp_decode_kernel<6>;
    case 7: return bp_decode_kernel<7>;
    case 8: return bp_decode_kernel<8>;
    default: return bp_decode_kernel<0>;
  }
}

}  // namespace

extern "C" {

// Launches the decode of `batch` codewords, one block of block_threads(m)
// threads each, on `stream`. Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for a shape the kernel does not take). Does
// not synchronise.
int ldpc_bp_decode(const void* llr, const void* row_col,
                   const void* col_from_row, void* bits, void* success,
                   void* iterations, int batch, int n, int m, int dc, int dv,
                   int max_iter, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (dc < 1 || dc > kMaxDc || n > kMaxIndex || m * dc > kMaxIndex)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, m, dc, dv);
  const Kernel kernel = pick(dc);
  if (smem > kDefaultSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, block_threads(m), static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<const int*>(row_col),
      static_cast<const int*>(col_from_row), static_cast<uint8_t*>(bits),
      static_cast<uint8_t*>(success), static_cast<int*>(iterations), n, m,
      dc, dv, max_iter);
  return cudaGetLastError();
}

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
