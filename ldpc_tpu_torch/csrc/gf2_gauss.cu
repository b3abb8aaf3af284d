// GF(2) row reduction of each lane's parity-check matrix in a given column
// order, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ldpc_tpu/ops/pallas/gauss_kernel.py
// (called by `gf2_eliminate_pallas`), the elimination step of AGC-ALP's
// CalculateGauss (algo/agc_alp.h:44-72): for each column in order, the first
// row at or below the lane's rank with a 1 is the pivot; it is swapped up to
// row `rank` and XORed into every other row with a 1 in that column, and the
// rank grows by one. A lane whose rank reaches m stops: no later column can
// give a pivot, which is what the TPU kernel's group-level early exit relied
// on. An inactive lane copies its input through (the TPU skipped inactive
// lane groups; callers mask those lanes). The plain PyTorch twin is
// `gf2_eliminate_ref` in ldpc_tpu_torch/ops/gauss_ref.py; the result is
// bit-identical to it on active lanes.
//
// Design: one block per lane, one thread per row (m rounded up to a warp).
// The lane's matrix is kept bit-packed in shared memory, m rows of
// ceil(n/32) 32-bit words (5.8 KB for optimalH, 160 x 280; 41.6 KB for H02,
// 520 x 640): the whole elimination touches device memory only to load the
// (m, n) bytes once (a warp ballot packs 32 columns into a word) and to
// store them once. Per column: the pivot search (each thread tests its row,
// atomicMin on a shared index; three index slots in rotation, so that a
// slot is reset two barriers before its next search), a barrier, the row
// swap, a barrier, and the elimination, where each thread XORs the pivot
// row into its own row word by word, so no two threads write one word. The
// TPU kernel computed XOR in float32 as a + b - 2ab on a transposed f32
// copy in VMEM; here it is a bitwise XOR of 32 columns at once.
//
// What bounds it: barrier latency, three per column and up to n columns per
// lane, a few microseconds of arithmetic in all; the lanes run in parallel
// blocks, one per SM or more. The wrapper checks the shared memory a lane
// needs against the card's opt-in limit and raises when it does not fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 64;
constexpr int kDefaultSmemLimit = 48 * 1024;

__global__ void gf2_gauss_kernel(const uint8_t* __restrict__ h,
                                 const uint8_t* __restrict__ active,
                                 uint8_t* __restrict__ out, int m, int n) {
  const size_t off = static_cast<size_t>(blockIdx.x) * m * n;
  const uint8_t* src = h + off;
  uint8_t* dst = out + off;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (active[blockIdx.x] == 0) {
    for (int e = tid; e < m * n; e += nt) dst[e] = src[e];
    return;
  }
  extern __shared__ uint32_t mat[];  // [m][words]
  __shared__ int piv_slot[3];
  const int words = (n + 31) / 32;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int p = warp; p < m * words; p += nwarps) {
    const int r = p / words, c = (p % words) * 32 + lane;
    const bool bit = c < n && (src[static_cast<size_t>(r) * n + c] & 1u);
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) mat[p] = word;
  }
  if (tid < 3) piv_slot[tid] = m;
  __syncthreads();

  int rank = 0;
  for (int c = 0; c < n && rank < m; ++c) {
    const int w = c >> 5, slot = c % 3;
    const uint32_t bit = 1u << (c & 31);
    for (int r = tid; r < m; r += nt)
      if (r >= rank && (mat[r * words + w] & bit))
        atomicMin(&piv_slot[slot], r);
    __syncthreads();
    const int piv = piv_slot[slot];
    // the slot of column c + 2: its last reader (column c - 1) is done
    if (tid == 0) piv_slot[(c + 2) % 3] = m;
    if (piv == m) continue;  // no pivot in this column (uniform)
    if (piv != rank) {
      for (int k = tid; k < words; k += nt) {
        const uint32_t tmp = mat[piv * words + k];
        mat[piv * words + k] = mat[rank * words + k];
        mat[rank * words + k] = tmp;
      }
      __syncthreads();
    }
    const uint32_t* prow = mat + rank * words;
    for (int r = tid; r < m; r += nt) {
      uint32_t* row = mat + r * words;
      if (r != rank && (row[w] & bit))
        for (int k = 0; k < words; ++k) row[k] ^= prow[k];
    }
    __syncthreads();
    ++rank;
  }

  for (int e = tid; e < m * n; e += nt) {
    const int r = e / n, c = e % n;
    const uint32_t word = mat[r * words + (c >> 5)];
    dst[e] = static_cast<uint8_t>((word >> (c & 31)) & 1u);
  }
}

int threads_for(int m) {
  int threads = (m + 31) / 32 * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return threads;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the bit-packed matrix).
long long ldpc_gf2_gauss_smem_bytes(int m, int n) {
  return static_cast<long long>(m) * ((n + 31) / 32) *
         static_cast<long long>(sizeof(uint32_t));
}

// Launch the elimination of `batch` lanes' (m, n) uint8 matrices on
// `stream`; `active` is (batch,) bytes. Returns the cudaError_t of the
// launch (0 on success). Does not synchronise.
int ldpc_gf2_gauss(const void* h, const void* active, void* out, int batch,
                   int m, int n, void* stream) {
  if (batch <= 0) return cudaSuccess;
  const long long smem = ldpc_gf2_gauss_smem_bytes(m, n);
  if (smem > kDefaultSmemLimit) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_gauss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  gf2_gauss_kernel<<<batch, threads_for(m), static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(h), static_cast<const uint8_t*>(active),
      static_cast<uint8_t*>(out), m, n);
  return cudaGetLastError();
}

}  // extern "C"
