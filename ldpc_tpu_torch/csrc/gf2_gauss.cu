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
// What the result is: the reduced row echelon form (RREF) of the lane's
// matrix for its column order, its rows in the order of their pivot
// columns, then zero rows. The RREF of a matrix is unique, so any choice of
// pivot row among the rows not yet used gives the same bits, and the rows
// need not move while the elimination runs: this kernel takes the highest
// unused row with a 1 as the pivot, never swaps, and writes each pivot row
// to its place (its pivot's rank) at the end.
//
// What bounds it: not bytes (the (m, n) bytes are read and written once) but
// the chain of up to n dependent column steps per lane, each of which must
// see the column as every earlier step left it. The design takes every
// block barrier and every replay of a step off that chain, so what is left
// is the instructions of one step in one warp, issued one after another.
//
// Design: one thread per column, its bits in registers, and no block
// barrier between column steps. A lane is ceil(n / 32) warps (288 threads on
// optimalH, 160 x 280; 640 on H02, 520 x 640); thread j holds column j as W
// 32-bit words of row bits (W = ceil(m / 32), rounded up to a multiple of 4
// above 8, a template parameter, so that the register array is indexed by
// constants only; a word picked by a row index goes through a tree of W - 1
// selects; the words above m stay zero). Thread j loads its column with
// one byte load per row (a warp reads 32 neighbouring bytes of a row). Warp
// q owns columns 32q .. 32q + 31 and works in two parts:
//   1. Consume: it applies every pivot of the columns before its own, in
//      column order, as they are published: an acquire read of a shared
//      counter of published columns, then for each column its pivot
//      row (-1: none) and, for a pivot, `elim` (the pivot column without the
//      pivot row's bit); when a thread's own column has the pivot row's
//      bit, it XORs elim in: the reference's "XOR the pivot row into every
//      other row with a 1 in column c", read column by column.
//   2. Produce: then it runs its own columns one by one. The owner of column
//      c (lane c % 32, its column up to date) takes the highest row with a 1
//      that is no pivot row yet (the pivot rows so far, a mask P kept in
//      shared memory and in every lane's registers), writes the pivot row,
//      elim, P with the pivot added and the pivot row's output row (the
//      rank), and publishes the column with a release store of the counter;
//      after a __syncwarp every lane of the warp reads the pivot row, elim
//      and P back at once and applies the pivot as in part 1.
// A column j < c is already reduced (its bit at any row that can still
// become a pivot is 0), so a warp is done with the elimination after its
// own columns. No thread writes another's column. The lane stops when its
// rank reaches m. The chain of the lane is one column step after another in
// the producing warp; the later warps follow a few columns behind. One
// barrier after the last step makes every output row known; then thread j
// writes each pivot row's bit of its column to that row's output row and
// zeros to the rows from the rank on. The TPU kernel computed XOR in float32
// as a + b - 2ab on a transposed f32 copy in VMEM; here it is a bitwise XOR
// of 32 rows at once.
//
// A block is one lane (two or three lanes per block ran slower: a second
// lane on an SM only adds to the issue load of each step). The host
// computes the plan (`gauss_plan` in ldpc_tpu_torch/ops/gauss_kernel.py:
// threads per lane, W, shared bytes); `ldpc_gf2_gauss` recomputes it and
// refuses a launch whose plan differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 768;       // W <= 24 words of row bits per column
constexpr int kDefaultSmem = 48 * 1024;  // above it, a block opts in

// threads per block at W words: a thread holds its column, P and a step's
// elim (3 W registers) and temporaries: 64 registers at 1024 threads take
// W <= 12, 80 at 768 W <= 16, 96 at 640 W <= 24
__host__ __device__ constexpr int max_threads(int w) {
  return w <= 12 ? 1024 : w <= 16 ? 768 : 640;
}

// W words padded to whole uint4s in shared memory
__host__ __device__ constexpr int stride(int w) { return (w + 3) / 4 * 4; }

// 32-bit words of shared memory per lane: the count of published columns
// and the rank (and two words of padding), P, each column's pivot row, each
// row's output row (m padded to a multiple of 4) and each pivot's elim (by
// rank). Every part starts on a 16-byte boundary.
__host__ __device__ constexpr int lane_words(int w, int m, int threads) {
  return 4 + stride(w) + threads + (m + 3) / 4 * 4 + m * stride(w);
}

// Shared-memory stores and loads that order the accesses around them for
// the threads of the block (release and acquire at block scope).
__device__ __forceinline__ void store_release(int* p, int v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

// x[k] for a word index k < W: a tree of W - 1 selects on k's bits, so the
// array stays in registers (k is the same in every thread of the warp).
template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&x)[W], int k) {
  uint32_t v[W];
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = x[i];
#pragma unroll
  for (int step = 1; step < W; step *= 2) {
#pragma unroll
    for (int i = 0; i + step < W; i += 2 * step)
      v[i] = (k & step) ? v[i + step] : v[i];
  }
  return v[0];
}

// The bit of row r of a column.
template <int W>
__device__ __forceinline__ uint32_t bit_at(const uint32_t (&x)[W], int r) {
  return (word_at(x, r >> 5) >> (r & 31)) & 1u;
}

// W words from 16-byte aligned shared memory, and back (padded with 0).
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* s,
                                           uint32_t (&v)[W]) {
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
#pragma unroll
  for (int q = 0; q < stride(W) / 4; ++q) {
    const uint4 u = s4[q];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < W) v[4 * q + i] = w[i];
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* s,
                                            const uint32_t (&v)[W]) {
  uint4* s4 = reinterpret_cast<uint4*>(s);
#pragma unroll
  for (int q = 0; q < stride(W) / 4; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 4 * q + i < W ? v[4 * q + i] : 0u;
    s4[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One pivot applied to a column x: when x has the pivot row's bit, XOR in
// elim (the pivot column without that bit, in shared memory).
template <int W>
__device__ __forceinline__ void xor_if_set(uint32_t (&x)[W], int piv,
                                           const uint32_t* elim) {
  uint32_t e[W];
  load_words(elim, e);
  const uint32_t take = 0u - bit_at(x, piv);
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] ^= e[k] & take;
}

template <int W>
__global__ void __launch_bounds__(max_threads(W))
    gf2_gauss_kernel(const uint8_t* __restrict__ h,
                     const uint8_t* __restrict__ active,
                     uint8_t* __restrict__ out, int m, int n) {
  extern __shared__ uint4 smem[];
  const int j = threadIdx.x, threads_per_lane = blockDim.x;
  const size_t b = blockIdx.x;
  const size_t mn = static_cast<size_t>(m) * n;
  const uint8_t* src = h + b * mn;
  uint8_t* dst = out + b * mn;
  if (active[b] == 0) {
    if (mn % 16 == 0 &&
        ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
         & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (size_t e = j; e < mn / 16; e += threads_per_lane) d4[e] = s4[e];
    } else {
      for (size_t e = j; e < mn; e += threads_per_lane) dst[e] = src[e];
    }
    return;
  }

  uint32_t x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint32_t word = 0;
    if (j < n) {
      const int rows = min(32, m - 32 * k);
#pragma unroll 8
      for (int i = 0; i < rows; ++i)
        word |= static_cast<uint32_t>(
                    src[static_cast<size_t>(32 * k + i) * n + j] & 1u) << i;
    }
    x[k] = word;
  }

  // the lane's shared memory (lane_words)
  constexpr int kStride = stride(W);
  int* lane_mem = reinterpret_cast<int*>(smem);
  int* published = lane_mem;      // columns published so far
  int* rank_total = lane_mem + 1;  // the rank after them
  uint32_t* pivots = reinterpret_cast<uint32_t*>(lane_mem + 4);  // P
  int* piv_at = lane_mem + 4 + kStride;    // each column's pivot row
  int* out_row = piv_at + threads_per_lane;  // each row's output row
  uint32_t* elims = reinterpret_cast<uint32_t*>(out_row + (m + 3) / 4 * 4);
  for (int r = j; r < m; r += threads_per_lane) out_row[r] = -1;
  if (j < kStride) pivots[j] = 0u;
  if (j == 0) *published = *rank_total = 0;
  __syncthreads();

  const int t = j & 31, first = j - t;  // this warp's first column
  int rank = 0;
  for (int c = 0; c < first && rank < m;) {
    const int upto = min(load_acquire(published), first);
    for (; c < upto && rank < m; ++c) {
      const int piv = piv_at[c];
      if (piv >= 0) xor_if_set(x, piv, elims + rank++ * kStride);
    }
  }
  const int cols = min(32, n - first);
  uint32_t p[W];  // P as the owner of the next column needs it
  load_words(pivots, p);
  for (int tt = 0; tt < cols && rank < m; ++tt) {
    if (t == tt) {
      uint32_t nonzero = 0;
#pragma unroll
      for (int k = 0; k < W; ++k)
        nonzero |= ((x[k] & ~p[k]) != 0u ? 1u : 0u) << k;
      int piv = -1;
      if (nonzero != 0u) {
        const int kw = 31 - __clz(nonzero);
        const uint32_t xw = word_at(x, kw), pword = word_at(p, kw);
        piv = 32 * kw + 31 - __clz(xw & ~pword);
        uint32_t* elim = elims + rank * kStride;
        store_words(elim, x);
        elim[kw] = xw & ~(1u << (piv & 31));
        pivots[kw] = pword | 1u << (piv & 31);
        out_row[piv] = rank;
        *rank_total = rank + 1;
      }
      piv_at[j] = piv;
      store_release(published, j + 1);
    }
    __syncwarp();
    // every lane reads the step back, whether or not it had a pivot, so
    // that the three reads overlap
    const int piv = piv_at[first + tt];
    uint32_t e[W];
    load_words(elims + rank * kStride, e);
    load_words(pivots, p);
    const uint32_t take = piv >= 0 ? 0u - bit_at(x, piv) : 0u;
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] ^= e[k] & take;
    rank += piv >= 0 ? 1 : 0;
  }
  __syncthreads();
  rank = *rank_total;

  if (j < n) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int rows = min(32, m - 32 * k);
#pragma unroll 8
      for (int i = 0; i < rows; ++i) {
        const int o = out_row[32 * k + i];
        if (o >= 0)
          dst[static_cast<size_t>(o) * n + j] =
              static_cast<uint8_t>((x[k] >> i) & 1u);
      }
    }
    for (int o = rank; o < m; ++o) dst[static_cast<size_t>(o) * n + j] = 0;
  }
}

struct Plan {
  int threads_per_lane, words, smem_bytes;
};

// The launch layout of an (m, n) lane; false when no layout takes it.
bool plan_for(int m, int n, Plan* p) {
  if (m < 1 || n < 1 || m > kMaxRows) return false;
  p->threads_per_lane = (n + 31) / 32 * 32;
  const int need = (m + 31) / 32;
  p->words = need <= 8 ? need : (need + 3) / 4 * 4;
  const int limit = max_threads(p->words);
  if (p->threads_per_lane > limit) return false;
  p->smem_bytes = lane_words(p->words, m, p->threads_per_lane) *
                 static_cast<int>(sizeof(uint32_t));
  return true;
}

template <int W>
cudaError_t launch(const Plan& p, const uint8_t* h, const uint8_t* active,
                   uint8_t* out, int batch, int m, int n,
                   cudaStream_t stream) {
  if (p.smem_bytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_gauss_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem_bytes);
    if (e != cudaSuccess) return e;
  }
  gf2_gauss_kernel<W><<<batch, p.threads_per_lane,
                        static_cast<size_t>(p.smem_bytes), stream>>>(
      h, active, out, m, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the elimination of `batch` lanes' (m, n) uint8 matrices on
// `stream`; `active` is (batch,) bytes. threads_per_lane, words and
// smem_bytes are the caller's plan; a plan other than this source's (or a
// shape no plan takes) returns cudaErrorInvalidValue and launches nothing.
// Otherwise returns the cudaError_t of the launch (0 on success). Does not
// synchronise.
int ldpc_gf2_gauss(const void* h, const void* active, void* out, int batch,
                   int m, int n, int threads_per_lane, int words,
                   int smem_bytes, void* stream) {
  Plan p;
  if (!plan_for(m, n, &p) || p.threads_per_lane != threads_per_lane ||
      p.words != words || p.smem_bytes != smem_bytes)
    return cudaErrorInvalidValue;
  if (batch <= 0) return cudaSuccess;
  const auto* hp = static_cast<const uint8_t*>(h);
  const auto* ap = static_cast<const uint8_t*>(active);
  auto* op = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (p.words) {
    case 1: return launch<1>(p, hp, ap, op, batch, m, n, s);
    case 2: return launch<2>(p, hp, ap, op, batch, m, n, s);
    case 3: return launch<3>(p, hp, ap, op, batch, m, n, s);
    case 4: return launch<4>(p, hp, ap, op, batch, m, n, s);
    case 5: return launch<5>(p, hp, ap, op, batch, m, n, s);
    case 6: return launch<6>(p, hp, ap, op, batch, m, n, s);
    case 7: return launch<7>(p, hp, ap, op, batch, m, n, s);
    case 8: return launch<8>(p, hp, ap, op, batch, m, n, s);
    case 12: return launch<12>(p, hp, ap, op, batch, m, n, s);
    case 16: return launch<16>(p, hp, ap, op, batch, m, n, s);
    case 20: return launch<20>(p, hp, ap, op, batch, m, n, s);
    default: return launch<24>(p, hp, ap, op, batch, m, n, s);
  }
}

}  // extern "C"
