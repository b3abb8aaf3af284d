// The IPM's Newton-system Cholesky, one thread block per lane: the whole
// factor in one launch (chol_factor_kernel) and each solve in one launch
// (chol_solve_kernel), for NVIDIA Hopper (sm_90a).
//
// Replaces the blocked chain of ldpc_tpu_torch/ops/chol.py for n <= kMaxN
// (320): per Newton step two zero fills of a (B, n_pad, n_pad) tensor, the
// pad copy, five panel products (cuBLAS), five launches of
// chol_diag_inv.cu, their slice copies, and per solve a zero fill and 18
// block matvecs with their subtractions (~70 device operations, the
// graphs' largest share of AGC-ALP's device time). The JAX package runs the same factor as
// `blocked_cholesky` of ldpc_tpu/ops/pallas/chol_kernel.py (XLA panels around
// the Pallas `_diag_inv_kernel`). The plain PyTorch twins are
// `chol_factor_ref` and `chol_solve_ref` in ldpc_tpu_torch/ops/chol_ref.py.
//
// The results keep the blocked factor's contract (ops/chol.py CholFactors):
// L as (B, n_pad, n_pad), n_pad = n rounded up to 64, lower triangular with
// zeros above the diagonal and an identity tail, and the inverted diagonal
// blocks V_q = L_qq^{-1} as (P, B, 64, 64), zero above the diagonal.
//
// What bounds it. A lane's factor is n^3 / 6 multiply-adds (7.3 M at
// n = 280) and a chain of n dependent pivots (a square root and a division
// each); M is read once and L written once. With 128 lanes the card has one
// block per SM, so the time is the pivot chain's latency (~340 cycles a
// column alone on the H100, ~100 of them the IEEE square root and
// division) and the panel updates, which read B^T's 64 columns from shared
// memory for every k (its bandwidth binds them); the bytes bound is ~12x
// below the measured time (PERF.md).
//
// Factor design: left-looking by block column of 64, one block of kThreads
// threads per lane; L goes to its output as it is made and the later
// panels read it back (through L2: a lane's L is 400 KB, 128 lanes' 52 MB).
//   0. The zeros of L that no block step writes (above the diagonal blocks,
//      and the padding rows left of the last block column) are stored
//      first.
//   1. Block column q: a thread per panel row (rows qs..n), the row in
//      registers: M's row (zero past n's columns) minus the sum over k < qs
//      of L[row, k] B^T[k, :], where B^T = L[qs:qs+64, :qs] transposed is
//      staged in shared memory (four loads in flight a thread) and read as
//      broadcasts, and the thread's own row of L streams from L2 two float4
//      ahead; k in order, float32 FMAs. Where the panel has few rows, up to
//      kMaxGroups threads share a row, split by k; the row's thread adds
//      their partial sums in group order.
//   2. One right-looking sweep over the block's 64 columns factors the
//      diagonal block, solves the rows below it against it (L_iq = P_iq
//      L_qq^{-T}) and inverts it: the diagonal block's rows (threads 0..63,
//      the identity past n) lead, the rows below and 64 identity rows e_c
//      (whose results are V's columns) follow, one or two a thread. At
//      column k the leaders meet at a barrier of their 64 threads, take the
//      pivot, s = sqrtf(pivot) and r = 1 / s, scale their entry k (the
//      diagonal's own row takes s), post entry k + 1 as soon as it is final
//      (the next pivot waits for it), publish column k of L and r (a
//      release store the followers acquire), and update their entries
//      j > k + 1 by (x_k r) D_jk. The followers take each published column
//      when it is out, x_k *= r and x_j -= x_k L_jk with L_jk = D_jk r as
//      row j made it: chol_diag_inv.cu's recurrence, and on the identity
//      rows its inverse, term for term. The leaders never wait for them.
//   3. Each thread stores its rows: L's block column (zero above the
//      diagonal) and V's columns.
// Every panel row past the first block column needs a thread of its own
// (n - 64 <= kThreads) and the sweep's rows fit the threads (n + 64 <=
// 64 + 2 (kThreads - 64)): n <= 320 (kMaxN). Shared memory: B^T and the
// partial sums, kThreads x 64 floats (64 KB, opt-in above 48 KB), and the
// sweep's columns (17 KB). Other layouts measured as
// variant builds (a 4 x 4 tile update through shared-memory chunks, a
// block barrier a column, panel rows of two or four a thread, the next
// B^T filled during the sweep) were slower or no faster (PERF.md).
//
// Solve design: one block per lane, z in shared memory; forward, for each
// block row q, z_q = V_q (z_q - L[q rows, :qs] z[:qs]) (a warp per row of
// the block, lanes along k, eight rows' loads in flight, a butterfly sum),
// then backward x_q = V_q^T (z_q - L[qe:, q cols]^T x[qe:]) (lanes along the
// block's columns, warps along the rows, the warps' partial sums added in
// warp order): blocked_cho_solve's block substitution in one launch.
//
// A pivot that is not positive gives NaN (sqrtf of a negative number, or
// 0 * inf) that spreads through the rest of that lane's factor, inverse and
// solves and no further; there is no clamp. The IPM freezes such a lane.
// sqrtf and an IEEE 1 / s, both correctly rounded (no fast math). Every sum
// has a fixed order, so repeat calls, graph replays and the eager loop give
// the same bits. Full float32 throughout: no tensor cores (the solver
// refuses TF32, ops/lp_solver.py require_full_f32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNb = 64;                 // block column width (CholFactors.nb)
constexpr int kThreads = 256;           // a lane's block, both kernels
constexpr int kWarps = kThreads / 32;
// sweep rows: the diagonal block's 64 on threads 0..63, the others at most
// two a thread; every panel row past the first block column on a thread of
// its own
constexpr int kMaxN = kThreads + kNb;   // 320
constexpr int kMaxGroups = 8;           // threads sharing a panel row's sum

// B^T, L[qs:qs+64, :qs] transposed (qs <= kThreads), then the groups'
// partial sums (at most kThreads rows)
constexpr size_t kFactorSmem = kThreads * kNb * sizeof(float);

size_t solve_smem(int n_pad) {
  return static_cast<size_t>(n_pad + kWarps * kNb + kNb) * sizeof(float);
}

// One row of the sweep in registers: its 64 entries and, for a row of the
// diagonal block, its index there (-1 for the rows below it and the
// identity rows, whose every entry lies below the diagonal).
struct Row {
  float x[kNb];
  int diag;
};

// Panel row g of block column q, M[qs + g, qs:qs+64], zero past n's
// columns. vec: n % 4 == 0 and M 16-byte aligned (w is then a multiple
// of 4).
__device__ __forceinline__ void load_panel(Row& row, const float* mrow,
                                           int w, bool vec) {
  if (vec) {
#pragma unroll
    for (int c4 = 0; c4 < kNb / 4; ++c4) {
      const float4 v = 4 * c4 < w ? __ldg(reinterpret_cast<const float4*>(
                                        mrow) + c4)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      row.x[4 * c4] = v.x;
      row.x[4 * c4 + 1] = v.y;
      row.x[4 * c4 + 2] = v.z;
      row.x[4 * c4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNb; ++j) row.x[j] = j < w ? __ldg(mrow + j) : 0.f;
  }
}

__device__ __forceinline__ void load_identity(Row& row, int c) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) row.x[j] = j == c ? 1.f : 0.f;
}

// x_j -= sum over k in [k0, k1) of L[row, k] B^T[k, j], k in order (k1 - k0
// a multiple of 4): the thread's own row of L streamed from L2, B^T's rows
// read as broadcasts.
__device__ __forceinline__ void panel_sum(float (&x)[kNb], const float* lrow,
                                          const float* bt, int k0, int k1) {
  const float4* src = reinterpret_cast<const float4*>(lrow);
  const int e4 = k1 / 4;
  float4 next = k0 / 4 < e4 ? __ldcg(src + k0 / 4) : make_float4(0, 0, 0, 0);
  float4 after = k0 / 4 + 1 < e4 ? __ldcg(src + k0 / 4 + 1) : next;
  for (int k4 = k0 / 4; k4 < e4; ++k4) {
    const float4 cur = next;
    next = after;
    if (k4 + 2 < e4) after = __ldcg(src + k4 + 2);
    const float a[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4* b = reinterpret_cast<const float4*>(bt + (4 * k4 + e) *
                                                        kNb);
#pragma unroll
      for (int c4 = 0; c4 < kNb / 4; ++c4) {
        const float4 v = b[c4];
        x[4 * c4] = fmaf(-a[e], v.x, x[4 * c4]);
        x[4 * c4 + 1] = fmaf(-a[e], v.y, x[4 * c4 + 1]);
        x[4 * c4 + 2] = fmaf(-a[e], v.z, x[4 * c4 + 2]);
        x[4 * c4 + 3] = fmaf(-a[e], v.w, x[4 * c4 + 3]);
      }
    }
  }
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

// The columns the sweep shares: the diagonal block's rows post column k
// unscaled (`next`, two buffers), then column k of L and 1 / L_kk (`cols`,
// `recip`, kept for the whole sweep), published by `posted` (columns
// 0 .. posted - 1 are final).
struct Ring {
  float next[2 * kNb];
  float cols[kNb * kNb];
  float recip[kNb];
  int posted;
};

// The right-looking sweep over the block's 64 columns. The diagonal
// block's rows (threads 0..63, one row each) lead: at column k they meet at
// a barrier of their 64 threads (column k is posted), take the pivot,
// s = sqrtf(pivot) and r = 1 / s, scale their entry k by r (the diagonal's
// own row takes s), post entry k + 1 as soon as it is final (the next
// pivot waits for it), publish column k of L and r, and update their
// entries j > k + 1 with (x_k r) D_jk. Every other thread follows the
// published columns (one or two rows each: x_k *= r, x_j -= x_k L_jk with
// L_jk = D_jk * r as its row made it) and waits only where it has caught
// up; the leaders never wait for it.
__device__ __forceinline__ void sweep_diag(Row& row, Ring& ring) {
  const int d = row.diag;
  ring.next[d] = row.x[0];
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const float* cb = ring.next + (k & 1) * kNb;
    asm volatile("bar.sync 1, 64;\n" ::: "memory");  // column k is posted
    if (d == 0) store_release(&ring.posted, k);  // L's columns < k
    const float s = sqrtf(cb[k]);
    const float r = 1.f / s;
    const float xk = row.x[k];
    row.x[k] = d > k ? xk * r : (d == k ? s : xk);
    ring.cols[k * kNb + d] = row.x[k];
    if (d == 0) ring.recip[k] = r;
    if (k + 1 < kNb) {   // column k + 1 first: the next pivot waits for it
      row.x[k + 1] = fmaf(-row.x[k], cb[k + 1] * r, row.x[k + 1]);
      ring.next[((k + 1) & 1) * kNb + d] = row.x[k + 1];
    }
    // one FMA an entry; the rows 0..31 stop at column 31, their diagonal
    const float t = row.x[k] * r;
#pragma unroll
    for (int m4 = 0; m4 < kNb / 4; ++m4) {
      if (4 * m4 + 3 <= k + 1) continue;
      if (m4 >= 8 && d < 32) break;
      const float4 v = reinterpret_cast<const float4*>(cb)[m4];
      const float d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * m4 + e;
        if (j <= k + 1) continue;
        row.x[j] = fmaf(-t, d[e], row.x[j]);
      }
    }
  }
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
  if (d == 0) store_release(&ring.posted, kNb);
}

template <int kSlots>
__device__ __forceinline__ void sweep_rows(Row (&rows)[2], const Ring& ring) {
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    while (load_acquire(&ring.posted) <= k) {
    }
    const float r = ring.recip[k];
    const float* cb = ring.cols + k * kNb;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) rows[u].x[k] *= r;
#pragma unroll
    for (int m4 = 0; m4 < kNb / 4; ++m4) {
      if (4 * m4 + 3 <= k) continue;
      const float4 v = reinterpret_cast<const float4*>(cb)[m4];
      const float d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * m4 + e;
        if (j <= k) continue;
#pragma unroll
        for (int u = 0; u < kSlots; ++u)
          rows[u].x[j] = fmaf(-rows[u].x[k], d[e], rows[u].x[j]);
      }
    }
  }
}

// Stores a finished sweep row: a row of L's block column (zero above the
// diagonal) or, for identity row c, column c of V (zero above the
// diagonal).
__device__ __forceinline__ void store_row(const Row& row, int g, int below,
                                          float* lcol, int n_pad,
                                          float* vg) {
  if (g < kNb + below) {
    float* dst = lcol + static_cast<size_t>(g) * n_pad;
#pragma unroll
    for (int c4 = 0; c4 < kNb / 4; ++c4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * c4 + e;
        v[e] = row.diag >= 0 && j > row.diag ? 0.f : row.x[j];
      }
      *reinterpret_cast<float4*>(dst + 4 * c4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    const int c = g - kNb - below;
#pragma unroll
    for (int j = 0; j < kNb; ++j) vg[j * kNb + c] = j >= c ? row.x[j] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
chol_factor_kernel(const float* __restrict__ m, float* l,
                   float* __restrict__ inv, int batch, int n, int n_pad,
                   bool vec) {
  extern __shared__ __align__(16) float bt[];  // [qs][kNb], then partials
  __shared__ __align__(16) Ring ring;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const float* mg = m + static_cast<size_t>(lane) * n * n;
  // L is read back after it is written: no read-only (nc) loads of it
  float* lg = l + static_cast<size_t>(lane) * n_pad * n_pad;
  const int blocks = n_pad / kNb;
  const int last_qs = n_pad - kNb;

  // 0. the zeros no block step writes: right of each row's diagonal block,
  // and left of the last block column in the padding rows
  for (int i = tid >> 5; i < n_pad; i += kWarps) {
    float* row = lg + static_cast<size_t>(i) * n_pad;
    for (int j = (i / kNb + 1) * kNb + (tid & 31); j < n_pad; j += 32)
      row[j] = 0.f;
    if (i >= n)
      for (int j = tid & 31; j < last_qs; j += 32) row[j] = 0.f;
  }

  for (int q = 0; q < blocks; ++q) {
    const int qs = q * kNb;
    const int rr = n - qs;                   // panel rows: qs .. n - 1
    const int w = rr < kNb ? rr : kNb;       // the block's columns below n
    const int below = rr > kNb ? rr - kNb : 0;
    const int total = kNb + below + kNb;     // sweep rows
    // sweep row g: the diagonal block's (g < 64; from the panel where
    // g < w), the panel's (64 <= g < 64 + below), or identity row
    // g - 64 - below; thread t takes row t and, from t = 64 up, row
    // 2 kThreads - 1 - t where there are more than kThreads rows
    const int g0 = tid, g1 = 2 * kThreads - 1 - tid;
    const bool two = total > kThreads;         // the same in every thread
    const bool on1 = tid >= kNb && g1 < total;
    Row rows[2];
    rows[0].diag = g0 < kNb ? g0 : -1;
    rows[1].diag = -1;

    // 1. the panel, P = M[qs:n, qs:qs+64] - L[qs:n, :qs] L[qs:qs+64, :qs]^T:
    // a thread per row (row t % rr), split over `groups` threads by k where
    // there are few rows; the groups' partial sums are added in order
    const int groups = q == 0 ? 1
                              : min(kMaxGroups, max(1, kThreads / rr));
    const int span = (qs / groups + 3) / 4 * 4;  // columns of L a group sums
    const int grp = tid / rr, prow = tid - grp * rr;
    if (q) {   // B^T[k][j] = L[qs + j, k], four loads in flight a thread
      for (int e0 = tid; e0 < kNb * (qs / 4); e0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kThreads;
          if (e < kNb * (qs / 4))
            v[u] = __ldcg(reinterpret_cast<const float4*>(
                lg + static_cast<size_t>(qs + e % kNb) * n_pad) + e / kNb);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kThreads;
          if (e >= kNb * (qs / 4)) break;
          const int j = e % kNb, k4 = e / kNb;
          bt[(4 * k4) * kNb + j] = v[u].x;
          bt[(4 * k4 + 1) * kNb + j] = v[u].y;
          bt[(4 * k4 + 2) * kNb + j] = v[u].z;
          bt[(4 * k4 + 3) * kNb + j] = v[u].w;
        }
      }
    }
    if (grp == 0 && prow < rr)
      load_panel(rows[0], mg + static_cast<size_t>(qs + prow) * n + qs, w,
                 vec);
    else
#pragma unroll
      for (int j = 0; j < kNb; ++j) rows[0].x[j] = 0.f;
    if (two && on1 && g1 < kNb + below)
      load_panel(rows[1], mg + static_cast<size_t>(qs + g1) * n + qs, w, vec);
    if (q) {
      __syncthreads();   // B^T is in
      if (grp < groups) {
        const int k0 = grp * span, k1 = min(qs, k0 + span);
        panel_sum(rows[0].x, lg + static_cast<size_t>(qs + prow) * n_pad,
                  bt, k0, k1 > k0 ? k1 : k0);
      }
      if (groups > 1) {
        __syncthreads();   // every B^T read is done: the partials go there
        if (grp >= 1 && grp < groups) {
          float* dst = bt + ((grp - 1) * rr + prow) * kNb;
#pragma unroll
          for (int c4 = 0; c4 < kNb / 4; ++c4)
            reinterpret_cast<float4*>(dst)[c4] = make_float4(
                rows[0].x[4 * c4], rows[0].x[4 * c4 + 1],
                rows[0].x[4 * c4 + 2], rows[0].x[4 * c4 + 3]);
        }
        __syncthreads();
        if (grp == 0)
          for (int h = 1; h < groups; ++h) {
            const float4* src = reinterpret_cast<const float4*>(
                bt + ((h - 1) * rr + prow) * kNb);
#pragma unroll
            for (int c4 = 0; c4 < kNb / 4; ++c4) {
              const float4 v = src[c4];
              rows[0].x[4 * c4] += v.x;
              rows[0].x[4 * c4 + 1] += v.y;
              rows[0].x[4 * c4 + 2] += v.z;
              rows[0].x[4 * c4 + 3] += v.w;
            }
          }
      }
    }
    // the rows that are not the panel's
    if (!(g0 < kNb ? g0 < w : g0 < kNb + below))
      load_identity(rows[0], g0 < kNb ? g0 : g0 - kNb - below);
    if (two && !(on1 && g1 < kNb + below))
      load_identity(rows[1], on1 ? g1 - kNb - below : 0);  // off: not stored

    // 2. the sweep
    if (tid == 0) ring.posted = 0;
    __syncthreads();   // every partial read; the ring is free
    if (tid < kNb)
      sweep_diag(rows[0], ring);
    else if (two)
      sweep_rows<2>(rows, ring);
    else
      sweep_rows<1>(rows, ring);

    // 3. the rows out: L's block column and V's columns
    float* lcol = lg + static_cast<size_t>(qs) * n_pad + qs;
    float* vg = inv + (static_cast<size_t>(q) * batch + lane) * kNb * kNb;
    if (g0 < total) store_row(rows[0], g0, below, lcol, n_pad, vg);
    if (two && on1) store_row(rows[1], g1, below, lcol, n_pad, vg);
    __syncthreads();   // L's block column is out before the next panel
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ l, const float* __restrict__ inv,
                  const float* __restrict__ r, float* __restrict__ x,
                  int batch, int n, int n_pad) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, t = tid & 31;
  const int lane = blockIdx.x;
  float* z = sm;                        // [n_pad]
  float* part = z + n_pad;              // [kWarps][kNb]
  float* acc = part + kWarps * kNb;     // [kNb]
  const float* lg = l + static_cast<size_t>(lane) * n_pad * n_pad;
  const int blocks = n_pad / kNb;
  for (int i = tid; i < n_pad; i += kThreads)
    z[i] = i < n ? r[static_cast<size_t>(lane) * n + i] : 0.f;
  __syncthreads();

  // forward: z_q = V_q (z_q - L[q rows, :qs] z[:qs]); warp w takes the
  // block's rows w + 8 u
  for (int q = 0; q < blocks; ++q) {
    const int qs = q * kNb;
    const float* vq = inv + (static_cast<size_t>(q) * batch + lane) * kNb *
                                kNb;
    float s[kNb / kWarps];
#pragma unroll
    for (int u = 0; u < kNb / kWarps; ++u) s[u] = 0.f;
    for (int k = t; k < qs; k += 32) {
      const float zk = z[k];
#pragma unroll
      for (int u = 0; u < kNb / kWarps; ++u)
        s[u] = fmaf(lg[static_cast<size_t>(qs + warp + kWarps * u) * n_pad +
                       k], zk, s[u]);
    }
#pragma unroll
    for (int u = 0; u < kNb / kWarps; ++u) {
      const float tot = warp_sum(s[u]);
      if (t == 0) acc[warp + kWarps * u] = z[qs + warp + kWarps * u] - tot;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kNb / kWarps; ++u) {
      const float* vrow = vq + (warp + kWarps * u) * kNb;
      s[u] = fmaf(vrow[t + 32], acc[t + 32], vrow[t] * acc[t]);
    }
#pragma unroll
    for (int u = 0; u < kNb / kWarps; ++u) {
      const float tot = warp_sum(s[u]);
      if (t == 0) z[qs + warp + kWarps * u] = tot;
    }
    __syncthreads();
  }

  // backward: x_q = V_q^T (z_q - L[qe:n, q cols]^T x[qe:n]); lanes take the
  // block's columns t and t + 32, warps the rows
  for (int q = blocks - 1; q >= 0; --q) {
    const int qs = q * kNb, qe = qs + kNb;
    const float* vq = inv + (static_cast<size_t>(q) * batch + lane) * kNb *
                                kNb;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int i = qe + warp; i < n; i += kWarps) {
      const float* row = lg + static_cast<size_t>(i) * n_pad + qs;
      const float xi = z[i];
      s0 = fmaf(row[t], xi, s0);
      s1 = fmaf(row[t + 32], xi, s1);
    }
    part[warp * kNb + t] = s0;
    part[warp * kNb + t + 32] = s1;
    __syncthreads();
    if (tid < kNb) {
      float tot = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) tot += part[v * kNb + tid];
      acc[tid] = z[qs + tid] - tot;
    }
    __syncthreads();
    // (V^T acc)_j = sum_c V_cj acc_c: warp w takes c = w + 8 u
    s0 = s1 = 0.f;
#pragma unroll
    for (int u = 0; u < kNb / kWarps; ++u) {
      const int c = warp + kWarps * u;
      const float ac = acc[c];
      s0 = fmaf(vq[c * kNb + t], ac, s0);
      s1 = fmaf(vq[c * kNb + t + 32], ac, s1);
    }
    part[warp * kNb + t] = s0;
    part[warp * kNb + t + 32] = s1;
    __syncthreads();
    if (tid < kNb) {
      float tot = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) tot += part[v * kNb + tid];
      z[qs + tid] = tot;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads)
    x[static_cast<size_t>(lane) * n + i] = z[i];
}

}  // namespace

extern "C" {

// The largest n the fused factor and solve take (the blocked chain of
// ops/chol.py factors larger n).
int ldpc_chol_fused_max_n() { return kMaxN; }

// Factor `batch` SPD (n, n) float32 matrices `m` (contiguous) into `l`
// (batch, n_pad, n_pad) and `inv` (n_pad / 64, batch, 64, 64), n_pad = n
// rounded up to 64, one block of kThreads per lane, on `stream`; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an n outside
// 1..kMaxN or a wrong n_pad). Does not synchronise.
int ldpc_chol_factor(const void* m, void* l, void* inv, int batch, int n,
                     int n_pad, void* stream) {
  const bool vec =
      n % 4 == 0 && (reinterpret_cast<uintptr_t>(m) & 15u) == 0;
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || n > kMaxN || n_pad != (n + kNb - 1) / kNb * kNb)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      chol_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFactorSmem));
  if (e != cudaSuccess) return e;
  chol_factor_kernel<<<batch, kThreads, kFactorSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<float*>(l),
      static_cast<float*>(inv), batch, n, n_pad, vec);
  return cudaGetLastError();
}

// Solve M x = r for `batch` lanes from ldpc_chol_factor's `l` and `inv`:
// r and x (batch, n) float32, contiguous; on `stream`, without
// synchronising.
int ldpc_chol_solve(const void* l, const void* inv, const void* r, void* x,
                    int batch, int n, int n_pad, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || n > kMaxN || n_pad != (n + kNb - 1) / kNb * kNb)
    return cudaErrorInvalidValue;
  chol_solve_kernel<<<batch, kThreads, solve_smem(n_pad),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(inv),
      static_cast<const float*>(r), static_cast<float*>(x), batch, n, n_pad);
  return cudaGetLastError();
}

}  // extern "C"
