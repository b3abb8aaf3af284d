// QP-ADMM's iteration for NVIDIA Hopper (sm_90a): several (lane,
// candidate) pairs of one candidate per block, each to its own stop or to
// the launch's `iters`, with the candidate's tables read once per launch.
//
// No Pallas kernel stands behind this one. In ldpc_tpu/decoders/admm.py
// `decode_qp_admm` is one lax.while_loop (:184-197) whose body, `iter_fn`
// (:249-262), XLA fuses into a few loops; `stream_chunk` is a second
// while_loop (:351-365). Eager PyTorch ran each iteration as ~56 small
// kernels with a host read every 32 iterations; here a chunk is one launch
// and the host reads nothing inside it. ldpc_tpu_torch/ops/admm_kernel.py
// wraps it; the plain twin is `admm_iterate_ref` in
// ldpc_tpu_torch/ops/admm_ref.py.
//
// What bounds it: one iteration of one optimalH lane is ~40,600 float32
// operations (the bytes a chunk moves, the state read and written once,
// are far below), so the bound is operations; in practice shared memory:
// the random gathers of t by the variables (6,960 a lane-iteration on
// optimalH) and of v by the constraints, and their bank conflicts.
//
// Design (a template tier <T, L, RV, RQ, B, G> fixes the threads and lanes
// per block, each thread's rows, the blocks per SM its registers allow and
// where the tables and the state live: optimalH's shape runs as two blocks
// of 256 threads and 2 lanes per SM, whose barriers drift apart so that one
// block's variable pass overlaps the other's constraint pass; the
// optimizer's caps and H02 as one block of 512 threads and 2 lanes; up to
// 4,096 variables and 10,240 constraints 512 threads and 1 lane; any other
// shape the largest pair of the one-block-per-pair design took (v, q,
// inv_coef, t, z and yl in 227 KB, about 19,000 rows) and more runs in the
// global tier, G):
//  * Tables once per launch. `pack_tables` gives each candidate a compact
//    copy that the block copies into shared memory when it starts; no code
//    is read from device memory inside the iteration loop. A code of all
//    ones (an entry outside the kernel's contract) makes the block trap.
//    The global tier, for tables that do not fit beside the state, reads
//    the same copy from device memory through the read-only path instead.
//  * Quads of constraints. The cascade adds a check's constraints in
//    groups of four over the same three variables (`add_three`), so rows
//    are taken four at a time: t lives in shared memory as [quad][lane][4]
//    (the lanes swizzled within a quad against bank conflicts) and v as
//    [row][lane]. A thread owns quads of one lane (lane = thread % L): for
//    a quad whose four rows name the same variables (`pack_tables`' flag)
//    it gathers the three v once, not four times, and writes the four t
//    with one vector store; the cascade's sign pattern (+--, -+-, --+,
//    +++) has its own path with the signs in the code, the same products.
//    A variable's four slots in a group are four consecutive t rows: its
//    compact row holds one 32-bit item for them (the quad and four signs)
//    or one item per other slot, and one vector load reads the item for a
//    lane.
//  * L lanes of one candidate per block share the tables. Each thread owns
//    RV variable positions for all L lanes (q + alpha/2 and inv_coef in
//    registers) and RQ quads of its lane (z and yl in registers). The
//    variables are owned in `pack_tables`' order (real variables by
//    degree, descending), even rounds forwards, odd rounds backwards, and
//    their items laid out slot-major in groups of 32 positions, so a warp's
//    threads run near-equal item counts and read codes without conflicts.
//    The global tier (one lane) loops over its positions at run time,
//    computes q + alpha/2 and inv_coef where it needs them, and keeps z and
//    yl in the pair's rows of device memory, which only their owner reads.
//  * Pairs come from a queue per candidate (an atomic counter): the grid
//    fills the card once, and a block that finishes a pair writes it back
//    and takes the next, so no lane waits for its block-mates.
//  * Padding. The trailing rows that no real row refers to and whose codes
//    are all 0 (`pack_tables`' real counts) are not iterated. A padding
//    variable's v is never read; it is written at the end in closed form
//    from the last iteration's t[0] * 0 (its every slot reads that zero).
//    A padding constraint with b = +0 stays at z = yl = +0 and adds +0 to
//    sum2 while v[0] is finite, so its quads are skipped as long as every
//    live pair's padding z and yl were +0 at load and its v[0] has stayed
//    finite; an iteration in which some pair fails that runs every quad
//    (the registers hold every row's state), which is the twin exactly.
//
// Bit for bit with the twin in v, z, yl, done and it:
//  * every product and sum rounds on its own (__fmul_rn, __fadd_rn,
//    __fsub_rn, __fdiv_rn): nvcc would contract a * b + c into an FMA;
//  * torch's association: t = yl + mu (z - b); bq = (q + alpha/2) + acc;
//    r = b - ((p0 + p1) + p2); a coefficient of +-1 multiplies exactly, so
//    p = +-t[c] is the product (the sign is an exclusive-or of the code's
//    sign bit);
//  * acc sums a variable's slots as XLA on the CPU sums a reduction (the
//    twin's `xla_sum`). Up to 32 slots a variable (k <= 32, the tables'
//    width, caps included): acc = p_0, then acc + p_1, ... in slot order.
//    Past 32 the slots fall in windows of 32, the first
//    floor((32 ceil(k / 32) - k) / 2) of which are padding in front:
//    each window is summed in order from +0, and the windows' sums by the
//    same rule again: in order from +0 up to 32 windows, and past that in
//    windows of 32 windows from +0 with their own front padding, whose
//    sums are added in order (k <= kMaxSlots makes at most 1,024 windows,
//    so two levels are all there are). `pack_tables` splits a quad of
//    slots that crosses a window's boundary into four items and marks the
//    item that starts each window but the first (kWin); the kernel's
//    template flag W (k > 32) takes that path, so the code of k <= 32 is
//    the same as without it, and keeps a window's sum and a sum of windows
//    beside acc. A sum from +0 is never -0, so adding
//    padding (+0, or t[0] * 0 of either sign) to it changes nothing, and a
//    window or a group of windows made of padding alone adds +0;
//  * a padding slot reads the pair's entry 0 times 0, as the twin gathers
//    it (a zero row beside v and t, rewritten each iteration): on the
//    variable side in its slot up to the last real one and once for the
//    trailing ones (adding the same zero again changes nothing; past 32
//    slots nothing at all), on the constraint side in its slot;
//  * the clamps keep NaN, as torch's clamp and clamp_min do;
//  * eps_stop arrives as float32, as torch compares it.
// sum2 is summed in this kernel's own fixed order, the same in every tier:
// a leaf per quad of constraints (its rows' d * d added in row order to
// +0), and a butterfly over the quads' indices, whose first level adds
// quad g + 2^(K-1) to quad g, the next g + 2^(K-2), and so on, for the
// 2^K leaves of the tier (8 quads a thread's lane, 16 in the global tier:
// each thread's quads g = r (T / L) + its place). Leaves past the pair's
// rows, and skipped padding quads, are +0, and adding +0 to a partial sum
// (never -0) changes no bit, so the sum is the same whatever 2^K is: it
// depends on the pair alone, never on the tier or the caps, the batch, the
// candidate count, the launch or the block-mates. A thread sums its own
// quads' levels (in the order that frees registers soonest), the block the
// warps' levels through shared memory, then the warp the rest by
// shuffles. So a pair's stop can differ from the twin's only where sum2
// lies within rounding of eps_stop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kMaxSmem = 232448;     // the H100's opt-in limit per block
constexpr unsigned kBad16 = 0xffffu;       // a constraint code outside
constexpr unsigned kBad32 = 0xffffffffu;   // a variable item outside
constexpr unsigned kSign16 = 0x8000u;      // constraint code: -1
constexpr unsigned kRun = 0x80000000u;     // variable item: a quad of slots
constexpr unsigned kWin = 0x40000000u;     // variable item: starts a window
constexpr int kWindow = 32;                // XLA's window past 32 terms
// var_info (64 bits): base | items << 32 | (slots < k) << 48 | (the
// variable is 0) << 49; a register tier packs it into 32 bits as base |
// items << 17 | trail << 26 | var0 << 27
constexpr int kLenShift = 17;
constexpr int kTrailBit = 26;
constexpr int kVar0Bit = 27;
constexpr int kMaxLen = 511;         // slots a variable in a register tier
constexpr int kMaxSlots = 32767;     // slots a variable in any tier
static_assert(kMaxSlots <= 32 * 32 * 32, "two levels of XLA's windows");
constexpr int kCtl = 16;             // ints of slot control in shared memory

struct Tier {
  int threads, lanes, rv, rq, blocks;
  bool global;
};
// threads and lanes per block, variable positions and constraint quads per
// thread, the blocks per SM the registers are bounded for, and whether the
// tables stay in device memory (the state out of registers)
constexpr Tier kTiers[4] = {{256, 2, 3, 5, 2, false},
                            {512, 2, 3, 5, 1, false},
                            {512, 1, 8, 5, 1, false},
                            {512, 1, 0, 16, 1, true}};
constexpr int kTierCount = 4;

__host__ __device__ constexpr long long align4(long long n) {
  return (n + 3) / 4 * 4;
}

// items of a candidate's variable CSR: at most one a slot, k a variable in
// groups of 32, and at most the real slots (3 a constraint) plus what the
// degree-sorted groups leave empty (32 k for the groups, 32 k for the last)
long long csr_capacity(int n_var, int n_con, int k) {
  const long long by_var =
      static_cast<long long>(k) * ((n_var + 31) / 32 * 32);
  const long long by_con = 3LL * n_con + 64LL * k;
  const long long cap = by_var < by_con ? by_var : by_con;
  return (cap + 7) / 8 * 8;
}

// shared bytes of a block: v ([row][lane]) and t ([quad][lane][4]) with
// their zero rows, b by quads, the threads' parts of sum2 (a row of the
// warps' parts, padded by 4, for each of the 32 (lane, place in a warp)),
// the slot control, and but in the global tier the constraints' codes (8
// bytes a row, whole quads) and the variables' items
long long smem_bytes(const Tier& t, int n_var, int n_con, int k) {
  const long long nq = (n_con + 3) / 4;
  const long long state =
      4 * (align4(static_cast<long long>(t.lanes) * (n_var + 1)) +
           4 * t.lanes * (nq + 1) + 4 * nq + t.threads + 128 + kCtl);
  return t.global ? state : state + 32 * nq + 4 * csr_capacity(n_var, n_con, k);
}

// the first tier whose rows cover the shape and whose block fits, or -1
int pick_tier(int n_var, int n_con, int k) {
  if (n_var < 1 || n_con < 1 || k < 1 || k > kMaxSlots || n_var > 32766 ||
      n_con > 32766)
    return -1;
  const int nq = (n_con + 3) / 4;
  for (int i = 0; i < kTierCount; ++i) {
    const Tier& t = kTiers[i];
    const bool rows =
        t.global ? nq <= t.rq * t.threads
                 : k <= kMaxLen && n_var <= t.rv * t.threads &&
                       nq <= t.rq * (t.threads / t.lanes);
    if (rows && smem_bytes(t, n_var, n_con, k) <= kMaxSmem) return i;
  }
  return -1;
}

// torch.clamp(x, 0, 1) and clamp_min(x, 0): NaN passes
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : (x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x));
}
__device__ __forceinline__ float clamp_min0(float x) {
  return isnan(x) ? x : (x < 0.0f ? 0.0f : x);
}

__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

// the 16-byte chunk of lane l of quad g in t: lanes swizzled within a
// quad, so that one lane's chunks of random quads spread over all eight
// bank groups (unswizzled they would fall in two)
template <int L>
__device__ __forceinline__ int tchunk(int g, int l) {
  return g * L + (l ^ (g & (L - 1)));
}

// the L lanes of one row of v ([row][lane])
template <int L>
__device__ __forceinline__ void store_row(float* p, const float (&x)[L]) {
  if constexpr (L == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (L == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// a table entry: from the shared copy, or in the global tier from device
// memory through the read-only path
template <bool G, typename V>
__device__ __forceinline__ V entry(const V* p) {
  if constexpr (G) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// one item of a variable's row added into acc for all L lanes (acc set by
// the first item): a quad of four slots (four t rows, one vector load a
// lane) or one slot; signs by exclusive-or (kWin is not read here)
template <int L, bool kFirst>
__device__ __forceinline__ void add_item(const float* st, unsigned c,
                                         float (&acc)[L]) {
  if (c & kRun) {
    const float4* q4 = reinterpret_cast<const float4*>(st);
    const int g = c & 0xffffu;
    const unsigned s0 = (c << 15) & kRun, s1 = (c << 14) & kRun;
    const unsigned s2 = (c << 13) & kRun, s3 = (c << 12) & kRun;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float4 x = q4[tchunk<L>(g, l)];
      float a = kFirst ? flip(x.x, s0) : __fadd_rn(acc[l], flip(x.x, s0));
      a = __fadd_rn(a, flip(x.y, s1));
      a = __fadd_rn(a, flip(x.z, s2));
      acc[l] = __fadd_rn(a, flip(x.w, s3));
    }
  } else {
    const unsigned row = c & 0xffffu, sign = (c << 15) & kRun;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float x =
          flip(st[tchunk<L>(row >> 2, l) * 4 + (row & 3u)], sign);
      acc[l] = kFirst ? x : __fadd_rn(acc[l], x);
    }
  }
}

// the variable position of thread `tid` of T in round r: forwards in
// even rounds, backwards in odd ones
template <int T>
__device__ __forceinline__ int position(int r, int tid) {
  return r * T + ((r & 1) ? T - 1 - tid : tid);
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

__host__ __device__ constexpr int log2_of(int m) {
  return m <= 1 ? 0 : 1 + log2_of(m / 2);
}

// the trailing one bits of m, at most `cap`: the butterfly levels that
// the leaf of round m completes
__device__ __forceinline__ int trailing_ones(int m, int cap) {
  int n = 0;
  while (n < cap && ((m >> n) & 1)) ++n;
  return n;
}

// the butterfly over the W warps' parts at p (16-byte aligned), by float4
// chunks: chunk k pairs with chunk k + W / 8 first, then the four lanes of
// the last chunk, x with z and y with w, then the two
template <int W>
__device__ __forceinline__ float cross_warps(const float* p) {
  static_assert(W == 8 || W == 16, "8 or 16 warps a block");
  const float4* v = reinterpret_cast<const float4*>(p);
  float4 a = v[0], b = v[W / 8];
  a = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                  __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  if constexpr (W == 16) {
    float4 c = v[1];
    const float4 d = v[3];
    c = make_float4(__fadd_rn(c.x, d.x), __fadd_rn(c.y, d.y),
                    __fadd_rn(c.z, d.z), __fadd_rn(c.w, d.w));
    a = make_float4(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                    __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w));
  }
  return __fadd_rn(__fadd_rn(a.x, a.z), __fadd_rn(a.y, a.w));
}

// m with its log2(M) bits reversed: a thread runs its quad rounds in that
// order, so that the butterfly's pairs complete early and free registers
template <int M>
__device__ __forceinline__ int bit_reverse(int m) {
  int r = 0;
#pragma unroll
  for (int b = 1, s = M / 2; b < M; b <<= 1, s >>= 1)
    if (m & b) r |= s;
  return r;
}

struct Params {
  const float* q;
  float* v;
  float* z;
  float* yl;
  uint8_t* done;
  int* it;
  const unsigned* var_csr;   // (P, csr_cap) items
  const long long* var_info; // (P, n_var) by position
  const int* var_pos;        // (P, n_var) position -> variable
  const uint16_t* con_code;  // (P, 4 * nq, 4)
  const int* real;           // (P, 2): real variables, real constraints
  const float* b;            // (P, n_con)
  const float* e;            // (P, n_var)
  const float* alpha;        // (batch,)
  const float* mu;           // (batch,)
  float* sum2_out;           // (batch, P) or null
  int* queue;                // (P,) zeros
  int batch, p_count, n_var, n_con, k, csr_cap;
  float eps_stop;
  int max_iter, iters;
};

template <int T, int L, int RV, int RQ, int B, bool G, bool W>
__global__ void __launch_bounds__(T, B)
    admm_iterate_kernel(const Params p) {
  static_assert(!G || L == 1, "the global tier runs one lane a block");
  constexpr int kThreads = T;
  constexpr int kWarps = T / 32;
  constexpr int kQuadThreads = T / L;          // threads of one lane
  constexpr int kLaneWarp = 32 / L;            // of one lane in a warp
  constexpr int kRV = G ? 1 : RV;              // positions in registers
  constexpr int kRQ = G ? 1 : RQ;              // quads in registers
  // a row of the warps' parts: padded by 4 floats, so that the 32 rows a
  // warp reads as float4 fall on all eight bank groups
  constexpr int kRedRow = kWarps + 4;
  static_assert(kWarps % 4 == 0, "the warps' parts are read as float4");
  extern __shared__ __align__(16) float smem[];
  const int n_var = p.n_var, n_con = p.n_con, P = p.p_count;
  const int nq = (n_con + 3) / 4;
  float* sv = smem;                                   // [n_var + 1][L]
  float* st = sv + align4(static_cast<long long>(L) * (n_var + 1));
  float* sb = st + 4 * L * (nq + 1);                  // [nq][4]
  float* red = sb + 4 * nq;         // [lane][place in warp][kRedRow]
  int* ctl = reinterpret_cast<int*>(red + 32 * kRedRow);
  uint16_t* scode = reinterpret_cast<uint16_t*>(ctl + kCtl);
  unsigned* scsr = reinterpret_cast<unsigned*>(scode + 16 * nq);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int my_l = tid % L, tq = tid / L, my_s = lane / L;
  const int cand = blockIdx.x % P;

  // the candidate's compact tables and b, once per launch
  const uint2* gcc = reinterpret_cast<const uint2*>(p.con_code) +
                     static_cast<size_t>(cand) * 4 * nq;
  const unsigned* gcsr = p.var_csr + static_cast<size_t>(cand) * p.csr_cap;
  const float* bc = p.b + static_cast<size_t>(cand) * n_con;
  const uint16_t* ccode =
      G ? reinterpret_cast<const uint16_t*>(gcc) : scode;
  const unsigned* vcsr = G ? gcsr : scsr;
  int bad = 0;
  for (int i = tid; i < 4 * nq; i += kThreads) {
    const uint2 w = __ldg(gcc + i);
    if constexpr (!G) reinterpret_cast<uint2*>(scode)[i] = w;
    bad |= (w.x & 0xffffu) == kBad16 || (w.x >> 16) == kBad16 ||
           (w.y & 0xffffu) == kBad16;
    sb[i] = i < n_con ? __ldg(bc + i) : 0.0f;
  }
  for (int i = tid; i < p.csr_cap; i += kThreads) {
    const unsigned c = __ldg(gcsr + i);
    if constexpr (!G) scsr[i] = c;
    bad |= c == kBad32;
  }
  if (__syncthreads_or(bad)) {
    if (tid == 0)
      printf("ldpc_admm_iterate: candidate %d's tables hold an entry "
             "outside the kernel's contract (coefficient outside {-1, 0, "
             "1}, or an index out of range)\n", cand);
    __trap();
  }
  const int nv_real = __ldg(p.real + 2 * cand);
  const int nc_real = __ldg(p.real + 2 * cand + 1);
  const long long* vinfo = p.var_info + static_cast<size_t>(cand) * n_var;
  const int* vpos = p.var_pos + static_cast<size_t>(cand) * n_var;
  const float* ec = p.e + static_cast<size_t>(cand) * n_var;
  int info[kRV];
  if constexpr (!G) {
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      const int pos = position<T>(r, tid);
      const long long x = pos < n_var ? __ldg(vinfo + pos) : 0;
      info[r] = static_cast<int>(x & 0xffffffffLL) |
                static_cast<int>((x >> 32) & 0xffff) << kLenShift |
                static_cast<int>((x >> 48) & 1) << kTrailBit |
                static_cast<int>((x >> 49) & 1) << kVar0Bit;
    }
  }
  // the positions a thread runs: RV in a register tier, as many rounds of
  // T as the pair's rows need in the global tier
  const int rounds_v = G ? (n_var + kThreads - 1) / kThreads : RV;

  // each slot's pair and counts (the same in every thread); the owner's
  // state: q + alpha/2 and inv_coef of its positions for every lane, z
  // and yl of its quads for its lane (in the global tier alpha and mu of
  // its one lane, and where the pair's rows start)
  int pair[L], cnt[L], ran[L];
  float tz[L];
  float m_own = 0.0f, a_own = 0.0f, half_own = 0.0f;
  size_t rv_own = 0, rc_own = 0;
  float qh[kRV][L], inv[kRV][L], zr[kRQ][4], yr[kRQ][4];
  unsigned active = 0, live = 0, need = (1u << L) - 1;
  if (p.iters <= 0) return;

  for (;;) {
    if (need) {
      // take the next pairs of the candidate's queue for the free slots
      if (tid == 0) {
        ctl[kCtl - 1] = 0;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!((need >> l) & 1)) continue;
          int got = -1;
          for (;;) {
            const int idx = atomicAdd(p.queue + cand, 1);
            if (idx >= p.batch) break;
            const int pid = idx * P + cand;
            if (!p.done[pid]) {
              got = pid;
              break;
            }
          }
          ctl[l] = got;
          ctl[L + l] = got >= 0 ? p.it[got] : 0;
        }
      }
      __syncthreads();
      unsigned mine = 0;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!((need >> l) & 1)) continue;
        const int pid = ctl[l];
        pair[l] = pid;
        if (pid < 0) {
          active &= ~(1u << l);
          continue;
        }
        active |= 1u << l;
        cnt[l] = ctl[L + l];
        ran[l] = 0;
        const int bl = pid / P;
        const float a = __ldg(p.alpha + bl), m = __ldg(p.mu + bl);
        const float half = __fdiv_rn(a, 2.0f);
        if (my_l == l) {
          m_own = m;
          a_own = a;
          half_own = half;
          rv_own = static_cast<size_t>(pid) * n_var;
          rc_own = static_cast<size_t>(pid) * n_con;
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
            const int q = r * kQuadThreads + tq;
            if (q >= nq) continue;
            float t4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 4 * q + i;
              t4[i] = 0.0f;
              if (c >= n_con) continue;
              const float zc = p.z[rc_own + c], yc = p.yl[rc_own + c];
              if constexpr (!G) {
                zr[r][i] = zc;
                yr[r][i] = yc;
              }
              if (c < nc_real)
                t4[i] = __fadd_rn(yc, __fmul_rn(m, __fsub_rn(zc, sb[c])));
              else if ((__float_as_uint(zc) | __float_as_uint(yc)) != 0u)
                mine |= 1u << l;      // padding state off the fixed point
            }
            reinterpret_cast<float4*>(st)[tchunk<L>(q, l)] =
                make_float4(t4[0], t4[1], t4[2], t4[3]);
            if (q == 0) st[tchunk<L>(nq, l) * 4] = __fmul_rn(t4[0], 0.0f);
          }
        }
        if constexpr (!G) {
          const size_t rv0 = static_cast<size_t>(pid) * n_var;
#pragma unroll
          for (int r = 0; r < RV; ++r) {
            const int pos = position<T>(r, tid);
            if (pos >= nv_real) continue;
            const int i = __ldg(vpos + pos);
            qh[r][l] = __fadd_rn(p.q[rv0 + i], half);
            const float den = __fsub_rn(__fmul_rn(m, __ldg(ec + i)), a);
            inv[r][l] = __fdiv_rn(-1.0f, den == 0.0f ? 1.0f : den);
          }
        }
      }
      if (mine) atomicOr(ctl + kCtl - 1, static_cast<int>(mine));
      __syncthreads();
      live = (live & ~need) | static_cast<unsigned>(ctl[kCtl - 1]);
      need = 0;
      if (!active) break;
    }

    // variable pass over the real positions, all lanes
#pragma unroll
    for (int l = 0; l < L; ++l) tz[l] = st[tchunk<L>(nq, l) * 4];
#pragma unroll
    for (int r = 0; r < rounds_v; ++r) {
      const int pos = position<T>(r, tid);
      if (pos >= nv_real) continue;
      int base, items;
      bool trail, var0;
      float qv[L], iv[L];
      if constexpr (G) {
        const long long x = __ldg(vinfo + pos);
        base = static_cast<int>(x & 0xffffffffLL);
        items = static_cast<int>((x >> 32) & 0xffff);
        trail = (x >> 48) & 1;
        var0 = (x >> 49) & 1;
        const int i = __ldg(vpos + pos);
        qv[0] = __fadd_rn(__ldg(p.q + rv_own + i), half_own);
        const float den = __fsub_rn(__fmul_rn(m_own, __ldg(ec + i)), a_own);
        iv[0] = __fdiv_rn(-1.0f, den == 0.0f ? 1.0f : den);
      } else {
        base = info[r] & ((1 << kLenShift) - 1);
        items = (info[r] >> kLenShift) & kMaxLen;
        trail = (info[r] >> kTrailBit) & 1;
        var0 = (info[r] >> kVar0Bit) & 1;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          qv[l] = qh[r][l];
          iv[l] = inv[r][l];
        }
      }
      float acc[L], x[L];
      if constexpr (W) {
        // a window's sum, and the windows' sums of the current group of
        // 32 windows; the window a kWin item starts is counted in w, and
        // a group ends where XLA's second level (its own front padding
        // before the k / 32 windows' sums) puts a boundary
        const int n_win = (p.k + kWindow - 1) / kWindow;
        const int front2 =
            ((n_win + kWindow - 1) / kWindow * kWindow - n_win) / 2;
        float win[L], grp[L];
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = grp[l] = win[l] = 0.0f;
        // (the first item sets win as in slot order: a window's sum from
        // +0 differs from it only as -0 against +0, and folding into grp,
        // which starts from +0, makes that +0 too); a kWin item folds win
        // into grp by selects, not by a branch, which runs faster
        int w = 0;
        add_item<L, true>(st, entry<G>(vcsr + base), win);
#pragma unroll 2
        for (int j = 1; j < items; ++j) {
          const unsigned c = entry<G>(vcsr + base + 32 * j);
          const bool m = (c & kWin) != 0;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const float g = __fadd_rn(grp[l], win[l]);
            grp[l] = m ? g : grp[l];
            win[l] = m ? 0.0f : win[l];
          }
          w += m;
          if (m && ((w + front2) & (kWindow - 1)) == 0) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
              acc[l] = __fadd_rn(acc[l], grp[l]);
              grp[l] = 0.0f;
            }
          }
          add_item<L, false>(st, c, win);
        }
#pragma unroll
        for (int l = 0; l < L; ++l)
          acc[l] = __fadd_rn(acc[l], __fadd_rn(grp[l], win[l]));
      } else {
        add_item<L, true>(st, entry<G>(vcsr + base), acc);
#pragma unroll 2
        for (int j = 1; j < items; ++j)
          add_item<L, false>(st, entry<G>(vcsr + base + 32 * j), acc);
      }
      if (trail) {
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = __fadd_rn(acc[l], tz[l]);
      }
#pragma unroll
      for (int l = 0; l < L; ++l)
        x[l] = clamp01(__fmul_rn(__fadd_rn(qv[l], acc[l]), iv[l]));
      store_row<L>(sv + pos * L, x);
      if (var0) {
#pragma unroll
        for (int l = 0; l < L; ++l) x[l] = __fmul_rn(x[l], 0.0f);
        store_row<L>(sv + n_var * L, x);
      }
    }
    __syncthreads();

    // constraint pass, this thread's lane: the real quads, or every quad
    // when a live pair's padding is off its fixed point or its v[0] is not
    // finite; each quad's leaf of sum2
    unsigned nan_v = 0;
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (isnan(sv[n_var * L + l])) nan_v |= 1u << l;
    const int qbound = ((live | nan_v) & active) ? nq : (nc_real + 3) / 4;
    // the thread's levels of the butterfly, summed as its leaves arrive:
    // in bit-reversed round order a pair of siblings is two neighbours,
    // the earlier on the left (levels with nothing, the leaves past RQ,
    // are +0 and pass the other side through)
    constexpr int kM = pow2_at_least(RQ);
    constexpr int kLog = log2_of(kM);
    float lvl[kLog + 1];
    bool has[kLog + 1];
#pragma unroll
    for (int b = 0; b <= kLog; ++b) has[b] = false;
#pragma unroll
    for (int o = 0; o < kM; ++o) {
      const int r = bit_reverse<kM>(o);
      const int q = r * kQuadThreads + tq;
      float leaf = 0.0f;
      if (r < RQ && q < qbound) {
        const uint4* cq = reinterpret_cast<const uint4*>(ccode) + 2 * q;
        const uint4 w01 = entry<G>(cq), w23 = entry<G>(cq + 1);
        const unsigned code[4][3] = {
            {w01.x & 0xffffu, w01.x >> 16, w01.y & 0xffffu},
            {w01.z & 0xffffu, w01.z >> 16, w01.w & 0xffffu},
            {w23.x & 0xffffu, w23.x >> 16, w23.y & 0xffffu},
            {w23.z & 0xffffu, w23.z >> 16, w23.w & 0xffffu}};
        const float4 b4 = reinterpret_cast<const float4*>(sb)[q];
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
        float x[4][3];
        const unsigned flag = w01.y >> 16;
        if (flag & 2u) {      // the cascade's quad: the products by their signs
          const float g0 = sv[(code[0][0] & 0x7fffu) * L + my_l];
          const float g1 = sv[(code[0][1] & 0x7fffu) * L + my_l];
          const float g2 = sv[(code[0][2] & 0x7fffu) * L + my_l];
          x[0][0] = g0;  x[0][1] = -g1; x[0][2] = -g2;
          x[1][0] = -g0; x[1][1] = g1;  x[1][2] = -g2;
          x[2][0] = -g0; x[2][1] = -g1; x[2][2] = g2;
          x[3][0] = g0;  x[3][1] = g1;  x[3][2] = g2;
        } else if (flag & 1u) {   // four rows over the same variables
  #pragma unroll
          for (int s = 0; s < 3; ++s) {
            const float g = sv[(code[0][s] & 0x7fffu) * L + my_l];
  #pragma unroll
            for (int i = 0; i < 4; ++i)
              x[i][s] = flip(g, (code[i][s] & kSign16) << 16);
          }
        } else {
  #pragma unroll
          for (int i = 0; i < 4; ++i)
  #pragma unroll
            for (int s = 0; s < 3; ++s)
              x[i][s] = flip(sv[(code[i][s] & 0x7fffu) * L + my_l],
                             (code[i][s] & kSign16) << 16);
        }
        float t4[4];
  #pragma unroll
        for (int i = 0; i < 4; ++i) {
          t4[i] = 0.0f;
          const int c = 4 * q + i;
          if (c >= n_con) continue;
          const float rr = __fsub_rn(
              bq[i], __fadd_rn(__fadd_rn(x[i][0], x[i][1]), x[i][2]));
          const float yo = G ? p.yl[rc_own + c] : yr[G ? 0 : r][i];
          const float zn = clamp_min0(__fsub_rn(rr, yo));
          const float yn = clamp_min0(__fsub_rn(yo, rr));
          const float d = __fsub_rn(zn, rr);
          leaf = __fadd_rn(leaf, __fmul_rn(d, d));
          if constexpr (G) {
            p.z[rc_own + c] = zn;
            p.yl[rc_own + c] = yn;
          } else {
            zr[r][i] = zn;
            yr[r][i] = yn;
          }
          t4[i] = __fadd_rn(yn, __fmul_rn(m_own, __fsub_rn(zn, bq[i])));
        }
        reinterpret_cast<float4*>(st)[tchunk<L>(q, my_l)] =
            make_float4(t4[0], t4[1], t4[2], t4[3]);
        if (q == 0) st[tchunk<L>(nq, my_l) * 4] = __fmul_rn(t4[0], 0.0f);
      }
      bool here = r < RQ;
      const int top = trailing_ones(o, kLog);
#pragma unroll
      for (int b = 0; b < kLog; ++b) {
        if (b >= top) continue;
        if (has[b]) {
          leaf = here ? __fadd_rn(lvl[b], leaf) : lvl[b];
          here = true;
        }
        has[b] = false;
      }
      lvl[top] = leaf;
      has[top] = here;
    }
    // sum2's butterfly: this thread's quads (the top levels), then the
    // warps (quad bits of the warp), then the threads of a lane in a warp
    red[(my_l * kLaneWarp + my_s) * kRedRow + warp] = lvl[kLog];
    __syncthreads();

    // every thread sums the parts in one order and decides alike: the
    // warps' levels for its own lane and place, the warp's by shuffles,
    // then the other lanes' sums from their threads
    unsigned fin = 0, stop = 0;
    float s2[L];
    float own = cross_warps<kWarps>(
        red + (my_l * kLaneWarp + my_s) * kRedRow);
#pragma unroll
    for (int off = 16; off >= L; off >>= 1)
      own = __fadd_rn(own, __shfl_xor_sync(0xffffffffu, own, off));
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float x =
          L == 1 ? own
                 : __shfl_sync(0xffffffffu, own, (lane & ~(L - 1)) | l);
      s2[l] = x;
      if (!((active >> l) & 1)) continue;
      ++cnt[l];
      ++ran[l];
      if (x < p.eps_stop || cnt[l] >= p.max_iter) stop |= 1u << l;
      if (((stop >> l) & 1) || ran[l] >= p.iters) fin |= 1u << l;
    }
    live |= nan_v & active;
    if (!fin) continue;

    // write the finished pairs back: v of the real positions from shared
    // memory, of the padding ones in closed form, and the owners' z, yl
    // (already in place in the global tier)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (!((fin >> l) & 1)) continue;
      const int pid = pair[l];
      const size_t rv0 = static_cast<size_t>(pid) * n_var;
      const int bl = pid / P;
      const float a = __ldg(p.alpha + bl), m = __ldg(p.mu + bl);
#pragma unroll
      for (int r = 0; r < rounds_v; ++r) {
        const int pos = position<T>(r, tid);
        if (pos >= n_var) continue;
        const int i = __ldg(vpos + pos);
        float val;
        if (pos < nv_real) {
          val = sv[pos * L + l];
        } else {
          // k slots of t[0] * 0: in order that zero, past 32 windows of
          // padding, which sum to +0
          float acc = W ? 0.0f : tz[l];
          if (p.k > 1 && !W) acc = __fadd_rn(acc, tz[l]);
          const float den = __fsub_rn(__fmul_rn(m, __ldg(ec + i)), a);
          const float iv = __fdiv_rn(-1.0f, den == 0.0f ? 1.0f : den);
          val = clamp01(__fmul_rn(
              __fadd_rn(__fadd_rn(p.q[rv0 + i], __fdiv_rn(a, 2.0f)), acc),
              iv));
        }
        p.v[rv0 + i] = val;
      }
      if constexpr (!G) {
        if (my_l == l) {
          const size_t rc0 = static_cast<size_t>(pid) * n_con;
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
            const int q = r * kQuadThreads + tq;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 4 * q + i;
              if (q >= nq || c >= n_con) continue;
              p.z[rc0 + c] = zr[r][i];
              p.yl[rc0 + c] = yr[r][i];
            }
          }
        }
      }
      if (tid == 0) {
        p.it[pid] = cnt[l];
        if ((stop >> l) & 1) p.done[pid] = 1;
        if (p.sum2_out != nullptr) p.sum2_out[pid] = s2[l];
      }
    }
    active &= ~fin;
    need = fin;
  }
}

typedef void (*KernelFn)(const Params);

template <bool W>
KernelFn tier_kernel(int tier) {
  switch (tier) {
    case 0: return admm_iterate_kernel<256, 2, 3, 5, 2, false, W>;
    case 1: return admm_iterate_kernel<512, 2, 3, 5, 1, false, W>;
    case 2: return admm_iterate_kernel<512, 1, 8, 5, 1, false, W>;
    default: return admm_iterate_kernel<512, 1, 0, 16, 1, true, W>;
  }
}

// the kernel of a tier at k slots a variable: with XLA's windows past 32
KernelFn pick_kernel(int tier, int k) {
  return k > kWindow ? tier_kernel<true>(tier) : tier_kernel<false>(tier);
}

}  // namespace

extern "C" {

// The launch layout of pairs of n_var variables, n_con constraints and k
// slots a variable: out[0] threads per block, out[1] shared bytes per
// block, out[2] lanes per block, out[3] the tier, out[4] the CSR entries a
// candidate. Returns 0, or cudaErrorInvalidValue when no tier fits.
int ldpc_admm_iterate_plan(int n_var, int n_con, int k, int* out) {
  const int tier = pick_tier(n_var, n_con, k);
  if (tier < 0) return cudaErrorInvalidValue;
  out[0] = kTiers[tier].threads;
  out[1] = static_cast<int>(smem_bytes(kTiers[tier], n_var, n_con, k));
  out[2] = kTiers[tier].lanes;
  out[3] = tier;
  out[4] = static_cast<int>(csr_capacity(n_var, n_con, k));
  return cudaSuccess;
}

// What the current device makes of that plan: out[0] blocks per SM, out[1]
// SMs, out[2] registers a thread, out[3] local (spilled) bytes a thread.
int ldpc_admm_iterate_occupancy(int n_var, int n_con, int k, int* out) {
  int plan[5];
  if (ldpc_admm_iterate_plan(n_var, n_con, k, plan) != cudaSuccess)
    return cudaErrorInvalidValue;
  const KernelFn fn = pick_kernel(plan[3], k);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, plan[0],
                                                      plan[1]);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// Up to `iters` iterations of every pair of `batch` lanes x `p_count`
// candidates that is not done, in place on v, z, yl, done (bytes) and it
// (int32), on `stream`. q, v (batch, p_count * n_var), z, yl (batch,
// p_count * n_con) float32; the compact tables of `pack_tables`: var_csr
// (p_count, csr_cap) 32-bit items, con_code (p_count, 4 * nq, 4) 16-bit
// codes (nq = ceil(n_con / 4)), var_info (p_count, n_var) int64, var_pos
// (p_count, n_var) int32, real (p_count, 2) int32; b
// (p_count, n_con), e (p_count, n_var) float32; alpha, mu (batch,) float32;
// sum2_out (batch, p_count) float32 or null; queue (p_count,) int32 zeros.
// `threads`, `smem` and `lanes` are the caller's plan: another plan than
// this source's returns cudaErrorInvalidValue and launches nothing.
// Otherwise returns the cudaError_t of the launch. Does not synchronise.
int ldpc_admm_iterate(const void* q, void* v, void* z, void* yl, void* done,
                      void* it, const void* var_csr, const void* var_info,
                      const void* var_pos, const void* con_code,
                      const void* real, const void* b, const void* e,
                      const void* alpha, const void* mu, void* sum2_out,
                      void* queue, int batch, int p_count, int n_var,
                      int n_con, int k, float eps_stop, int max_iter,
                      int iters, int threads, int smem, int lanes,
                      void* stream) {
  int plan[5];
  if (ldpc_admm_iterate_plan(n_var, n_con, k, plan) != cudaSuccess ||
      plan[0] != threads || plan[1] != smem || plan[2] != lanes ||
      p_count < 1 || batch < 0)
    return cudaErrorInvalidValue;
  const long long pairs = static_cast<long long>(batch) * p_count;
  if (pairs == 0 || iters <= 0) return cudaSuccess;
  if (pairs > 0x7fffffffLL) return cudaErrorInvalidValue;
  // blocks per SM and SMs of this plan's kernel on the current device,
  // asked once
  static int seen[2 * kTierCount][3];      // device + 1, smem, blocks
  static int sms[2 * kTierCount];
  const int which = 2 * plan[3] + (k > kWindow);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* memo = seen[which];
  if (memo[0] != dev + 1 || memo[1] != smem) {
    int occ[4];
    const int code = ldpc_admm_iterate_occupancy(n_var, n_con, k, occ);
    if (code != cudaSuccess) return code;
    memo[0] = dev + 1;
    memo[1] = smem;
    memo[2] = occ[0];
    sms[which] = occ[1];
  }
  const int occ[2] = {memo[2], sms[which]};
  // one wave of blocks on the card, at least one per candidate, and no
  // more than the pairs can keep busy
  const long long want =
      static_cast<long long>(p_count) * ((batch + lanes - 1) / lanes);
  long long grid = static_cast<long long>(occ[0] > 0 ? occ[0] : 1) * occ[1];
  if (grid < p_count) grid = p_count;
  if (grid > want) grid = want;
  Params prm;
  prm.q = static_cast<const float*>(q);
  prm.v = static_cast<float*>(v);
  prm.z = static_cast<float*>(z);
  prm.yl = static_cast<float*>(yl);
  prm.done = static_cast<uint8_t*>(done);
  prm.it = static_cast<int*>(it);
  prm.var_csr = static_cast<const unsigned*>(var_csr);
  prm.var_info = static_cast<const long long*>(var_info);
  prm.var_pos = static_cast<const int*>(var_pos);
  prm.con_code = static_cast<const uint16_t*>(con_code);
  prm.real = static_cast<const int*>(real);
  prm.b = static_cast<const float*>(b);
  prm.e = static_cast<const float*>(e);
  prm.alpha = static_cast<const float*>(alpha);
  prm.mu = static_cast<const float*>(mu);
  prm.sum2_out = static_cast<float*>(sum2_out);
  prm.queue = static_cast<int*>(queue);
  prm.batch = batch;
  prm.p_count = p_count;
  prm.n_var = n_var;
  prm.n_con = n_con;
  prm.k = k;
  prm.csr_cap = plan[4];
  prm.eps_stop = eps_stop;
  prm.max_iter = max_iter;
  prm.iters = iters;
  pick_kernel(plan[3], k)<<<static_cast<unsigned>(grid), threads,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(prm);
  return cudaGetLastError();
}

}  // extern "C"
