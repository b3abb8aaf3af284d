// QP-ADMM's iteration for NVIDIA Hopper (sm_90a): each (lane, candidate)
// pair iterates in one block's shared memory until it stops or the launch's
// `iters` is reached.
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
// Design: one block of kThreads threads per pair (grid = batch * P). The
// block loads the pair's q and v (n_var each), z and yl (n_con each) into
// shared memory, computes inv_coef = -1 / (mu e - alpha) per variable and
// the per-constraint t = yl + mu (z - b), and then iterates there:
//   variable pass   v_i = clamp((q_i + alpha/2 + sum_s +-t[c_is]) inv_i),
//   __syncthreads,
//   constraint pass r_c = b_c - ((p0 + p1) + p2), p_s = +-v[i_cs];
//                   z_c = max(r_c - yl_c, 0), yl_c = max(yl_c - r_c, 0),
//                   the next t_c, and this thread's part of sum2,
//   a block sum of sum2 (warp shuffles, then each thread adds the warps'
//   parts in one order: every thread reaches the same value),
// and stops when sum2 < eps_stop or its count reaches max_iter. A done pair
// is frozen: its block returns at once. The state goes back to device
// memory once, at the end. Thread j owns variables and constraints j,
// j + kThreads, ...: z and yl are touched only by their owner.
//
// The tables are a packed copy (ops/admm_kernel.py `pack_tables`): each
// slot an int16 code, +(index + 1) for coefficient +1, -(index + 1) for -1,
// 0 for a padding slot, slot-major so that a warp reads one slot of 32
// neighbouring rows at once; each variable's slot count up to its last
// real slot. Codes of any other entry (a coefficient outside {-1, 0, 1}, a
// zero coefficient on a real index, an index out of range) are kBad, and a
// block that finds one in its candidate's tables traps: the launch fails.
// They are read through the read-only path (optimalH: ~48 KB per
// candidate, shared by all its lanes).
//
// Bit for bit with the twin in v, z, yl:
//  * every product and sum rounds on its own (__fmul_rn, __fadd_rn,
//    __fsub_rn, __fdiv_rn): nvcc would contract a * b + c into an FMA;
//  * torch's association: t = yl + mu (z - b); bq = (q + alpha/2) + acc with
//    acc = p_0, then acc + p_1, ... in slot order; r = b - ((p0 + p1) + p2);
//    a coefficient of +-1 multiplies exactly, so p = +-t[c] is the product;
//  * a padding slot reads the pair's entry 0 times 0, as the twin gathers
//    it: on the variable side once per padding slot up to the last real one
//    and once for the trailing ones (adding the same zero again changes
//    nothing), on the constraint side in its slot;
//  * the clamps keep NaN, as torch's clamp and clamp_min do;
//  * eps_stop arrives as float32, as torch compares it.
// sum2 is summed in this kernel's own fixed order (each thread's
// constraints in order, then the warp tree, then the warps in order), so a
// pair's stop can differ from the twin's only where sum2 lies within
// rounding of eps_stop; it is the same for a pair whatever the batch, the
// candidate count or the launch.
//
// What bounds it: one iteration of one optimalH lane is ~40,600 float32
// operations on data in shared memory (the bytes of a chunk, the state read
// and written once, are ~45 KB a lane over all its iterations), so the
// bound is operations; in practice shared-memory gathers (9,280 a
// lane-iteration on optimalH) and the two barriers per iteration. Shared
// memory per block: 4 (3 n_var + 3 n_con + kWarps) bytes (optimalH 36 KB,
// H02 69 KB, the optimizer's caps 77 KB).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;     // the H100's opt-in limit per block
constexpr int kDefaultSmem = 48 * 1024;
constexpr int16_t kBad = -32768;

// shared bytes of one pair: v, q, inv_coef (n_var each), t, z, yl (n_con
// each) and the warps' parts of sum2
long long smem_bytes(int n_var, int n_con) {
  return 4LL * (3LL * n_var + 3LL * n_con + kWarps);
}

// torch.clamp(x, 0, 1) and clamp_min(x, 0): NaN passes
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : (x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x));
}
__device__ __forceinline__ float clamp_min0(float x) {
  return isnan(x) ? x : (x < 0.0f ? 0.0f : x);
}

// the product of a slot: +-arr[index] for a real slot, arr[0] * 0 for a
// padding slot (`zero`)
__device__ __forceinline__ float slot(int code, const float* arr,
                                      float zero) {
  if (code > 0) return arr[code - 1];
  if (code < 0) return -arr[-code - 1];
  return zero;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    admm_iterate_kernel(const float* __restrict__ q, float* __restrict__ v,
                        float* __restrict__ z, float* __restrict__ yl,
                        uint8_t* __restrict__ done, int* __restrict__ it,
                        const int16_t* __restrict__ var_code,
                        const int16_t* __restrict__ var_len,
                        const int16_t* __restrict__ con_code,
                        const float* __restrict__ b,
                        const float* __restrict__ e,
                        const float* __restrict__ alpha,
                        const float* __restrict__ mu,
                        float* __restrict__ sum2_out, int p_count,
                        int n_var, int n_con, int k, float eps_stop,
                        int max_iter, int iters) {
  extern __shared__ float smem[];
  const int pair = blockIdx.x;
  if (done[pair]) return;
  const int tid = threadIdx.x;
  const int lane = pair / p_count, cand = pair - lane * p_count;
  float* sv = smem;
  float* sq = sv + n_var;
  float* sinv = sq + n_var;
  float* st = sinv + n_var;
  float* sz = st + n_con;
  float* sy = sz + n_con;
  float* red = sy + n_con;
  const int16_t* vcode = var_code + static_cast<size_t>(cand) * k * n_var;
  const int16_t* vlen = var_len + static_cast<size_t>(cand) * n_var;
  const int16_t* ccode = con_code + static_cast<size_t>(cand) * 3 * n_con;
  const float* bc = b + static_cast<size_t>(cand) * n_con;
  const float* ec = e + static_cast<size_t>(cand) * n_var;
  // the pair's row: lane * P * n + cand * n == pair * n
  const size_t rv = static_cast<size_t>(pair) * n_var;
  const size_t rc = static_cast<size_t>(pair) * n_con;

  int bad = 0;
  for (int j = tid; j < k * n_var; j += kThreads)
    bad |= __ldg(vcode + j) == kBad;
  for (int j = tid; j < 3 * n_con; j += kThreads)
    bad |= __ldg(ccode + j) == kBad;
  if (__syncthreads_or(bad)) {
    if (tid == 0)
      printf("ldpc_admm_iterate: candidate %d's tables hold an entry "
             "outside the kernel's contract (coefficient outside {-1, 0, "
             "1}, or an index out of range)\n", cand);
    __trap();
  }

  const float a = alpha[lane], m = mu[lane];
  const float half_a = __fdiv_rn(a, 2.0f);
  for (int i = tid; i < n_var; i += kThreads) {
    sv[i] = v[rv + i];
    sq[i] = q[rv + i];
    const float den = __fsub_rn(__fmul_rn(m, __ldg(ec + i)), a);
    sinv[i] = __fdiv_rn(-1.0f, den == 0.0f ? 1.0f : den);
  }
  for (int c = tid; c < n_con; c += kThreads) {
    const float zc = z[rc + c], yc = yl[rc + c];
    sz[c] = zc;
    sy[c] = yc;
    st[c] = __fadd_rn(yc, __fmul_rn(m, __fsub_rn(zc, __ldg(bc + c))));
  }
  __syncthreads();

  int count = it[pair];
  bool stop = false;
  float sum2 = 0.0f;
  int ran = 0;
  for (int step = 0; step < iters; ++step) {
    const float t_zero = __fmul_rn(st[0], 0.0f);
    for (int i = tid; i < n_var; i += kThreads) {
      const int len = __ldg(vlen + i);
      float acc = slot(__ldg(vcode + i), st, t_zero);
      for (int s = 1; s < len; ++s)
        acc = __fadd_rn(acc, slot(__ldg(vcode + static_cast<size_t>(s) *
                                             n_var + i), st, t_zero));
      if (len < k) acc = __fadd_rn(acc, t_zero);
      const float bq = __fadd_rn(__fadd_rn(sq[i], half_a), acc);
      sv[i] = clamp01(__fmul_rn(bq, sinv[i]));
    }
    __syncthreads();
    const float v_zero = __fmul_rn(sv[0], 0.0f);
    float part = 0.0f;
    for (int c = tid; c < n_con; c += kThreads) {
      const float p0 = slot(__ldg(ccode + c), sv, v_zero);
      const float p1 = slot(__ldg(ccode + n_con + c), sv, v_zero);
      const float p2 = slot(__ldg(ccode + 2 * n_con + c), sv, v_zero);
      const float bcc = __ldg(bc + c);
      const float r = __fsub_rn(bcc, __fadd_rn(__fadd_rn(p0, p1), p2));
      const float yc = sy[c];
      const float zn = clamp_min0(__fsub_rn(r, yc));
      const float yn = clamp_min0(__fsub_rn(yc, r));
      const float d = __fsub_rn(zn, r);
      part = __fadd_rn(part, __fmul_rn(d, d));
      sz[c] = zn;
      sy[c] = yn;
      st[c] = __fadd_rn(yn, __fmul_rn(m, __fsub_rn(zn, bcc)));
    }
    part = warp_sum(part);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    sum2 = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum2 = __fadd_rn(sum2, red[w]);
    ++count;
    ++ran;
    if (sum2 < eps_stop || count >= max_iter) {
      stop = true;
      break;
    }
  }

  for (int i = tid; i < n_var; i += kThreads) v[rv + i] = sv[i];
  for (int c = tid; c < n_con; c += kThreads) {
    z[rc + c] = sz[c];
    yl[rc + c] = sy[c];
  }
  if (tid == 0) {
    it[pair] = count;
    if (stop) done[pair] = 1;
    if (sum2_out != nullptr && ran > 0) sum2_out[pair] = sum2;
  }
}

}  // namespace

extern "C" {

// The launch layout of a pair of n_var variables and n_con constraints:
// out[0] threads per block, out[1] shared bytes per block. Returns 0, or
// cudaErrorInvalidValue when the pair does not fit one block.
int ldpc_admm_iterate_plan(int n_var, int n_con, int* out) {
  const long long bytes = smem_bytes(n_var, n_con);
  if (n_var < 1 || n_con < 1 || n_var > 32766 || n_con > 32766 ||
      bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  out[0] = kThreads;
  out[1] = static_cast<int>(bytes);
  return cudaSuccess;
}

// Up to `iters` iterations of every pair of `batch` lanes x `p_count`
// candidates that is not done, in place on v, z, yl, done (bytes) and it
// (int32), on `stream`. q, v (batch, p_count * n_var), z, yl (batch,
// p_count * n_con) float32; the packed tables var_code (p_count, k, n_var),
// var_len (p_count, n_var), con_code (p_count, 3, n_con) int16; b
// (p_count, n_con), e (p_count, n_var) float32; alpha, mu (batch,) float32;
// sum2_out (batch, p_count) float32 or null. `threads` and `smem` are the
// caller's plan: another plan than this source's returns
// cudaErrorInvalidValue and launches nothing. Otherwise returns the
// cudaError_t of the launch. Does not synchronise.
int ldpc_admm_iterate(const void* q, void* v, void* z, void* yl, void* done,
                      void* it, const void* var_code, const void* var_len,
                      const void* con_code, const void* b, const void* e,
                      const void* alpha, const void* mu, void* sum2_out,
                      int batch, int p_count, int n_var, int n_con, int k,
                      float eps_stop, int max_iter, int iters, int threads,
                      int smem, void* stream) {
  int plan[2];
  if (ldpc_admm_iterate_plan(n_var, n_con, plan) != cudaSuccess ||
      plan[0] != threads || plan[1] != smem || k < 1 || p_count < 1)
    return cudaErrorInvalidValue;
  const long long pairs = static_cast<long long>(batch) * p_count;
  if (pairs <= 0) return cudaSuccess;
  if (pairs > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_iterate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  admm_iterate_kernel<<<static_cast<unsigned>(pairs), kThreads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<float*>(v),
      static_cast<float*>(z), static_cast<float*>(yl),
      static_cast<uint8_t*>(done), static_cast<int*>(it),
      static_cast<const int16_t*>(var_code),
      static_cast<const int16_t*>(var_len),
      static_cast<const int16_t*>(con_code), static_cast<const float*>(b),
      static_cast<const float*>(e), static_cast<const float*>(alpha),
      static_cast<const float*>(mu), static_cast<float*>(sum2_out), p_count,
      n_var, n_con, k, eps_stop, max_iter, iters);
  return cudaGetLastError();
}

}  // extern "C"
