// One PDHG chunk per LP lane, the lane's cut slice held in shared memory, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in ldpc_tpu/ops/pallas/pdhg_kernel.py
// (called by `pdhg_chunk_pallas`): `iters` preconditioned PDHG steps of
//
//     x <- clip_[0,1](x - tau * (c + A^T y))
//     y <- max(0, y + sigma * (A (2x' - x) - b))
//
// on every lane's own cut matrix A (T x n, rows +-1/0), then the lane's
// combined error max(max(A x - b, 0), relative duality gap) and, with
// `average`, the chunk's ergodic mean kept when its error is smaller. The
// plain PyTorch version is ldpc_tpu_torch/ops/pdhg_ref.py (`pdhg_chunk_ref`).
//
// What bounds it. The function needs A once (4 T n bytes per lane) and does
// 4 T n flops per lane-step, but a step needs all of A twice, 128 times per
// 64-step chunk. Read from device memory each time (the first version of
// this kernel), the chunk is bound by that traffic: the batch's slices are
// 73 MB at T = 256, more than the 50 MB L2. Cut rows are +-1/0, so a slice is
// exact in one byte per entry, T x 288 bytes at n = 280: 72 KB at T = 256,
// 180 KB at 640, inside a block's 227 KB of shared memory. Held there, the
// chunk reads device memory once and is bound by the SM's instruction rate:
// about 3.4 instructions per entry and matvec.
//
// Design:
//   - a block converts its rows of the lane's float32 slice (any lane
//     stride, rows contiguous) to int8 in shared memory, row pitch n_pad = n
//     rounded up to 16, pad columns zero, and checks on the way that every
//     entry is -1, 0 or 1; a lane with another entry gets flag 1 and a wrong
//     answer, and the caller raises on the flag;
//   - threads are (s, g): segment s of S = n_pad / 16 and row group g of G.
//     A thread reads the 16 bytes of segment s of rows g, g + G, ...: the
//     block reads each row contiguously, so shared memory has no conflicts.
//     int8 -> float as in gemv.cu: one XOR per word flips the sign bits, one
//     PRMT places a byte under the exponent of 2^23, one FADD removes
//     2^23 + 128 exactly, then the FFMA;
//   - A^T y: 16 column sums per thread in registers over its rows; the G
//     groups' sums go through shared memory and one thread per column adds
//     them in group order and applies the x update;
//   - A (2x' - x): the thread's segment of the vector in 16 registers, one
//     16-entry partial per row and segment through shared memory; one thread
//     per row adds the S partials in segment order and applies the y update.
//     Four block barriers per step;
//   - occupancy, chosen per shape in plan_for(): two lanes share an SM when
//     two blocks' slices fit (T <= 256 at n = 280, at most 512 threads each,
//     so the batch's 256 lanes are one wave on 132 SMs), else one block of
//     up to 32 row groups per SM;
//   - a slice that does not fit one block (T = 896 at n = 280: 252 KB; at
//     n = 640 every T >= 640) is split over a cluster of 2, 4 or 8 blocks
//     (8 is the portable limit), each holding its share of the rows and
//     the duals of its rows, every block holding x. Each step the partial
//     A^T y of all ranks are added through distributed shared memory in
//     rank order, so every block computes the same x bit for bit; one
//     cluster barrier per step, the partials double-buffered. The error's
//     row terms are combined the same way, in rank order. The slice is
//     still read from device memory once. At n = 640 a cluster of 8 holds
//     T = 2176 in 272 rows per block. A shape that fits no cluster of 8 is
//     refused by the wrapper;
//   - an inactive lane (per lane, not per group) copies x and y through and
//     writes error 0 and flag 0 without reading A.
//
// The TPU kernel grouped G lanes per program (`pick_group_size`) because one
// lane's rank-1 matmul left the MXU idle, and padded n and T to 128 for its
// tiles; neither applies here: any n and any T >= 1 that fits.
//
// float32 throughout with FMA contraction and IEEE division; no fast math, no
// TF32, no bf16. The TPU stored A in bf16, which was exact there only because
// its MXU rounded the vector operand to bf16 anyway; here the reference is
// f32. The sums run in a fixed order, another than the plain version's
// torch.bmm: repeat calls are bit-identical, and the two agree to float32
// rounding, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;   // per block, and per SM (64 registers)
constexpr int kSeg = 16;            // bytes of a row per thread and load
constexpr int kMaxGroups = 32;      // row groups per block at most
constexpr int kMinGroups = 4;       // fewer is refused
constexpr int kMinGroupsShared = 16;  // fewer, and an SM takes one block
constexpr int kScratch = 32;        // one float per warp for block reductions
constexpr int kXch = 8;             // cluster exchange slots (two errors)
constexpr int kMaxCluster = 8;      // blocks per lane at most (portable)
constexpr int kDefaultSmemLimit = 48 * 1024;
constexpr int kBlockReserve = 1024;  // shared memory the system keeps per block
constexpr float kMagic = 8388736.0f;  // 2^23 + 128, see gemv.cu

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (kMax false) or max (kMax true) of one value per thread,
// returned to every thread. blockDim.x is a multiple of 32.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // every thread has read the previous result
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : 0.f;
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

// Entry i (0..3) of a word of four int8 whose sign bits were flipped.
__device__ __forceinline__ float entry(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + i)) -
         kMagic;
}

// What a block holds of its lane. Vectors over columns are n_pad long, pad
// zero; vectors over rows cover the block's own `rows` rows.
struct Lane {
  const int8_t* a;   // [rows][n_pad]
  float* red;        // [groups * n_pad], the matvecs' partials
  float* part;       // [2][n_pad], this block's A^T y (clusters only)
  const float *c, *b;
  float* scratch;    // [kScratch]
  float* xch;        // [kXch], this block's row terms (clusters only)
  int n, n_pad, segs, groups, rows, cap;  // cap: rows per pass of A x
  int s, g;          // this thread's segment and row group; g >= groups: idle
};

// f(j, (A^T y)_j) for every column j < n, one thread per column, over the
// rows of the whole lane. Ends with a block barrier.
template <bool kCluster, class F>
__device__ __forceinline__ void at_y(const Lane& k, const float* yv, int* par,
                                     F&& f) {
  if (k.g < k.groups) {
    float acc[kSeg];
#pragma unroll
    for (int q = 0; q < kSeg; ++q) acc[q] = 0.f;
#pragma unroll 2
    for (int r = k.g; r < k.rows; r += k.groups) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          k.a + static_cast<size_t>(r) * k.n_pad + k.s * kSeg);
      const uint32_t wd[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                              w.z ^ 0x80808080u, w.w ^ 0x80808080u};
      const float yr = yv[r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * q + i] = fmaf(entry(wd[q], i), yr, acc[4 * q + i]);
    }
    // group g's sums as float4 (q, s) at q * S + s: a warp's stores are
    // contiguous
    float4* dst = reinterpret_cast<float4*>(k.red + k.g * k.n_pad);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q * k.segs + k.s] = make_float4(acc[4 * q], acc[4 * q + 1],
                                          acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  const int used = min(k.groups, max(k.rows, 1));  // the others hold zeros
  if (kCluster) {
    float* mine = k.part + *par * k.n_pad;
    for (int j = threadIdx.x; j < k.n; j += blockDim.x) {
      const int at = (((j >> 2) & 3) * k.segs + (j >> 4)) * 4 + (j & 3);
      float sum = k.red[at];
      for (int q = 1; q < used; ++q) sum += k.red[q * k.n_pad + at];
      mine[j] = sum;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int ranks = static_cast<int>(cluster.num_blocks());
    for (int j = threadIdx.x; j < k.n; j += blockDim.x) {
      float sum = cluster.map_shared_rank(mine, 0)[j];
      for (int q = 1; q < ranks; ++q)
        sum += cluster.map_shared_rank(mine, q)[j];
      f(j, sum);
    }
    *par ^= 1;
  } else {
    for (int j = threadIdx.x; j < k.n; j += blockDim.x) {
      const int at = (((j >> 2) & 3) * k.segs + (j >> 4)) * 4 + (j & 3);
      float sum = k.red[at];
      for (int q = 1; q < used; ++q) sum += k.red[q * k.n_pad + at];
      f(j, sum);
    }
  }
  __syncthreads();
}

// f(r, (A x)_r) for every row r of the block, one thread per row. xv is
// n_pad long. Ends with a block barrier.
template <class F>
__device__ __forceinline__ void a_x(const Lane& k, const float* xv, F&& f) {
  float xr[kSeg];
  if (k.g < k.groups) {
    const float4* src = reinterpret_cast<const float4*>(xv + k.s * kSeg);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = src[q];
      xr[4 * q] = v.x;
      xr[4 * q + 1] = v.y;
      xr[4 * q + 2] = v.z;
      xr[4 * q + 3] = v.w;
    }
  }
  const int pitch = k.segs + 1;
  for (int r0 = 0; r0 < k.rows; r0 += k.cap) {
    const int r1 = min(k.rows, r0 + k.cap);
    if (k.g < k.groups) {
#pragma unroll 2
      for (int r = r0 + k.g; r < r1; r += k.groups) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            k.a + static_cast<size_t>(r) * k.n_pad + k.s * kSeg);
        const uint32_t wd[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                w.z ^ 0x80808080u, w.w ^ 0x80808080u};
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p0 = fmaf(entry(wd[q], 0), xr[4 * q], p0);
          p1 = fmaf(entry(wd[q], 1), xr[4 * q + 1], p1);
          p0 = fmaf(entry(wd[q], 2), xr[4 * q + 2], p0);
          p1 = fmaf(entry(wd[q], 3), xr[4 * q + 3], p1);
        }
        k.red[(r - r0) * pitch + k.s] = p0 + p1;
      }
    }
    __syncthreads();
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const float* pr = k.red + (r - r0) * pitch;
      float sum = pr[0];
      for (int q = 1; q < k.segs; ++q) sum += pr[q];
      f(r, sum);
    }
    __syncthreads();
  }
}

// max(max(A x - b, 0), (pobj - dobj) / (1 + |pobj| + |dobj|)) of one lane,
// with pobj = c.x and dobj = -b.y + sum(min(c + A^T y, 0)). In a cluster
// the row terms (violation, b.y and the block's `bad` flag) are exchanged
// through slots `xch[0..3)` and combined in rank order; *bad becomes the
// lane's flag.
template <bool kCluster>
__device__ float lane_err(const Lane& k, const float* xv, const float* yv,
                          int* par, float* xch, float* bad) {
  float cx = 0.f, rc_neg = 0.f;
  at_y<kCluster>(k, yv, par, [&](int j, float aty) {
    cx = fmaf(k.c[j], xv[j], cx);
    rc_neg += fminf(k.c[j] + aty, 0.f);
  });
  float viol = 0.f, by = 0.f;
  a_x(k, xv, [&](int r, float ax) {
    viol = fmaxf(viol, ax - k.b[r]);
    by = fmaf(k.b[r], yv[r], by);
  });
  viol = block_reduce<true>(viol, k.scratch);
  by = block_reduce<false>(by, k.scratch);
  const float pobj = block_reduce<false>(cx, k.scratch);
  rc_neg = block_reduce<false>(rc_neg, k.scratch);
  if (kCluster) {
    if (threadIdx.x == 0) {
      xch[0] = viol;
      xch[1] = by;
      xch[2] = *bad;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int ranks = static_cast<int>(cluster.num_blocks());
    const float* x0 = cluster.map_shared_rank(xch, 0);
    viol = x0[0];
    by = x0[1];
    *bad = x0[2];
    for (int q = 1; q < ranks; ++q) {
      const float* xq = cluster.map_shared_rank(xch, q);
      viol = fmaxf(viol, xq[0]);
      by += xq[1];
      *bad = fmaxf(*bad, xq[2]);
    }
  }
  const float dobj = -by + rc_neg;
  const float gap = (pobj - dobj) / (1.f + fabsf(pobj) + fabsf(dobj));
  return fmaxf(viol, gap);
}

__device__ __forceinline__ bool in_set(float v) {
  return v == 0.f || v == 1.f || v == -1.f;
}

// The int8 byte of an entry in {-1, 0, 1}.
__device__ __forceinline__ uint32_t byte_of(float v) {
  return static_cast<uint32_t>(__float2int_rn(v)) & 255u;
}

// c, tau, x_in, x_out (B, n); a (B, T, n) float32 with lane stride
// `lane_stride` elements and rows contiguous; b, sigma, y_in, y_out (B, T);
// active (B,) bytes or null; err (B,); flag (B,) int32. A lane is blockIdx.x
// / cluster size; block `rank` (blockIdx.x % cluster size) of a cluster
// holds rows [rank * tb, min(t, (rank + 1) * tb)), possibly none.
template <bool kAverage, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1)
pdhg_chunk_kernel(const float* __restrict__ c, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ tau,
                  const float* __restrict__ sigma,
                  const float* __restrict__ x_in,
                  const float* __restrict__ y_in,
                  const uint8_t* __restrict__ active,
                  float* __restrict__ x_out, float* __restrict__ y_out,
                  float* __restrict__ err_out, int* __restrict__ flag_out,
                  int n, int t, int tb, int groups, long long lane_stride,
                  int iters) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ranks =
      kCluster ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  const int rank = static_cast<int>(blockIdx.x % ranks);
  const size_t l = blockIdx.x / ranks;
  const int r_lo = rank * tb;
  const int rows = max(0, min(t, r_lo + tb) - r_lo);
  const size_t vn = l * n, vt = l * t + r_lo;
  // all blocks of a cluster leave here together, before any cluster barrier
  if (active != nullptr && active[l] == 0) {
    if (rank == 0)
      for (int j = tid; j < n; j += nt) x_out[vn + j] = x_in[vn + j];
    for (int r = tid; r < rows; r += nt) y_out[vt + r] = y_in[vt + r];
    if (tid == 0 && rank == 0) {
      err_out[l] = 0.f;
      flag_out[l] = 0;
    }
    return;
  }

  const int n_pad = (n + kSeg - 1) / kSeg * kSeg;
  const int tb4 = (tb + 3) / 4 * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + static_cast<size_t>(tb) * n_pad);
  float* part = red + groups * n_pad;
  float* sx = part + (kCluster ? 2 * n_pad : 0);  // x [n_pad]
  float* sxbar = sx + n_pad;                      // 2x' - x [n_pad]
  float* sc = sxbar + n_pad;                      // c [n_pad]
  float* stau = sc + n_pad;                       // tau [n_pad]
  float* ssum_x = stau + n_pad;                   // sum of x [n_pad] (kAverage)
  float* sy = ssum_x + (kAverage ? n_pad : 0);    // y [tb4]
  float* sb = sy + tb4;                           // b [tb4]
  float* ssig = sb + tb4;                         // sigma [tb4]
  float* ssum_y = ssig + tb4;                     // sum of y [tb4] (kAverage)
  float* scratch = ssum_y + (kAverage ? tb4 : 0);  // [kScratch]
  float* xch = scratch + kScratch;                // [kXch]

  // the block's rows as int8, each entry checked
  const float* al = a + l * static_cast<size_t>(lane_stride) +
                    static_cast<size_t>(r_lo) * n;
  float bad = 0.f;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(al) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* al4 = reinterpret_cast<const float4*>(al);
    for (int e = tid; e < rows * n4; e += nt) {
      const float4 v = __ldg(al4 + e);
      const int r = e / n4, j = (e - r * n4) * 4;
      const bool ok = in_set(v.x) && in_set(v.y) && in_set(v.z) && in_set(v.w);
      if (!ok) bad = 1.f;
      const uint32_t w = byte_of(v.x) | byte_of(v.y) << 8 |
                         byte_of(v.z) << 16 | byte_of(v.w) << 24;
      *reinterpret_cast<uint32_t*>(sa + static_cast<size_t>(r) * n_pad + j) =
          ok ? w : 0u;
    }
  } else {
    for (int e = tid; e < rows * n; e += nt) {
      const float v = __ldg(al + e);
      const int r = e / n, j = e - r * n;
      if (!in_set(v)) bad = 1.f;
      sa[static_cast<size_t>(r) * n_pad + j] =
          in_set(v) ? static_cast<int8_t>(byte_of(v)) : 0;
    }
  }
  for (int e = tid; e < rows * (n_pad - n); e += nt) {
    const int r = e / (n_pad - n), j = n + e % (n_pad - n);
    sa[static_cast<size_t>(r) * n_pad + j] = 0;
  }
  for (int j = tid; j < n_pad; j += nt) {
    const bool in = j < n;
    sx[j] = in ? x_in[vn + j] : 0.f;
    sxbar[j] = 0.f;
    sc[j] = in ? c[vn + j] : 0.f;
    stau[j] = in ? tau[vn + j] : 0.f;
    if (kAverage) ssum_x[j] = 0.f;
  }
  for (int r = tid; r < rows; r += nt) {
    sy[r] = y_in[vt + r];
    sb[r] = b[vt + r];
    ssig[r] = sigma[vt + r];
    if (kAverage) ssum_y[r] = 0.f;
  }
  bad = block_reduce<true>(bad, scratch);  // and the barrier after the loads

  Lane k;
  k.a = sa;
  k.red = red;
  k.part = part;
  k.c = sc;
  k.b = sb;
  k.scratch = scratch;
  k.xch = xch;
  k.n = n;
  k.n_pad = n_pad;
  k.segs = n_pad / kSeg;
  k.groups = groups;
  k.rows = rows;
  k.cap = groups * n_pad / (k.segs + 1);
  k.s = tid % k.segs;
  k.g = tid / k.segs;  // >= groups: the block's spare threads
  int par = 0;

  for (int it = 0; it < iters; ++it) {
    // x <- clip(x - tau (c + A^T y))
    at_y<kCluster>(k, sy, &par, [&](int j, float aty) {
      const float xo = sx[j];
      const float xn = fminf(fmaxf(xo - stau[j] * (sc[j] + aty), 0.f), 1.f);
      sx[j] = xn;
      sxbar[j] = 2.f * xn - xo;
      if (kAverage) ssum_x[j] += xn;
    });
    // y <- max(0, y + sigma (A (2x' - x) - b))
    a_x(k, sxbar, [&](int r, float ax) {
      const float yn = fmaxf(0.f, sy[r] + ssig[r] * (ax - sb[r]));
      sy[r] = yn;
      if (kAverage) ssum_y[r] += yn;
    });
  }

  const float e_last = lane_err<kCluster>(k, sx, sy, &par, xch, &bad);
  bool take_avg = false;
  float e = e_last;
  if (kAverage) {
    const float inv = 1.f / static_cast<float>(iters);
    for (int j = tid; j < n; j += nt) ssum_x[j] *= inv;
    for (int r = tid; r < rows; r += nt) ssum_y[r] *= inv;
    __syncthreads();
    float unused = 0.f;
    const float e_avg =
        lane_err<kCluster>(k, ssum_x, ssum_y, &par, xch + 4, &unused);
    take_avg = e_avg < e_last;
    e = fminf(e_avg, e_last);
  }
  const float* xs = take_avg ? ssum_x : sx;
  const float* ys = take_avg ? ssum_y : sy;
  if (rank == 0)
    for (int j = tid; j < n; j += nt) x_out[vn + j] = xs[j];
  for (int r = tid; r < rows; r += nt) y_out[vt + r] = ys[r];
  if (tid == 0 && rank == 0) {
    err_out[l] = e;
    flag_out[l] = bad != 0.f ? 1 : 0;
  }
  // a block's shared memory must outlive the other blocks' reads of it
  if (kCluster) cg::this_cluster().sync();
}

// How a shape is laid out: blocks per lane (1, or a cluster of 2, 4 or 8),
// rows per block, row groups and threads per block, dynamic shared memory
// per block.
struct Plan {
  int cluster, rows, groups, threads;
  long long smem;
};

// Shared memory of one block but for the matvecs' partials.
long long fixed_bytes(int n_pad, int rows, int cluster, int average) {
  const long long rows4 = (rows + 3) / 4 * 4;
  const long long floats = (4 + (average ? 1 : 0)) * static_cast<long long>(n_pad) +
                           (3 + (average ? 1 : 0)) * rows4 +
                           (cluster > 1 ? 2LL * n_pad : 0LL) + kScratch + kXch;
  return static_cast<long long>(rows) * n_pad +
         floats * static_cast<long long>(sizeof(float));
}

Plan make_plan(int n_pad, int rows, int cluster, int groups, int average) {
  Plan p;
  p.cluster = cluster;
  p.rows = rows;
  p.groups = groups;
  p.threads = (n_pad / kSeg * groups + 31) / 32 * 32;
  p.smem = fixed_bytes(n_pad, rows, cluster, average) +
           4LL * groups * n_pad;
  return p;
}

// The layout for a shape on a card whose blocks may opt in to `limit` bytes
// and whose SMs hold `per_sm`. The rule, first that fits: one block per lane
// and two blocks per SM (each at most half the SM's threads and memory) when
// that leaves at least kMinGroupsShared row groups; one block per lane and
// SM; a cluster of 2, then 4, then 8 blocks per lane, the rows split evenly.
// False when nothing fits; *plan is then the smallest layout (a cluster of
// kMaxCluster), for the caller's message.
bool plan_for(int n, int t, int average, long long limit, long long per_sm,
              Plan* plan) {
  const int n_pad = (n + kSeg - 1) / kSeg * kSeg;
  const int segs = n_pad / kSeg;
  for (int cluster = 1; cluster <= kMaxCluster; cluster *= 2) {
    const int rows = (t + cluster - 1) / cluster;
    const long long fixed = fixed_bytes(n_pad, rows, cluster, average);
    for (int per = cluster == 1 ? 2 : 1; per >= 1; --per) {
      long long budget = per_sm / per - kBlockReserve;
      if (budget > limit) budget = limit;
      long long groups = (budget - fixed) / (4LL * n_pad);
      const int by_threads = kMaxThreads / per / segs;
      if (groups > by_threads) groups = by_threads;
      if (groups > kMaxGroups) groups = kMaxGroups;
      if (groups >= (per > 1 ? kMinGroupsShared : kMinGroups)) {
        *plan = make_plan(n_pad, rows, cluster, static_cast<int>(groups),
                          average);
        return true;
      }
    }
  }
  *plan = make_plan(n_pad, (t + kMaxCluster - 1) / kMaxCluster, kMaxCluster,
                    kMinGroups, average);
  return false;
}

// The card's shared-memory sizes, read once per device.
cudaError_t card_limits(long long* limit, long long* per_sm) {
  static int cached_device = -1;
  static int cached_limit = 0, cached_per_sm = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device != cached_device) {
    e = cudaDeviceGetAttribute(&cached_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&cached_per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               device);
    if (e != cudaSuccess) return e;
    cached_device = device;
  }
  *limit = cached_limit;
  *per_sm = cached_per_sm;
  return cudaSuccess;
}

template <bool kAverage, bool kCluster>
cudaError_t launch(const Plan& p, cudaStream_t stream, const float* c,
                   const float* a, const float* b, const float* tau,
                   const float* sigma, const float* x, const float* y,
                   const uint8_t* active, float* x_out, float* y_out,
                   float* err, int* flag, int batch, int n, int t,
                   long long lane_stride, int iters) {
  auto kernel = pdhg_chunk_kernel<kAverage, kCluster>;
  if (p.smem > kDefaultSmemLimit) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * p.cluster);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, c, a, b, tau, sigma, x, y, active,
                            x_out, y_out, err, flag, n, t, p.rows, p.groups,
                            lane_stride, iters);
}

}  // namespace

extern "C" {

// The layout plan_for() picks for a shape on the current device, as
// out[0..5) = {fits (0 or 1), blocks per lane, row groups, threads per block,
// shared-memory bytes per block}; when nothing fits, the smallest layout's.
// Returns a cudaError_t.
int ldpc_pdhg_chunk_plan(int n, int t, int average, long long* out) {
  long long limit = 0, per_sm = 0;
  cudaError_t e = card_limits(&limit, &per_sm);
  if (e != cudaSuccess) return e;
  Plan p;
  out[0] = plan_for(n, t, average, limit, per_sm, &p) ? 1 : 0;
  out[1] = p.cluster;
  out[2] = p.groups;
  out[3] = p.threads;
  out[4] = p.smem;
  return cudaSuccess;
}

// The largest dynamic shared memory a block may opt in to on `device`, or
// -1 when the attribute cannot be read.
int ldpc_smem_optin_limit(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Launches one chunk for `batch` lanes on `stream`; returns the cudaError_t
// of the launch (0 on success, cudaErrorInvalidValue for a shape that does
// not fit). Does not synchronise. `active` may be null; `flag` (batch,)
// int32 reads 1 for a lane whose slice has an entry outside {-1, 0, 1}.
int ldpc_pdhg_chunk(const void* c, const void* a, const void* b,
                    const void* tau, const void* sigma, const void* x,
                    const void* y, const void* active, void* x_out,
                    void* y_out, void* err, void* flag, int batch, int n,
                    int t, long long lane_stride, int iters, int average,
                    void* stream) {
  if (batch <= 0) return cudaSuccess;
  long long limit = 0, per_sm = 0;
  cudaError_t e = card_limits(&limit, &per_sm);
  if (e != cudaSuccess) return e;
  Plan p;
  if (!plan_for(n, t, average, limit, per_sm, &p))
    return cudaErrorInvalidValue;
  auto go = average ? (p.cluster > 1 ? launch<true, true> : launch<true, false>)
                    : (p.cluster > 1 ? launch<false, true>
                                     : launch<false, false>);
  e = go(p, static_cast<cudaStream_t>(stream), static_cast<const float*>(c),
         static_cast<const float*>(a), static_cast<const float*>(b),
         static_cast<const float*>(tau), static_cast<const float*>(sigma),
         static_cast<const float*>(x), static_cast<const float*>(y),
         static_cast<const uint8_t*>(active), static_cast<float*>(x_out),
         static_cast<float*>(y_out), static_cast<float*>(err),
         static_cast<int*>(flag), batch, n, t, lane_stride, iters);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // extern "C"
