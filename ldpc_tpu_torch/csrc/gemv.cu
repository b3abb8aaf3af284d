// Batched matvecs against each lane's packed cut slice, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_tr_kernel` in
// ldpc_tpu/ops/pallas/gemv_kernel.py (called by `batched_gemv` and
// `batched_gemv_t`): per lane, A x -> (T,) and A^T y -> (n,). The IPM
// (ldpc_tpu_torch/ops/ipm_solver.py) makes three A^T y and two A x per Newton
// step and one of each per chunk boundary, all on one slice per solve; two
// of the A^T y take the epilogue -ea - A^T y + eb - ec. The plain PyTorch
// twins are `gemv_ref` and `gemv_t_ref` in ldpc_tpu_torch/ops/gemv_ref.py.
//
// A is the packed copy `pack_rows` (ldpc_tpu_torch/ops/gemv_kernel.py) makes
// once per solve: a contiguous (B, T, n_pad) int8 tensor, n_pad = n rounded
// up to 16, pad columns zero. Cut rows are +-1/0, so one byte per entry is
// exact, and the IPM checks that it is. The TPU kernel read a transposed
// bf16 copy (`prepare_gemv`); the transposed layout suited the TPU's vector
// unit and is not copied, and int8 moves half of bf16's bytes. Every row and
// every run of rows starts 16-byte aligned, which TMA's bulk copy needs.
//
// What bounds it: each product needs all of A once, T n bytes per lane
// against 2 T n flops, so both kernels are bound by device memory: 4.6 MB at
// AGC-ALP's shallowest tier (128 lanes, T = 128, n = 280) and 50.5 MB at its
// deepest (T = 1408), 1.4 us and 15.1 us at 3.35 TB/s. The pad columns (288
// bytes read per 280-entry row) are this layout's own cost. The design:
//   - a persistent grid: as many blocks as the card holds at once
//     (occupancy queried once per width; 2 per SM at n = 280), each taking
//     a contiguous range of (lane, chunk) items, a chunk being at most
//     36 KB of rows. The grid depends on neither B nor T: no second wave,
//     no limit on B. Each call picks its chunk count (plan_for) so that the
//     blocks' shares come out even;
//   - a ring of two 36 KB stages in dynamic shared memory, each filled by
//     one 1-D TMA bulk copy (`cp.async.bulk`, completion on an mbarrier)
//     that thread 0 issues; the next chunk lands while the block computes
//     on this one, so an SM keeps up to 147 KB in flight. This version
//     landed, not plain 16-byte ld.global loads: the copies cost the
//     computing threads no registers or instructions. Two 36 KB stages
//     and 256 threads were picked on the H100 from rings of 2-4 stages of
//     9-36 KB and 128-512 threads;
//   - thread (s, g) of S * G threads (S = n_pad / 16 segments, G row groups)
//     reads the 16 bytes of segment s of rows g, g + G, ... of a stage: the
//     block reads each row contiguously, so shared memory has no conflicts;
//   - int8 -> float in three instructions per entry and no I2F (whose
//     16/clk/SM rate would set the pace at 3.35 TB/s): one XOR flips the
//     sign bits of four bytes, one PRMT places a byte under the exponent of
//     2^23, one FADD removes 2^23 + 128 exactly, then the FFMA;
//   - the items are walked with a cursor: no 64-bit division per item;
//   - forward: x's segment in 16 registers, reloaded only when an item's
//     lane changes; each thread's 16-entry partial goes to shared memory and
//     one thread per row adds the S partials in a fixed order;
//   - transposed: 16 column sums in registers over the thread's rows of
//     every chunk of a run (the chunks of one lane that a block takes in a
//     row), the next chunk's y loaded while one computes. At a run's end
//     the G row groups are added in a fixed order through shared memory. A
//     run that is a whole lane is the answer; a lane split over blocks is
//     folded in the same launch: each run goes to a (B, chunks, n) partial
//     at its first chunk, an integer count per lane says which block ends
//     last, and that block adds the lane's runs in chunk order. The runs
//     depend only on B, T and the grid, which is fixed per card and width,
//     so the order of the sums is too.
//
// float32 products and sums; no fast math, no floating-point atomics, so a
// call gives the same bits every time. The sums run in another order than
// the twin's, so the two agree to float32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;          // ring depth
constexpr int kStageBytes = 36864;  // bytes of A per chunk at most
constexpr int kThreads = 256;       // threads per block, S * G <= this
constexpr int kMaxThreads = 1024;
constexpr int kSegBytes = 16;       // bytes of a row per thread and load
// plan_for's cost of A^T y's fold of a split lane (fence, count, the last
// block's pass over the partials), in rows of a chunk
constexpr int kFoldRows = 96;
constexpr long long kWaitCycles = 20000000000LL;  // ~10 s: a lost copy traps

// 2^23 + 128: 0x4B0000uu is 2^23 + uu, and uu = e ^ 0x80 = e + 128.
constexpr float kMagic = 8388736.0f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Thread 0: expect `bytes` on `bar` and copy them from global to shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A copy
// that never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitCycles) __trap();
  }
}

// Entry i (0..3) of a word of four int8 whose sign bits were flipped.
__device__ __forceinline__ float entry(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + i)) -
         kMagic;
}

struct Ring {
  unsigned char* stage;  // kStages * stage_bytes
  uint64_t* bar;         // kStages barriers
};

// Bytes of the barriers, rounded up so that what follows is 16-byte aligned.
constexpr int kBarBytes = (kStages * 8 + 15) / 16 * 16;

__device__ __forceinline__ Ring ring_init(unsigned char* smem,
                                          int stage_bytes) {
  Ring r{smem, reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes)};
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(&r.bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// A block's walk over its items: lane l, chunk c, and the ring stage k and
// phase parity of the item, advanced without a division per item.
struct Cursor {
  long long l;
  int c, k;
  uint32_t parity;
  __device__ __forceinline__ Cursor(long long it, int chunks)
      : l(it / chunks), c(static_cast<int>(it % chunks)), k(0), parity(0) {}
  __device__ __forceinline__ void next(int chunks) {
    if (++c == chunks) {
      c = 0;
      ++l;
    }
    if (++k == kStages) {
      k = 0;
      parity ^= 1u;
    }
  }
};

// The block's range of items, items * b / grid to items * (b + 1) / grid.
__device__ __forceinline__ long long range_begin(long long items, int b) {
  return items * b / gridDim.x;
}

// Thread 0: start the copy of item `q`'s rows into its stage.
__device__ __forceinline__ void issue(const Ring& ring, const Cursor& q,
                                      const int8_t* a8, int t, int n_pad,
                                      int rows) {
  const int r0 = q.c * rows;
  const int rc = min(rows, t - r0);
  bulk_load(ring.stage + static_cast<size_t>(q.k) * rows * n_pad,
            a8 + (q.l * t + r0) * static_cast<long long>(n_pad),
            static_cast<uint32_t>(rc) * n_pad, &ring.bar[q.k]);
}

// Thread 0: fill the ring with the block's first items. `nxt` and `issued`
// become the next item to copy.
__device__ __forceinline__ void prime(const Ring& ring, Cursor* nxt,
                                      long long* issued, long long i1,
                                      const int8_t* a8, int t, int n_pad,
                                      int rows, int chunks) {
  for (int k = 0; k < kStages && *issued < i1; ++k) {
    issue(ring, *nxt, a8, t, n_pad, rows);
    ++*issued;
    nxt->next(chunks);
  }
}

// out (B, T) = A x. Shared: the ring, then red [rows][S + 1] floats.
__global__ void __launch_bounds__(kMaxThreads)
    gemv_fwd_kernel(const int8_t* __restrict__ a8,
                    const float* __restrict__ x, float* __restrict__ out,
                    int t, int n, int n_pad, int rows, int chunks,
                    long long items) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int segs = n_pad / kSegBytes, groups = blockDim.x / segs;
  const int s = threadIdx.x % segs, g = threadIdx.x / segs;
  const int stage_bytes = rows * n_pad;
  const Ring ring = ring_init(smem, stage_bytes);
  float* red = reinterpret_cast<float*>(smem + kStages * stage_bytes +
                                        kBarBytes);
  const long long i0 = range_begin(items, blockIdx.x);
  const long long i1 = range_begin(items, blockIdx.x + 1);
  Cursor cur(i0, chunks), nxt = cur;
  long long issued = i0;
  if (threadIdx.x == 0)
    prime(ring, &nxt, &issued, i1, a8, t, n_pad, rows, chunks);

  long long lane = -1;
  float xr[kSegBytes];
  for (long long it = i0; it < i1; ++it, cur.next(chunks)) {
    const int r0 = cur.c * rows;
    const int rc = min(rows, t - r0);
    if (cur.l != lane) {
      lane = cur.l;
#pragma unroll
      for (int q = 0; q < kSegBytes; ++q) {
        const int j = s * kSegBytes + q;
        xr[q] = j < n ? x[lane * n + j] : 0.f;
      }
    }
    mbar_wait(&ring.bar[cur.k], cur.parity);
    const unsigned char* st =
        ring.stage + static_cast<size_t>(cur.k) * stage_bytes;
#pragma unroll 2
    for (int r = g; r < rc; r += groups) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(st + r * n_pad + s * kSegBytes);
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
      red[r * (segs + 1) + s] = p0 + p1;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rc; r += blockDim.x) {
      float sum = 0.f;
      for (int q = 0; q < segs; ++q) sum += red[r * (segs + 1) + q];
      out[lane * t + r0 + r] = sum;
    }
    __syncthreads();  // this item's stage and red are free again
    if (threadIdx.x == 0 && issued < i1) {
      issue(ring, nxt, a8, t, n_pad, rows);
      ++issued;
      nxt.next(chunks);
    }
  }
}

// The block whose range holds item `it`: the last b with range_begin <= it.
__device__ __forceinline__ long long block_of(long long it, long long items) {
  return ((it + 1) * gridDim.x + items - 1) / items - 1;
}

// out (B, n) = A^T y, or with `ea` given out = ((-ea - A^T y) + eb) - ec
// (ea, eb, ec (B, n)), formed from the finished sum where it is written, each
// operation rounded to nearest in that order. A run is the chunks of one lane
// that one block takes in a row; the block sums a run in registers. A run
// that is a whole lane goes straight to out; another goes to part (B, chunks,
// n) at its first chunk, and the block that ends a lane's last run (counted
// in done (B,), which it sets back to 0) adds the lane's runs in chunk order
// into out.
// Shared: the ring, then red [G][4][S] float4, then sy [2][rows] floats.
__global__ void __launch_bounds__(kMaxThreads)
    gemv_tr_kernel(const int8_t* __restrict__ a8,
                   const float* __restrict__ y, float* __restrict__ part,
                   float* __restrict__ out, unsigned int* __restrict__ done,
                   const float* __restrict__ ea, const float* __restrict__ eb,
                   const float* __restrict__ ec, int t, int n, int n_pad,
                   int rows, int chunks, long long items) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int segs = n_pad / kSegBytes, groups = blockDim.x / segs;
  const int s = threadIdx.x % segs, g = threadIdx.x / segs;
  const int tid = threadIdx.x;
  const int stage_bytes = rows * n_pad;
  const Ring ring = ring_init(smem, stage_bytes);
  float* red = reinterpret_cast<float*>(smem + kStages * stage_bytes +
                                        kBarBytes);
  float* sy = red + groups * n_pad;
  const long long i0 = range_begin(items, blockIdx.x);
  const long long i1 = range_begin(items, blockIdx.x + 1);
  Cursor cur(i0, chunks), nxt = cur;
  long long issued = i0;
  if (tid == 0) prime(ring, &nxt, &issued, i1, a8, t, n_pad, rows, chunks);
  // an item's y, one row per thread (rows <= blockDim.x); the next item's
  // is loaded while this one computes
  auto y_of = [&](const Cursor& q) {
    const int r0 = q.c * rows;
    return tid < min(rows, t - r0) ? y[q.l * t + r0 + tid] : 0.f;
  };
  if (tid < rows) sy[tid] = y_of(cur);
  __syncthreads();
  // entry j of lane l of out from its finished sum
  auto result = [&](long long l, int j, float sum) {
    if (ea == nullptr) return sum;
    const long long i = l * n + j;
    return __fsub_rn(__fadd_rn(__fsub_rn(-ea[i], sum), eb[i]), ec[i]);
  };

  float acc[kSegBytes];
#pragma unroll
  for (int q = 0; q < kSegBytes; ++q) acc[q] = 0.f;
  int c0 = cur.c;  // the current run's first chunk
  int buf = 0;
  for (long long it = i0; it < i1; ++it, cur.next(chunks)) {
    const int rc = min(rows, t - cur.c * rows);
    const float* syc = sy + buf * rows;
    Cursor after = cur;
    after.next(chunks);
    const float y_next = it + 1 < i1 ? y_of(after) : 0.f;
    mbar_wait(&ring.bar[cur.k], cur.parity);
    const unsigned char* st =
        ring.stage + static_cast<size_t>(cur.k) * stage_bytes;
#pragma unroll 2
    for (int r = g; r < rc; r += groups) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(st + r * n_pad + s * kSegBytes);
      const uint32_t wd[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                              w.z ^ 0x80808080u, w.w ^ 0x80808080u};
      const float yr = syc[r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * q + i] = fmaf(entry(wd[q], i), yr, acc[4 * q + i]);
    }
    if (cur.c == chunks - 1 || it + 1 == i1) {  // the run ends here
      // group g's sums as float4 (q, s) at q * S + s: a warp's stores are
      // contiguous
      float4* dst = reinterpret_cast<float4*>(red + g * n_pad);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[q * segs + s] = make_float4(acc[4 * q], acc[4 * q + 1],
                                        acc[4 * q + 2], acc[4 * q + 3]);
        acc[4 * q] = acc[4 * q + 1] = acc[4 * q + 2] = acc[4 * q + 3] = 0.f;
      }
      __syncthreads();
      const bool whole = c0 == 0 && cur.c == chunks - 1;
      const long long lane0 = cur.l * chunks;
      float* pl = whole ? out + cur.l * n : part + (lane0 + c0) * n;
      for (int j = tid; j < n; j += blockDim.x) {
        const int at = (((j >> 2) & 3) * segs + (j >> 4)) * 4 + (j & 3);
        float sum = red[at];
        for (int q = 1; q < groups; ++q) sum += red[q * n_pad + at];
        pl[j] = whole ? result(cur.l, j, sum) : sum;
      }
      if (!whole) {
        __threadfence();
        __syncthreads();
        // the lane's runs: chunk 0 in block b0, then the range of each
        // block up to b1
        const int b0 = static_cast<int>(block_of(lane0, items));
        const int b1 = static_cast<int>(block_of(lane0 + chunks - 1, items));
        if (tid == 0) {
          last = atomicAdd(&done[cur.l], 1u) + 1 == b1 - b0 + 1;
          if (last) done[cur.l] = 0;  // ready for the next call
        }
        __syncthreads();
        if (last) {  // add the runs in chunk order
          __threadfence();
          const float* lp = part + lane0 * n;
          for (int j = tid; j < n; j += blockDim.x) {
            float sum = __ldcg(lp + j);
            for (int b = b0 + 1; b <= b1; ++b)
              sum += __ldcg(lp + (range_begin(items, b) - lane0) * n + j);
            out[cur.l * n + j] = result(cur.l, j, sum);
          }
        }
      }
      c0 = after.c;
    }
    if (tid < rows) sy[(buf ^ 1) * rows + tid] = y_next;
    buf ^= 1;
    __syncthreads();  // this item's stage, red and y are free again
    if (tid == 0 && issued < i1) {
      issue(ring, nxt, a8, t, n_pad, rows);
      ++issued;
      nxt.next(chunks);
    }
  }
}

struct Config {
  int device = -1, n_pad = 0, threads = 0, rows = 0, blocks = 0;
  size_t smem = 0;
};

int threads_for(int n_pad) {
  const int segs = n_pad / kSegBytes;
  return segs * (segs >= kThreads ? 1 : kThreads / segs);
}

// At most a stage's bytes, and at most one row per thread (A^T y stages an
// item's y one row per thread).
int rows_for(int n_pad) {
  const int rows = kStageBytes / n_pad, threads = threads_for(n_pad);
  return rows < threads ? rows : threads;
}

// Threads, rows per chunk, shared memory and resident blocks for one width,
// queried once per (device, width) and kept.
cudaError_t config_for(const void* kernel, bool fwd, int n_pad, Config* cache,
                       Config* cfg) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (cache->device == device && cache->n_pad == n_pad) {
    *cfg = *cache;
    return cudaSuccess;
  }
  Config c;
  c.device = device;
  c.n_pad = n_pad;
  const int segs = n_pad / kSegBytes;
  c.threads = threads_for(n_pad);
  const int groups = c.threads / segs;
  c.rows = rows_for(n_pad);
  const size_t ring = static_cast<size_t>(kStages) * c.rows * n_pad +
                      kBarBytes;
  c.smem = ring + sizeof(float) *
                      (fwd ? static_cast<size_t>(c.rows) * (segs + 1)
                           : static_cast<size_t>(groups) * n_pad + 2 * c.rows);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(c.smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    c.threads, c.smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  c.blocks = per_sm * sms;
  *cache = c;
  *cfg = c;
  return cudaSuccess;
}

bool shape_ok(int batch, int t, int n, int n_pad) {
  return batch >= 0 && t >= 1 && n >= 1 && n_pad % kSegBytes == 0 &&
         n_pad >= n && n_pad - n < kSegBytes &&
         n_pad / kSegBytes <= kMaxThreads;
}

// How a call splits its lanes: rows per chunk, chunks per lane, items, grid.
struct Plan {
  int rows, chunks, grid;
  long long items;
};

// Chunks per lane from ceil(t / cfg.rows) to twice that: the count that
// least loads the busiest block, its items times the rows per item, plus
// `fold_rows` when a lane is split (A^T y's fold). More, smaller chunks
// even out the blocks' shares when B * chunks is just above a multiple of
// the grid (T = 384: 3 chunks of 128 rows are 384 items on 264 blocks, some
// blocks taking two; 4 chunks of 96 are 512, nearly two each).
Plan plan_for(const Config& cfg, int batch, int t, int fold_rows) {
  const int c_min = (t + cfg.rows - 1) / cfg.rows;
  Plan best{};
  long long best_cost = -1;
  for (int c = c_min; c <= 2 * c_min && c <= t; ++c) {
    Plan p;
    p.rows = (t + c - 1) / c;
    p.chunks = (t + p.rows - 1) / p.rows;
    p.items = static_cast<long long>(batch) * p.chunks;
    p.grid = static_cast<int>(p.items < cfg.blocks ? p.items : cfg.blocks);
    const long long per_block = (p.items + p.grid - 1) / p.grid;
    const long long cost =
        per_block * p.rows + (p.chunks > 1 ? fold_rows : 0);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = p;
    }
  }
  return best;
}

Config g_fwd, g_tr;

}  // namespace

extern "C" {

// The most rows per chunk for a packed width n_pad: a call splits a lane
// into at most 2 ceil(t / this) chunks, and the wrapper sizes A^T y's
// partials with it.
int ldpc_gemv_chunk_rows(int n_pad) { return rows_for(n_pad); }

// Launch A x for `batch` lanes on `stream`: a8 (batch, t, n_pad) int8
// contiguous and 16-byte aligned, x (batch, n), out (batch, t). Returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
int ldpc_gemv_fwd(const void* a8, const void* x, void* out, int batch, int t,
                  int n, int n_pad, void* stream) {
  if (!shape_ok(batch, t, n, n_pad)) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Config cfg;
  cudaError_t e = config_for(reinterpret_cast<const void*>(gemv_fwd_kernel),
                             true, n_pad, &g_fwd, &cfg);
  if (e != cudaSuccess) return e;
  const Plan p = plan_for(cfg, batch, t, 0);
  gemv_fwd_kernel<<<p.grid, cfg.threads, cfg.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a8), static_cast<const float*>(x),
      static_cast<float*>(out), t, n, n_pad, p.rows, p.chunks, p.items);
  return cudaGetLastError();
}

// Launch A^T y for `batch` lanes on `stream`: a8 as above, y (batch, t),
// part scratch of batch x 2 ceil(t / chunk_rows) x n floats, out (batch, n),
// done (batch,) int32
// zeros, which the kernel leaves zero: one array per stream, as two calls at
// once would share it; ea, eb, ec (batch, n) or all three null: with them out
// is -ea - A^T y + eb - ec. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
int ldpc_gemv_tr(const void* a8, const void* y, void* part, void* out,
                 void* done, const void* ea, const void* eb, const void* ec,
                 int batch, int t, int n, int n_pad, void* stream) {
  if (!shape_ok(batch, t, n, n_pad) || (ea == nullptr) != (eb == nullptr) ||
      (ea == nullptr) != (ec == nullptr))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Config cfg;
  cudaError_t e = config_for(reinterpret_cast<const void*>(gemv_tr_kernel),
                             false, n_pad, &g_tr, &cfg);
  if (e != cudaSuccess) return e;
  const Plan p = plan_for(cfg, batch, t, kFoldRows);
  gemv_tr_kernel<<<p.grid, cfg.threads, cfg.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a8), static_cast<const float*>(y),
      static_cast<float*>(part), static_cast<float*>(out),
      static_cast<unsigned int*>(done), static_cast<const float*>(ea),
      static_cast<const float*>(eb), static_cast<const float*>(ec), t, n,
      n_pad, p.rows, p.chunks, p.items);
  return cudaGetLastError();
}

}  // extern "C"
