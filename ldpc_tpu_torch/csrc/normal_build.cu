// The IPM's normal matrix per lane, on the tensor cores of NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_normal_kernel` in
// ldpc_tpu/ops/pallas/gemv_kernel.py (called by `normal_build`):
//
//     M = A^T diag(d) A + diag(dxx) + delta I        (n x n per lane)
//
// with A the lane's (T, n) cut slice, rows +-1/0, d (T,) the Newton weights
// y/s in [1e-10, 1e10] and dxx (n,) the box terms. The plain PyTorch version
// is `normal_ref` (ldpc_tpu_torch/ops/gemv_ref.py) on the unpacked copy;
// `normal_split_ref` there repeats this kernel's arithmetic.
//
// What bounds it: 2 n^2 T flops per lane against T n bytes of A, far above
// the card's flops-per-byte line, so it is bound by operations. On the
// float32 FMA units (67 TFLOP/s) one PyTorch call (`baddbmm`) is already at
// that bound; only the tensor cores (989 TFLOP/s in bf16) can pass it. d is
// float32 and must stay exact, so, as the TPU kernel did for its bf16 matrix
// unit, d is split into three bf16 planes
//
//     hi = bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid)
//
// (round to nearest, the differences in float32): hi + mid + lo == d for
// every normal float32, and each product A_ti * plane_t * A_tj is exactly
// +- the plane or 0 in bf16, so the only rounding left is the float32
// accumulation. Three times the multiply-adds at 15 times the rate.
//
// Design:
//   - A is the packed int8 copy `pack_rows` makes once per solve, a
//     contiguous (B, T, n_pad) tensor, n_pad = n rounded up to 16, pad
//     columns zero: a quarter of the float32 slice's bytes, 16-byte row
//     segments. int8 -> bf16 of +-1/0 is exact and costs two integer
//     operations per entry;
//   - M is cut into 96 x 96 tiles (n_pad = 288 is three of them); one block
//     of 256 threads computes one tile on or above the diagonal, so
//     grid = (tiles on or above the diagonal, B), 6 x B at n = 280. Ragged
//     edges are masked: segments past n_pad and rows past T load as zero,
//     entries past n are not stored;
//   - the block walks T in chunks of 64 rows. A chunk's two column blocks
//     (one on a diagonal tile) are staged once in shared memory as bf16,
//     row pitch 400 bytes so that eight rows of a 16-byte column fall in
//     eight different bank groups, and the chunk's three planes beside them.
//     The next chunk's 16-byte global loads are in flight in registers while
//     the block computes on this one;
//   - `mma.sync.m16n8k16` (bf16 in, float32 accumulate), eight warps as
//     2 x 4, each a 48 x 24 piece of the tile (3 x 3 instruction tiles, 36
//     accumulators per thread). The contraction runs over T and A is stored
//     with n contiguous, so both operands are read with `ldmatrix.trans`.
//     The left operand is A's chunk as it is; the right operand is the same
//     fragment times a plane, one packed bf16 multiply per register (exact),
//     so a fragment is loaded once and used for all three planes;
//     `mma.sync`, not `wgmma`: a `wgmma` version (the left operand from
//     registers, the staged chunk as the transposed right operand in the
//     no-swizzle core-matrix layout, 64-row blocks by 32-column units of
//     accumulators) gives the same bits but ran slower on the card: with
//     one warpgroup's 144 accumulators per SM, the int8 -> bf16 staging and
//     not the tensor cores set its pace. `mma.sync` has the same exact
//     products at a lower peak and sixteen warps per SM to stage with;
//   - the sums stay in the tensor cores' float32 accumulators over all of
//     T. Their adds are not IEEE round-to-nearest at every step; with d
//     over 16 decades the result still lies well inside the float32
//     summation bound T 2^-23 sum |terms| that the tests hold it to.
//     Folding each chunk's sums into float32 registers would be closer
//     still, at 36 more registers a thread and a slower kernel (PERF.md has
//     both measured), so it is not done;
//   - each accumulator register is stored twice, at (i, j) and at (j, i),
//     both as full 32-byte sectors; a tile on the diagonal stores only
//     i <= j and mirrors, so M is exactly symmetric. The diagonal gets
//     (m_ii + dxx_i) + delta, the plain version's order.
//
// No atomics and a fixed order of sums: a call gives the same bits every
// time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 96;              // rows and columns of M per block
constexpr int kChunk = 64;             // rows of A staged per step
constexpr int kSeg = 16;               // entries per 16-byte global load
constexpr int kSegs = kTile / kSeg;    // segments per row and column block
constexpr int kPitch = 2 * kTile + 8;  // bf16 per staged row (400 bytes)
constexpr int kThreads = 256;
constexpr int kLoads = kChunk * 2 * kSegs / kThreads;  // per thread and chunk
constexpr int kMi = 3, kNi = 3;        // m16 and n8 tiles per warp
constexpr int kMaxGridY = 65535;

static_assert(kChunk * 2 * kSegs % kThreads == 0, "loads divide evenly");
static_assert(kChunk <= kThreads, "one thread per staged row of d");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two int8 entries in {-1, 0, 1} (bytes `lo` and `lo + 1` of w) as packed
// bf16: bit 0 of a byte says non-zero, bit 7 negative.
__device__ __forceinline__ uint32_t pair_bf16(uint32_t w, int lo) {
  const uint32_t v = __byte_perm(w, 0u, lo == 0 ? 0x4140 : 0x4342);
  return (v & 0x00010001u) * 0x3F80u | (v & 0x00800080u) << 8;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a8 (B, T, n_pad) int8 contiguous; d (B, T); dxx (B, n); out (B, n, n).
__global__ void __launch_bounds__(kThreads, 2)
normal_build_kernel(const int8_t* __restrict__ a8, const float* __restrict__ d,
                    const float* __restrict__ dxx, float* __restrict__ out,
                    int t, int n, int n_pad, float delta, int tiles) {
  __shared__ __align__(16) __nv_bfloat16 sa[kChunk][kPitch];
  __shared__ __align__(16) __nv_bfloat16 sp[3][kChunk];
  // blockIdx.x -> (bi, bj), bi <= bj, row by row of the upper triangle
  int p = blockIdx.x, bi = 0;
  while (p >= tiles - bi) {
    p -= tiles - bi;
    ++bi;
  }
  const int bj = bi + p;
  const bool diag = bi == bj;
  const int i0 = bi * kTile, j0 = bj * kTile;
  const size_t l = blockIdx.y;
  const int8_t* al = a8 + l * static_cast<size_t>(t) * n_pad;
  const float* dl = d + l * t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  // a diagonal tile stages one column block and reads it for both operands
  const int spr = diag ? kSegs : 2 * kSegs;  // segments per staged row
  const int jcol = diag ? 0 : kTile;         // staged column of j0

  uint4 pre[kLoads];
  float dpre = 0.f;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kThreads;
      pre[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kChunk * spr) {
        const int r = t0 + e / spr, sg = e % spr;
        const int col = sg < kSegs ? i0 + sg * kSeg : j0 + (sg - kSegs) * kSeg;
        if (r < t && col < n_pad)
          pre[u] = __ldg(reinterpret_cast<const uint4*>(
              al + static_cast<size_t>(r) * n_pad + col));
      }
    }
    if (tid < kChunk) dpre = t0 + tid < t ? dl[t0 + tid] : 0.f;
  };
  auto stash = [&]() {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kThreads;
      if (e < kChunk * spr) {
        const uint32_t w[4] = {pre[u].x, pre[u].y, pre[u].z, pre[u].w};
        uint4* dst = reinterpret_cast<uint4*>(&sa[e / spr][(e % spr) * kSeg]);
        dst[0] = make_uint4(pair_bf16(w[0], 0), pair_bf16(w[0], 2),
                            pair_bf16(w[1], 0), pair_bf16(w[1], 2));
        dst[1] = make_uint4(pair_bf16(w[2], 0), pair_bf16(w[2], 2),
                            pair_bf16(w[3], 0), pair_bf16(w[3], 2));
      }
    }
    if (tid < kChunk) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(dpre);
      const float r1 = dpre - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const float r2 = r1 - __bfloat162float(mid);
      sp[0][tid] = hi;
      sp[1][tid] = mid;
      sp[2][tid] = __float2bfloat16_rn(r2);
    }
  };

  float acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // ldmatrix row addresses of this lane: matrix `mat` of four, row `mr`
  const int mat = lane >> 3, mr = lane & 7;
  // left operand (m16 x k16): matrices (k lo, m lo), (k lo, m hi),
  // (k hi, m lo), (k hi, m hi)
  const int a_row = mr + (mat >> 1) * 8;
  const int a_col = wm * (kMi * 16) + (mat & 1) * 8;
  // right operand, n8 tiles 0 and 1: (k lo, n0), (k hi, n0), (k lo, n1),
  // (k hi, n1); tile 2 with the first two of them
  const int b_row = mr + (mat & 1) * 8;
  const int b_col = jcol + wn * (kNi * 8) + (mat >> 1) * 8;
  const int b_col2 = jcol + wn * (kNi * 8) + 16;

  fetch(0);
  for (int t0 = 0; t0 < t; t0 += kChunk) {
    stash();
    __syncthreads();
    if (t0 + kChunk < t) fetch(t0 + kChunk);
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t af[kMi][4], bf[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldmatrix_x4_trans(af[mi], smem_u32(&sa[k0 + a_row][a_col + mi * 16]));
      {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(&sa[k0 + b_row][b_col]));
        bf[0][0] = r[0];
        bf[0][1] = r[1];
        bf[1][0] = r[2];
        bf[1][1] = r[3];
        ldmatrix_x2_trans(bf[2][0], bf[2][1],
                          smem_u32(&sa[k0 + b_row][b_col2]));
      }
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        // the plane at rows 2 tg, 2 tg + 1 and 8 above: this lane's k
        const uint32_t p0 =
            *reinterpret_cast<const uint32_t*>(&sp[pl][k0 + 2 * tg]);
        const uint32_t p1 =
            *reinterpret_cast<const uint32_t*>(&sp[pl][k0 + 8 + 2 * tg]);
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) {
          const uint32_t b0 = mul_bf16x2(bf[ni][0], p0);
          const uint32_t b1 = mul_bf16x2(bf[ni][1], p1);
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  float* ol = out + l * n * static_cast<size_t>(n);
  const float* dxl = dxx + l * n;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + wm * (kMi * 16) + mi * 16 + g + (q >> 1) * 8;
        const int j = j0 + wn * (kNi * 8) + ni * 8 + 2 * tg + (q & 1);
        if (i >= n || j >= n || i > j) continue;
        float v = acc[mi][ni][q];
        if (i == j) {
          ol[static_cast<size_t>(i) * n + i] = (v + dxl[i]) + delta;
        } else {
          ol[static_cast<size_t>(i) * n + j] = v;
          ol[static_cast<size_t>(j) * n + i] = v;
        }
      }
}

}  // namespace

extern "C" {

// Launch the normal-matrix build for `batch` lanes on `stream`: a8 the
// (batch, t, n_pad) int8 copy, contiguous and 16-byte aligned, n_pad = n
// rounded up to 16; d (batch, t), dxx (batch, n), out (batch, n, n) float32.
// Returns the cudaError_t of the launch (0 on success). Does not synchronise.
int ldpc_normal_build(const void* a8, const void* d, const void* dxx,
                      void* out, int batch, int t, int n, int n_pad,
                      float delta, void* stream) {
  if (batch < 0 || t < 1 || n < 1 || n_pad % kSeg != 0 || n_pad < n ||
      n_pad - n >= kSeg || batch > kMaxGridY)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, batch);
  normal_build_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a8), static_cast<const float*>(d),
      static_cast<const float*>(dxx), static_cast<float*>(out), t, n, n_pad,
      delta, tiles);
  return cudaGetLastError();
}

}  // extern "C"
