// The IPM's normal matrix per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_normal_kernel` in
// ldpc_tpu/ops/pallas/gemv_kernel.py (called by `normal_build`):
//
//     M = A^T diag(d) A + diag(dxx) + delta I        (n x n per lane)
//
// with A the lane's (T, n) float32 cut slice, d (T,) the Newton weights y/s
// and dxx (n,) the box terms. The plain PyTorch twin is `normal_ref` in
// ldpc_tpu_torch/ops/gemv_ref.py (torch.bmm). The TPU kernel split d into
// three exact bf16 planes for its bf16 matrix unit; here the products are
// float32 FMAs, and with +-1/0 rows every product A_ti d_t A_tj is exactly
// +-d_t or 0, so only the order of the sums differs from the twin.
//
// Design: a per-lane SYRK. M is cut into 64 x 64 tiles; one block of 256
// threads computes one tile on or above the diagonal (15 of 25 tiles at
// n = 280), so grid = (tiles on or above the diagonal, B). The block walks T
// in chunks of 16 rows, staging A[chunk, i-tile] and A[chunk, j-tile] * d in
// shared memory (coalesced 256 B row loads), and each thread accumulates a
// 4 x 4 register tile. The finished tile goes through shared memory so that
// both it and its mirror below the diagonal are stored with coalesced rows;
// a tile on the diagonal stores its upper half and mirrors it, so M is
// exactly symmetric. The diagonal gets (m_ii + dxx_i) + delta, the twin's
// order.
//
// What bounds it: 2 n^2 T flops per lane (28 GFLOP for 128 lanes at n = 280,
// T = 1408, of which the tiles above the diagonal do 60 %) against 4 T n
// bytes of A read once per tile row: compute-bound, on the float32 FMA units
// (67 TFLOP/s at 700 W), and here on shared-memory reads (two loads per two
// FMAs in the inner loop). A tensor-core version (wgmma on bf16 planes of d,
// exact against +-1/0 rows) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kK = 16;          // rows of A per staged chunk
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
normal_build_kernel(const float* __restrict__ a, const float* __restrict__ d,
                    const float* __restrict__ dxx, float* __restrict__ out,
                    int t, int n, long long lane_stride, float delta,
                    int tiles) {
  __shared__ float si[kK][kTile];              // A[t0 + k, i0 + c]
  __shared__ float sj[kK][kTile];              // A[t0 + k, j0 + c] * d
  __shared__ float tile[kTile][kTile + 1];     // the finished tile
  // blockIdx.x -> (bi, bj), bi <= bj, row by row of the upper triangle
  int p = blockIdx.x, bi = 0;
  while (p >= tiles - bi) {
    p -= tiles - bi;
    ++bi;
  }
  const int bj = bi + p;
  const int i0 = bi * kTile, j0 = bj * kTile;
  const size_t l = blockIdx.y;
  const float* al = a + l * static_cast<size_t>(lane_stride);
  const float* dl = d + l * t;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int t0 = 0; t0 < t; t0 += kK) {
    for (int e = tid; e < kK * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile, r = t0 + k;
      float vi = 0.f, vj = 0.f;
      if (r < t) {
        const float* row = al + static_cast<size_t>(r) * n;
        if (i0 + c < n) vi = row[i0 + c];
        if (j0 + c < n) vj = row[j0 + c] * dl[r];
      }
      si[k][c] = vi;
      sj[k][c] = vj;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float ai[4], aj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) ai[u] = si[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) aj[v] = sj[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(ai[u], aj[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) tile[ty + 16 * u][tx + 16 * v] = acc[u][v];
  __syncthreads();

  float* ol = out + l * n * static_cast<size_t>(n);
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    // the tile itself, entries on or above the diagonal of M
    int i = i0 + r, j = j0 + c;
    if (i < n && j < n && i <= j) {
      float v = tile[r][c];
      if (i == j) v = (v + dxx[l * n + i]) + delta;
      ol[static_cast<size_t>(i) * n + j] = v;
    }
    // its mirror: M[j0 + r][i0 + c] = tile[c][r], strictly below
    i = j0 + r;
    j = i0 + c;
    if (i < n && j < n && j < i)
      ol[static_cast<size_t>(i) * n + j] = tile[c][r];
  }
}

}  // namespace

extern "C" {

// Launch the normal-matrix build for `batch` lanes on `stream`; returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
int ldpc_normal_build(const void* a, const void* d, const void* dxx,
                      void* out, int batch, int t, int n,
                      long long lane_stride, float delta, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (batch > kMaxGridY) return cudaErrorInvalidConfiguration;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, batch);
  normal_build_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(d),
      static_cast<const float*>(dxx), static_cast<float*>(out), t, n,
      lane_stride, delta, tiles);
  return cudaGetLastError();
}

}  // extern "C"
