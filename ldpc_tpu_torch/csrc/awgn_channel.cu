// The harness's channel step in one launch a batch, for NVIDIA Hopper
// (sm_90a): the trial-keyed noise, BPSK, the LLR scaling and the channel's
// hard-decision count of `batch` codewords.
//
// No Pallas kernel stands behind it. The JAX package draws its noise with
// jax.random inside the step XLA compiles (ldpc_tpu/harness/experiment.py);
// the port draws it from a counter hash (ldpc_tpu_torch/channel/awgn.py),
// which eager PyTorch ran as about 100 small launches a batch on int64 and
// float64 tensors, each reading and writing the whole (B, n) batch. Here
// each value is made once, in registers, and only y, the LLRs and the
// count are written. ldpc_tpu_torch/ops/channel_kernel.py wraps it; the
// plain twin is `channel_ref` in ldpc_tpu_torch/channel/awgn.py.
//
// The layout: one thread a pair of bits (one Box-Muller pair), the pairs
// of a lane on whole warps, `warps` = ceil(pairs / 32) of them up to 16
// (more pairs: each thread takes every (32 * warps)-th), and as many lanes
// a block as fit 8 warps (one at optimalH's 140 pairs and H02's 320).
// Each warp writes its 64 floats of y and of the LLRs as two coalesced
// stores of 32 neighbouring floats, gathered by warp shuffles from the
// threads that made them, whatever the parity of n. A lane's count is a
// warp reduction (__reduce_add_sync), then the sum of its warps' counts.
//
// What bounds it: the bytes and the float64 work, about equally. Per
// pair one log, one sqrt and one sincos in float64: at most 85 float64
// instructions a pair (the SASS's static count), 97 M at 8192 x 280, 5.8
// us at the H100's 16.7 T float64 instructions a second; the bytes (bits
// in, y and the LLRs out: 20.8 MB) take 6.2 us at 3.35 TB/s, and overlap.
//
// Bit for bit with the twin:
//  * the hash is defined mod 2^32, so uint32 arithmetic is exact; the key
//    is an argument, worked out on the host by the twin's own helper
//    (channel/awgn.py noise_key);
//  * Box-Muller rounds each step as the twin's separate launches do:
//    __dadd_rn / __dmul_rn, never contracted into an FMA, and log and sqrt
//    of CUDA's math library in float64, as PyTorch calls them; sincos
//    gives the bits of separate sin and cos (held so on the card, 10^7
//    normals among them) with one range reduction (85 float64
//    instructions in the SASS against 98, 22 us against 24 at 8192 x 280);
//    each normal is rounded to float32 once (cvt.rn);
//  * y = (1 - 2 bit) + sigma * z and llr = scale * y in float32 with
//    __fmul_rn / __fadd_rn, sigma and scale as float32 (PyTorch rounds a
//    Python float to float32 where it multiplies a float32 tensor);
//  * the count is an integer sum: any order gives the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxLaneWarps = 16;   // warps of one lane
constexpr int kBlockWarps = 8;      // lanes a block fill up to this
constexpr unsigned kFull = 0xffffffffu;
// the twin's (2 * math.pi * 2.0 ** -32), exact powers of two apart
constexpr double kTheta = 2.0 * 3.141592653589793 * 0x1p-32;

// Wellons' lowbias32, as the twin's _mix32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float symbol(uint8_t bit) {
  return __fsub_rn(1.0f, __fmul_rn(2.0f, static_cast<float>(bit)));
}

__device__ __forceinline__ int hard_error(uint8_t bit, float y) {
  return bit == 0 ? (y <= 0.0f) : (y > 0.0f);
}

__global__ void __launch_bounds__(kMaxLaneWarps * kWarp)
awgn_channel_kernel(const uint8_t* __restrict__ bits,
                    const int64_t* __restrict__ trial, int64_t trial_stride,
                    const float* __restrict__ sigma_lane,
                    const float* __restrict__ scale_lane, float sigma,
                    float scale, uint32_t key, float* __restrict__ y,
                    float* __restrict__ llr, int64_t* __restrict__ hd,
                    int batch, int n, int warps) {
  __shared__ int counts[kMaxLaneWarps];
  const int warp = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  const int part = warp % warps;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp / warps) +
      warp / warps;
  const int pairs = (n + 1) / 2;
  int errors = 0;
  if (b < batch) {
    const uint32_t t = static_cast<uint32_t>(trial[b * trial_stride]);
    const uint32_t lane_key = mix32(key ^ t);
    const float sig = sigma_lane ? sigma_lane[b] : sigma;
    const float sc = scale_lane ? scale_lane[b] : scale;
    const uint8_t* bits_b = bits + b * n;
    float* y_b = y + b * n;
    float* llr_b = llr + b * n;
    // warp-uniform trip count: every thread reaches the shuffles
    for (int base = part * kWarp; base < pairs; base += warps * kWarp) {
      const int p = base + tid;
      float y0 = 0.0f, y1 = 0.0f;
      if (p < pairs) {
        const uint32_t ctr = 2u * static_cast<uint32_t>(p);
        const uint32_t h0 = mix32(mix32(lane_key ^ ctr) + t);
        const uint32_t h1 = mix32(mix32(lane_key ^ (ctr + 1u)) + t);
        const double u1 =
            __dmul_rn(__dadd_rn(static_cast<double>(h0), 1.0), 0x1p-32);
        const double theta = __dmul_rn(kTheta, static_cast<double>(h1));
        const double r = __dsqrt_rn(__dmul_rn(-2.0, log(u1)));
        double sin_t, cos_t;
        sincos(theta, &sin_t, &cos_t);
        const float z0 = __double2float_rn(__dmul_rn(r, cos_t));
        const float z1 = __double2float_rn(__dmul_rn(r, sin_t));
        const int j = 2 * p;
        const uint8_t b0 = bits_b[j];
        y0 = __fadd_rn(symbol(b0), __fmul_rn(sig, z0));
        errors += hard_error(b0, y0);
        if (j + 1 < n) {
          const uint8_t b1 = bits_b[j + 1];
          y1 = __fadd_rn(symbol(b1), __fmul_rn(sig, z1));
          errors += hard_error(b1, y1);
        }
      }
      // floats 2 base + tid and 2 base + 32 + tid of the row: component
      // tid & 1 of the pairs base + tid / 2 and base + 16 + tid / 2
      const int src = tid >> 1;
      const float lo0 = __shfl_sync(kFull, y0, src);
      const float lo1 = __shfl_sync(kFull, y1, src);
      const float hi0 = __shfl_sync(kFull, y0, src + 16);
      const float hi1 = __shfl_sync(kFull, y1, src + 16);
      const float lo = (tid & 1) ? lo1 : lo0, hi = (tid & 1) ? hi1 : hi0;
      const int j_lo = 2 * base + tid, j_hi = j_lo + kWarp;
      if (j_lo < n) {
        y_b[j_lo] = lo;
        llr_b[j_lo] = __fmul_rn(sc, lo);
      }
      if (j_hi < n) {
        y_b[j_hi] = hi;
        llr_b[j_hi] = __fmul_rn(sc, hi);
      }
    }
  }
  errors = __reduce_add_sync(kFull, errors);
  if (tid == 0) counts[warp] = errors;
  __syncthreads();
  if (part == 0 && tid == 0 && b < batch) {
    int64_t sum = 0;
    for (int w = 0; w < warps; ++w) sum += counts[warp + w];
    hd[b] = sum;
  }
}

}  // namespace

extern "C" {

// Launches the channel of `batch` codewords of `n` bits on `stream`.
// `sigma_lane` / `scale_lane`: per-lane float32 factors, or null for the
// scalars `sigma` / `scale`. `trial_stride`: the step between lanes' trial
// indices, in elements. Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for a negative shape). Does not
// synchronise.
int ldpc_awgn_channel(const void* bits, const void* trial,
                      long long trial_stride, const void* sigma_lane,
                      const void* scale_lane, float sigma, float scale,
                      unsigned key, void* y, void* llr, void* hd, int batch,
                      int n, void* stream) {
  if (batch < 0 || n < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int pair_warps = ((n + 1) / 2 + kWarp - 1) / kWarp;
  const int warps = pair_warps < 1 ? 1
                    : pair_warps > kMaxLaneWarps ? kMaxLaneWarps
                                                 : pair_warps;
  const int lanes = warps >= kBlockWarps ? 1 : kBlockWarps / warps;
  const int blocks = (batch + lanes - 1) / lanes;
  awgn_channel_kernel<<<blocks, lanes * warps * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int64_t*>(trial),
      static_cast<int64_t>(trial_stride),
      static_cast<const float*>(sigma_lane),
      static_cast<const float*>(scale_lane), sigma, scale,
      static_cast<uint32_t>(key), static_cast<float*>(y),
      static_cast<float*>(llr), static_cast<int64_t*>(hd), batch, n, warps);
  return cudaGetLastError();
}

}  // extern "C"
