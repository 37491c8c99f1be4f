// Fused multi-level correlation lookup for Hopper (sm_90a): the forward,
// its gradient, and the prefix-sum variant.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/lookup.py
// (_fwd_kernel, reached from _lookup_fwd_impl; _bwd_kernel, reached from
// _lookup_bwd) and ops/pallas/lookup_v2.py (_v2_kernel, reached from
// lookup_fused_v2). For a level-0 volume row corr[m, 0..D) and its
// clamped fractional index x0[m], level l (D_l = D >> l cells) and tap
// k in [0, 2r]:
//
//   q = x0 / 2^l,  c0 = floor(q),  f = q - c0,  i = c0 + k - r
//   pool_l[i]   = (1 / 2^l) * sum_{j = i*2^l}^{(i+1)*2^l - 1} corr[m, j]
//   out[m, lK+k] = (1 - f) * pool_l[i] + f * pool_l[i + 1]
//
// with pool_l[i] = 0 outside [0, D_l). The gradient is linear in the same
// weights: dcorr[m, j] = sum_l sum_k g[m, lK+k] * w_{l,k}(j), x0 gets none.
//
// The TPU kernels padded D to 128 lanes, built a dense one-hot weight over
// every lane for each of the 33 taps (Mosaic cannot gather), and the
// prefix-sum kernel scanned with pltpu.roll. A GPU thread can read the few
// cells a tap needs, so:
//
//   * forward: one thread per (pixel, tap); it reads the at most 2 * 2^l
//     cells of its two pooled cells (L1 hits: a pixel's 33 threads share a
//     row of D floats), pools and lerps in fp32;
//   * backward: a gather, one thread per (pixel, cell j). At level l the
//     cell's pooled cell ci = j >> l is read by at most two taps:
//     k = ci - c0 + r with weight (1 - f) / 2^l and k = ci - c0 + r - 1 with
//     weight f / 2^l. Every output is written once; no atomics;
//   * prefix-sum variant: one warp per pixel. Each lane holds four
//     consecutive cells, a shuffle scan gives the inclusive prefix sums P
//     (D <= 128) in shared memory, and a pooled cell is the boundary
//     difference (P[(i+1)*2^l - 1] - P[i*2^l - 1]) / 2^l. The differences
//     lose low bits to cancellation, as the TPU kernel's do (~1e-4
//     relative against pairwise pooling).
//
// What bounds them on this card. Per pixel the forward reads D + 1 floats
// and writes 33, with a few flops per value read: far below the flop/byte
// ridge, so the bytes bound all three (the forward at the main path's
// (288 x 400, D = 64) volume moves ~45 MB, ~13.5 us at 3.35 TB/s).
//
// Exported with a plain C interface (loaded with ctypes). Inputs are
// contiguous fp32; each launch runs on the caller's stream and allocates
// nothing; the return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;  // prefix-sum variant: four cells per lane

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65536 ? blocks : 65536);
}

// q = x0 / 2^l split into its floor and fraction; the division by a power
// of two is exact, as in the TPU kernel.
__device__ __forceinline__ void level_index(float x0, int lvl, float* c0,
                                            float* f) {
  const float q = x0 / static_cast<float>(1 << lvl);
  *c0 = floorf(q);
  *f = q - *c0;
}

// the mean of pooled cell ci of level lvl, 0 when ci is outside [0, D_l);
// ci is a float so a huge or NaN index never reaches an integer cast
__device__ __forceinline__ float pooled(const float* __restrict__ row,
                                        float ci, int lvl, int Dl) {
  if (!(ci >= 0.f && ci < static_cast<float>(Dl))) return 0.f;
  const int n = 1 << lvl;
  const int j0 = static_cast<int>(ci) * n;
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += row[j0 + j];
  return s * (1.f / static_cast<float>(n));
}

__global__ void __launch_bounds__(kThreads)
lookup_fwd_kernel(const float* __restrict__ corr,
                  const float* __restrict__ x0, float* __restrict__ out,
                  long long M, int D, int radius, int num_levels) {
  const int K = 2 * radius + 1;
  const int T = num_levels * K;
  const long long total = M * T;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = i / T;
    const int t = static_cast<int>(i - m * T);
    const int lvl = t / K;
    const int k = t - lvl * K;
    float c0, f;
    level_index(x0[m], lvl, &c0, &f);
    const float ci = c0 + static_cast<float>(k - radius);
    const float* row = corr + m * D;
    const int Dl = D >> lvl;
    out[i] = (1.f - f) * pooled(row, ci, lvl, Dl)
             + f * pooled(row, ci + 1.f, lvl, Dl);
  }
}

__global__ void __launch_bounds__(kThreads)
lookup_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x0,
                  float* __restrict__ dcorr, long long M, int D, int radius,
                  int num_levels) {
  const int K = 2 * radius + 1;
  const int T = num_levels * K;
  const long long total = M * D;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = i / D;
    const int j = static_cast<int>(i - m * D);
    const float xm = x0[m];
    const float* gm = g + m * T;
    float acc = 0.f;
    for (int lvl = 0; lvl < num_levels; ++lvl) {
      const int ci = j >> lvl;
      if (ci >= (D >> lvl)) continue;  // past the last whole pooled cell
      float c0, f;
      level_index(xm, lvl, &c0, &f);
      const float inv = 1.f / static_cast<float>(1 << lvl);
      // the tap whose first cell is ci, and the tap whose second cell is ci
      const float k1 = static_cast<float>(ci) - c0 + static_cast<float>(radius);
      if (k1 >= 0.f && k1 < static_cast<float>(K))
        acc += gm[lvl * K + static_cast<int>(k1)] * ((1.f - f) * inv);
      const float k2 = k1 - 1.f;
      if (k2 >= 0.f && k2 < static_cast<float>(K))
        acc += gm[lvl * K + static_cast<int>(k2)] * (f * inv);
    }
    dcorr[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
lookup_v2_kernel(const float* __restrict__ corr,
                 const float* __restrict__ x0, float* __restrict__ out,
                 long long M, int D, int radius, int num_levels) {
  // P[w][0] = 0 stands for P[-1]; P[w][1 + j] is the inclusive sum to j
  __shared__ float P[kWarps][kMaxD + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int K = 2 * radius + 1;
  const int T = num_levels * K;
  if (lane == 0) P[warp][0] = 0.f;
  for (long long m = blockIdx.x * static_cast<long long>(kWarps) + warp; m < M;
       m += static_cast<long long>(gridDim.x) * kWarps) {
    const float* row = corr + m * D;
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      run += j < D ? row[j] : 0.f;
      v[e] = run;
    }
    float incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      if (j < D) P[warp][1 + j] = excl + v[e];
    }
    __syncwarp();
    const float xm = x0[m];
    for (int t = lane; t < T; t += 32) {
      const int lvl = t / K;
      const int k = t - lvl * K;
      float c0, f;
      level_index(xm, lvl, &c0, &f);
      const float inv = 1.f / static_cast<float>(1 << lvl);
      const float Dl = static_cast<float>(D >> lvl);
      const float ci = c0 + static_cast<float>(k - radius);
      float p0 = 0.f, p1 = 0.f;
      if (ci >= 0.f && ci < Dl) {
        const int c = static_cast<int>(ci);
        p0 = (P[warp][(c + 1) << lvl] - P[warp][c << lvl]) * inv;
      }
      if (ci + 1.f >= 0.f && ci + 1.f < Dl) {
        const int c = static_cast<int>(ci + 1.f);
        p1 = (P[warp][(c + 1) << lvl] - P[warp][c << lvl]) * inv;
      }
      out[m * T + t] = (1.f - f) * p0 + f * p1;
    }
    __syncwarp();  // P is rewritten for the warp's next pixel
  }
}

}  // namespace

extern "C" {

// corr (M,D) float32, x0 (M) float32 -> out (M, num_levels*(2*radius+1))
// float32; every element is written.
int lookup_forward(const float* corr, const float* x0, float* out,
                   long long M, int D, int radius, int num_levels,
                   void* stream) {
  const long long total = M * num_levels * (2 * radius + 1);
  if (total == 0) return static_cast<int>(cudaGetLastError());
  lookup_fwd_kernel<<<grid_for(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      corr, x0, out, M, D, radius, num_levels);
  return static_cast<int>(cudaGetLastError());
}

// g (M, num_levels*(2*radius+1)) float32, x0 (M) float32 -> dcorr (M,D)
// float32; every element is written.
int lookup_backward(const float* g, const float* x0, float* dcorr,
                    long long M, int D, int radius, int num_levels,
                    void* stream) {
  const long long total = M * D;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  lookup_bwd_kernel<<<grid_for(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      g, x0, dcorr, M, D, radius, num_levels);
  return static_cast<int>(cudaGetLastError());
}

// the prefix-sum variant of lookup_forward; D <= 128 (the caller checks)
int lookup_v2_forward(const float* corr, const float* x0, float* out,
                      long long M, int D, int radius, int num_levels,
                      void* stream) {
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (M + kWarps - 1) / kWarps;
  lookup_v2_kernel<<<static_cast<int>(blocks < 65536 ? blocks : 65536),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corr, x0, out, M, D, radius, num_levels);
  return static_cast<int>(cudaGetLastError());
}

const char* lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
