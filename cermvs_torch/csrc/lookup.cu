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
//   * forward: a pixel tile in shared memory. A thread per (pixel, tap)
//     that pools its two cells from global memory spends index divisions,
//     a reload and a division of x0 and up to 2 * 2^l scattered loads per
//     tap on what is a copy of D + 1 floats per pixel, so instead a block
//     owns tiles of P consecutive pixels, whose rows are
//     one span of P * D floats and whose taps one span of P * T. The
//     blocks are persistent (as many as stay resident), and each copies
//     its next tile's rows and x0 into shared memory with cp.async (16-byte
//     copies where D * 4 and the pointer allow, 4-byte otherwise) while it
//     computes the current one: (1) each (pixel, level)'s floor and
//     fraction of x0 / 2^l, once; (2) level by level, each (pixel,
//     level)'s band of the 2r + 2 pooled cells its taps read (zero outside
//     [0, D_l), vector shared loads where D allows); (3) a thread per
//     (pixel, tap) lerps two band cells, and the tile's outputs are
//     written as one coalesced span. Indices inside a tile are 32-bit;
//     only the tile's base offsets are 64-bit, and every per-thread index
//     is stepped without a division. The pooling and the lerp follow the
//     formula above term by term (sum in order, then the scale; the lerp
//     as written), the same roundings as a thread per tap would take;
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
// (288 x 400, D = 64) volume moves ~45 MB, ~13.5 us at 3.35 TB/s). The
// tiled forward copies whole rows, cells no tap reaches included, so it
// moves more than the reached-cell bound counts: at the demo's rescale-2
// volume it runs near the rate of a plain read of the volume plus a
// write of the taps.
//
// Exported with a plain C interface (loaded with ctypes). Inputs are
// contiguous fp32; each launch runs on the caller's stream and allocates
// nothing; the return value is cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
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

// Shared memory of a block (J = 2r + 2 band cells, T = L (2r + 1) taps),
// each region at a multiple of 16 bytes; the wrapper's
// lookup_launch_geometry counts the same:
//   taps:  per tap level << 16 | band offset l J + k               4 T
//   rows:  two buffers of a tile's P rows as copied                2 x 4 P D
//   xs:    two buffers of its P x0                                 2 x 4 P
//   pix:   per (pixel, level) {floor(x0 / 2^l) or a sentinel, f}  8 P L
//   band:  per (pixel, level) the J pooled cells from c0 - r       4 P L J
struct FwdLayout {
  long long rows, xs, pix, band, bytes;
};

__host__ __device__ __forceinline__ long long round16(long long n) {
  return (n + 15) & ~15LL;
}

__host__ __device__ __forceinline__ FwdLayout fwd_layout(int P, int D,
                                                         int radius, int L) {
  const long long J = 2 * radius + 2, T = static_cast<long long>(L) * (J - 1);
  FwdLayout f;
  f.rows = round16(4 * T);
  f.xs = round16(f.rows + 2 * 4LL * P * D);
  f.pix = round16(f.xs + 2 * 4LL * P);
  f.band = round16(f.pix + 8LL * P * L);
  f.bytes = round16(f.band + 4LL * P * L * J);
  return f;
}

// |floor(x0 / 2^l)| past this leaves every cell of every level outside
// [0, D_l): the band starts at a sentinel that stays outside
constexpr float kFarCell = 4194304.f;  // 2^22
constexpr int kNoCell = -(1 << 30);

// (i / n, i % n) for the i of one thread's loop, stepped by the block size
// without a division per step
struct Stepper {
  int q, r, dq, dr, n;
  __device__ __forceinline__ Stepper(int i, int n_, int step)
      : q(i / n_), r(i - (i / n_) * n_), dq(step / n_),
        dr(step - (step / n_) * n_), n(n_) {}
  __device__ __forceinline__ void next() {
    q += dq;
    r += dr;
    if (r >= n) {
      r -= n;
      ++q;
    }
  }
};

// start copying tile m0's np rows (one span of np * D floats) and x0
// values into shared memory; one commit group per thread
template <bool kVec4>
__device__ __forceinline__ void copy_tile(float* rows, float* xs,
                                          const float* __restrict__ corr,
                                          const float* __restrict__ x0,
                                          long long m0, int np, int D) {
  const float* src = corr + m0 * D;
  const int n = np * D;
  if (kVec4) {
    for (int j = threadIdx.x; j < n / 4; j += blockDim.x)
      __pipeline_memcpy_async(rows + 4 * j, src + 4 * j, 16);
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      __pipeline_memcpy_async(rows + j, src + j, 4);
  }
  for (int p = threadIdx.x; p < np; p += blockDim.x)
    __pipeline_memcpy_async(xs + p, x0 + m0 + p, 4);
  __pipeline_commit();
}

// persistent blocks of kThreads threads, each over tiles of P pixels
// (blockIdx.x, + gridDim.x, ...): the next tile's copy runs while the
// current one is computed
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
lookup_fwd_kernel(const float* __restrict__ corr,
                  const float* __restrict__ x0, float* __restrict__ out,
                  long long M, int D, int radius, int num_levels, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = num_levels, K = 2 * radius + 1, J = K + 1, T = L * K;
  const FwdLayout lay = fwd_layout(P, D, radius, L);
  int* taps = reinterpret_cast<int*>(smem);
  int2* pix = reinterpret_cast<int2*>(smem + lay.pix);
  float* band = reinterpret_cast<float*>(smem + lay.band);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long tiles = (M + P - 1) / P;
  auto rows_of = [&](int b) {
    return reinterpret_cast<float*>(smem + lay.rows) + b * P * D;
  };
  auto xs_of = [&](int b) {
    return reinterpret_cast<float*>(smem + lay.xs) + b * P;
  };
  auto pixels = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(P), M - tile * P));
  };
  long long tile = blockIdx.x;
  if (tile < tiles)
    copy_tile<kVec4>(rows_of(0), xs_of(0), corr, x0, tile * P, pixels(tile), D);
  for (int t = tid; t < T; t += nt) {
    const int lvl = t / K;
    taps[t] = (lvl << 16) | (t + lvl);  // level, band offset l J + k
  }
  // each loop's first (i / n, i % n), the same for every tile
  const Stepper pl0(tid, L, nt), pj0(tid, J, nt), pt0(tid, T, nt);
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      copy_tile<kVec4>(rows_of(buf ^ 1), xs_of(buf ^ 1), corr, x0, next * P,
                       pixels(next), D);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* rows = rows_of(buf);
    const float* xs = xs_of(buf);
    const int np = pixels(tile);

    // 1. each (pixel, level)'s floor and fraction of q = x0 / 2^l, the
    // division by a power of two taken as the exact product by 2^-l
    {
      Stepper pl = pl0;
      for (int i = tid; i < np * L; i += nt, pl.next()) {
        const float q = xs[pl.q] * __int_as_float((127 - pl.r) << 23);
        const float c0 = floorf(q);
        // a huge or NaN index is never cast: its band reads nothing
        const bool near = c0 >= -kFarCell && c0 <= kFarCell;
        pix[i] = make_int2(near ? static_cast<int>(c0) : kNoCell,
                           __float_as_int(q - c0));
      }
    }
    __syncthreads();

    // 2. the bands, a level at a time: cell c of level l is the sum of its
    // 2^l level-0 cells in order times 1 / 2^l, or 0 outside [0, D_l)
    for (int lvl = 0; lvl < L; ++lvl) {
      const int w = 1 << lvl, Dl = D >> lvl;
      const float inv = __int_as_float((127 - lvl) << 23);
      Stepper pj = pj0;
      for (int i = tid; i < np * J; i += nt, pj.next()) {
        const int c = pix[pj.q * L + lvl].x + pj.r - radius;
        float v = 0.f;
        if (c >= 0 && c < Dl) {
          const float* cell = rows + pj.q * D + c * w;
          float sum = 0.f;
          if (w >= 4 && (D & 3) == 0) {  // 16-byte loads: no bank conflicts
            for (int j = 0; j < w; j += 4) {
              const float4 a = *reinterpret_cast<const float4*>(cell + j);
              sum += a.x;
              sum += a.y;
              sum += a.z;
              sum += a.w;
            }
          } else if (w == 2 && (D & 1) == 0) {
            const float2 a = *reinterpret_cast<const float2*>(cell);
            sum += a.x;
            sum += a.y;
          } else {
            for (int j = 0; j < w; ++j) sum += cell[j];
          }
          v = sum * inv;
        }
        band[(pj.q * L + lvl) * J + pj.r] = v;
      }
    }
    __syncthreads();

    // 3. a thread per (pixel, tap): tap k of level l lerps band cells k and
    // k + 1, and the tile's outputs are one span
    {
      Stepper pt = pt0;
      float* dst = out + tile * P * T;
      for (int i = tid; i < np * T; i += nt, pt.next()) {
        const int tap = taps[pt.r];
        const float f = __int_as_float(pix[pt.q * L + (tap >> 16)].y);
        const float* b = band + pt.q * L * J + (tap & 0xffff);
        dst[i] = (1.f - f) * b[0] + f * b[1];
      }
    }
    __syncthreads();  // pix, band and this buffer are rewritten next
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
// float32; every element is written. P, vec4 and smem_bytes come from the
// wrapper's lookup_launch_geometry: tiles of P pixels, 16-byte row copies
// where vec4 (D % 4 == 0 and corr 16-byte aligned), and smem_bytes =
// fwd_layout(P, D, radius, num_levels).bytes; the launcher refuses others.
int lookup_forward(const float* corr, const float* x0, float* out,
                   long long M, int D, int radius, int num_levels, int P,
                   int vec4, int smem_bytes, void* stream) {
  const long long total = M * num_levels * (2 * radius + 1);
  if (total == 0) return static_cast<int>(cudaGetLastError());
  // a tap record packs its band offset into 16 bits
  if (P < 1 || (vec4 && D % 4 != 0) ||
      static_cast<long long>(num_levels) * (2 * radius + 2) >= 65536 ||
      fwd_layout(P, D, radius, num_levels).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = vec4 ? lookup_fwd_kernel<true> : lookup_fwd_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // as many blocks as stay resident at once, each looping over tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (M + P - 1) / P;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(tiles < resident ? tiles : resident), kThreads,
           smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      corr, x0, out, M, D, radius, num_levels, P);
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
