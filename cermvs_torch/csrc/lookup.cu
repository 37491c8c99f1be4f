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
// cells a tap needs, and a thread per output that does so from global
// memory spends index divisions, reloads of x0, divisions of x0 and
// scattered loads on what is a copy of a few floats per pixel. So all
// three kernels work on tiles of P consecutive pixels, whose input rows
// are one span of P * W floats (W = D, or T taps for the gradient) and
// whose outputs one span. The blocks are persistent (as many as stay
// resident), and each copies its next tile's rows and x0 into shared
// memory with cp.async (16-byte copies where the span and the pointer
// allow, 4-byte otherwise) while it computes the current one. Indices
// inside a tile are 32-bit; only the tile's base offsets are 64-bit, and
// every per-thread index is stepped without a division.
//
//   * forward and prefix-sum variant, one kernel template
//     (lookup_tile_kernel): (1) each (pixel, level)'s floor and fraction of
//     x0 / 2^l, once; (2) level by level, each (pixel, level)'s band of the
//     2r + 2 pooled cells its taps read (zero outside [0, D_l), vector
//     shared loads where D allows); (3) a thread per (pixel, tap) lerps two
//     band cells, and the tile's outputs are written as one coalesced
//     span. The two differ only in how a band cell is pooled. The forward
//     sums the cell's 2^l level-0 cells in order, then scales, as the
//     formula above reads. The prefix-sum variant (D <= 128) first turns
//     each row into inclusive prefix sums in place (a warp per pixel, four
//     consecutive cells per lane summed in order, then a shuffle scan over
//     the lanes' totals), and a pooled cell is the boundary difference
//     (S[(i+1)*2^l - 1] - S[i*2^l - 1]) / 2^l with S[-1] = 0. The
//     differences lose low bits to cancellation, as the TPU kernel's do
//     (~1e-4 relative against pooling in order). In place, the variant
//     needs no shared memory beyond the forward's;
//   * backward (lookup_bwd_kernel): a gather. The tile's tap gradients
//     g[m, 0..T) are staged; (1) each (pixel, level)'s record {floor(x0 /
//     2^l), (1 - f) / 2^l, f / 2^l}, once; (2) a thread per (pixel, group
//     of 4 consecutive cells, or 1 where D % 4 != 0): at level l the cell's
//     pooled cell ci = j >> l is read by at most two taps, k1 = ci - c0 + r
//     with the first weight and k1 - 1 with the second, integer indices
//     into the staged row. Each group is written once from registers, 16
//     bytes at a time where the output allows; no atomics.
//
// Every kernel takes the roundings of a thread per output computing the
// formula term by term: floor and fraction of x0 times 2^-l (the exact
// quotient), the weights (1 - f) * 2^-l and f * 2^-l, the adds of each
// output in level order, first tap before second, each an fma, and the
// prefix sums in the order given. Huge or NaN indices are never cast to
// int: their records hold a sentinel whose cells lie outside every level.
//
// What bounds them on this card. Per pixel the forward reads D + 1 floats
// and writes 33, the gradient reads 34 and writes D, with a few
// operations per value: far below the flop/byte ridge, so the bytes bound
// all three (the forward at the main path's (288 x 400, D = 64) volume
// moves ~45 MB, ~13.5 us at 3.35 TB/s; the gradient at the training
// batch's (2 x 264 x 360, D = 64) ~75 MB, ~22 us). The forward tiles copy
// whole rows, cells no tap reaches included, so they move more than the
// reached-cell bound counts; the gradient writes every cell, as its bound
// counts.
//
// Exported with a plain C interface (loaded with ctypes). Inputs are
// contiguous fp32; each launch runs on the caller's stream and allocates
// nothing; the return value is cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 128;  // prefix-sum variant: four cells per lane

__host__ __device__ __forceinline__ long long round16(long long n) {
  return (n + 15) & ~15LL;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Shared memory of a forward or prefix-sum block (J = 2r + 2 band cells,
// T = L (2r + 1) taps), each region at a multiple of 16 bytes; the
// wrapper's forward_smem_bytes counts the same:
//   taps:  per tap level << 16 | band offset l J + k               4 T
//   rows:  two buffers of a tile's P rows as copied                2 x 4 P D
//   xs:    two buffers of its P x0                                 2 x 4 P
//   pix:   per (pixel, level) {floor(x0 / 2^l) or a sentinel, f}  8 P L
//   band:  per (pixel, level) the J pooled cells from c0 - r       4 P L J
struct FwdLayout {
  long long rows, xs, pix, band, bytes;
};

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

// Shared memory of a gradient block; the wrapper's backward_smem_bytes
// counts the same:
//   gs:   two buffers of a tile's P tap-gradient rows as copied   2 x 4 P T
//   xs:   two buffers of its P x0                                 2 x 4 P
//   rec:  per (pixel, level) {floor(x0 / 2^l) or a sentinel,
//         (1 - f) / 2^l, f / 2^l, unused}                         16 P L
struct BwdLayout {
  long long xs, rec, bytes;
};

__host__ __device__ __forceinline__ BwdLayout bwd_layout(int P, int radius,
                                                         int L) {
  const long long T = static_cast<long long>(L) * (2 * radius + 1);
  BwdLayout b;
  b.xs = round16(2 * 4LL * P * T);
  b.rec = round16(b.xs + 2 * 4LL * P);
  b.bytes = round16(b.rec + 16LL * P * L);
  return b;
}

// |floor(x0 / 2^l)| past this leaves every cell of every level outside
// [0, D_l): a record holds a sentinel that stays outside
constexpr float kFarCell = 4194304.f;  // 2^22
constexpr int kNoCell = -(1 << 30);

// 2^-l, exact
__device__ __forceinline__ float pow2_neg(int l) {
  return __int_as_float((127 - l) << 23);
}

// floor(q) as an int; a huge or NaN floor is never cast
__device__ __forceinline__ int cell_of(float c0) {
  return c0 >= -kFarCell && c0 <= kFarCell ? static_cast<int>(c0) : kNoCell;
}

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

// start copying tile m0's np rows of W floats (one span) and x0 values
// into shared memory; one commit group per thread. kVec4: 16-byte copies,
// the span's base 16-byte aligned (a ragged tail goes 4 bytes at a time)
template <bool kVec4>
__device__ __forceinline__ void copy_tile(float* rows, float* xs,
                                          const float* __restrict__ src,
                                          const float* __restrict__ x0,
                                          long long m0, int np, int W) {
  const float* from = src + m0 * W;
  const int n = np * W;
  int tail = 0;
  if (kVec4) {
    for (int j = threadIdx.x; j < n / 4; j += blockDim.x)
      __pipeline_memcpy_async(rows + 4 * j, from + 4 * j, 16);
    tail = n & ~3;
  }
  for (int j = tail + threadIdx.x; j < n; j += blockDim.x)
    __pipeline_memcpy_async(rows + j, from + j, 4);
  for (int p = threadIdx.x; p < np; p += blockDim.x)
    __pipeline_memcpy_async(xs + p, x0 + m0 + p, 4);
  __pipeline_commit();
}

// Turn each of the tile's np rows of D <= 128 cells into its inclusive
// prefix sums, in place: a warp per pixel, a lane's four consecutive
// cells summed in order (cells past D add 0), an inclusive shuffle scan
// over the lanes' totals, then each prefix the lane's exclusive total plus
// its running sum.
__device__ __forceinline__ void prefix_rows(float* rows, int np, int D) {
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < np; p += blockDim.x >> 5) {
    float* row = rows + p * D;
    float v[4];
    float run = 0.f;
    const bool vec = (D & 3) == 0;  // 16-byte loads: no bank conflicts
    if (vec) {
      const float4 a = 4 * lane < D
                           ? *reinterpret_cast<const float4*>(row + 4 * lane)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      run += a.x;
      v[0] = run;
      run += a.y;
      v[1] = run;
      run += a.z;
      v[2] = run;
      run += a.w;
      v[3] = run;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = lane * 4 + e;
        run += j < D ? row[j] : 0.f;
        v[e] = run;
      }
    }
    float incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (vec) {
      if (4 * lane < D)
        *reinterpret_cast<float4*>(row + 4 * lane) =
            make_float4(excl + v[0], excl + v[1], excl + v[2], excl + v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = lane * 4 + e;
        if (j < D) row[j] = excl + v[e];
      }
    }
  }
}

// persistent blocks of kThreads threads, each over tiles of P pixels
// (blockIdx.x, + gridDim.x, ...): the next tile's copy runs while the
// current one is computed. kPrefix: the prefix-sum variant
template <bool kVec4, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
lookup_tile_kernel(const float* __restrict__ corr,
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
    float* rows = rows_of(buf);
    const float* xs = xs_of(buf);
    const int np = pixels(tile);

    // 0. the prefix-sum variant pools from prefix sums
    if (kPrefix) prefix_rows(rows, np, D);

    // 1. each (pixel, level)'s floor and fraction of q = x0 / 2^l, the
    // division by a power of two taken as the exact product by 2^-l
    {
      Stepper pl = pl0;
      for (int i = tid; i < np * L; i += nt, pl.next()) {
        const float q = xs[pl.q] * pow2_neg(pl.r);
        const float c0 = floorf(q);
        pix[i] = make_int2(cell_of(c0), __float_as_int(q - c0));
      }
    }
    __syncthreads();

    // 2. the bands, a level at a time: cell c of level l is the sum of its
    // 2^l level-0 cells in order times 1 / 2^l (or the difference of the
    // prefix sums around them times 1 / 2^l), or 0 outside [0, D_l)
    for (int lvl = 0; lvl < L; ++lvl) {
      const int w = 1 << lvl, Dl = D >> lvl;
      const float inv = pow2_neg(lvl);
      Stepper pj = pj0;
      for (int i = tid; i < np * J; i += nt, pj.next()) {
        const int c = pix[pj.q * L + lvl].x + pj.r - radius;
        float v = 0.f;
        if (c >= 0 && c < Dl) {
          const float* cell = rows + pj.q * D + c * w;
          if (kPrefix) {
            v = (cell[w - 1] - (c > 0 ? cell[-1] : 0.f)) * inv;
          } else {
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

// cells [E0, E1) of a gradient thread's group lie in pooled cell ci of a
// level (base = r - floor(x0 / 2^l)): tap k1 = ci + base reads ci first
// (weight w1), tap k1 - 1 second (weight w2); each cell adds them in that
// order, if ci is whole (ci < D_l) and the tap exists
template <int E0, int E1, int N>
__device__ __forceinline__ void add_taps(float (&acc)[N], const float* gl,
                                         int ci, int Dl, int base, int K,
                                         float w1, float w2) {
  if (ci >= Dl) return;
  const int k1 = ci + base;
  if (static_cast<unsigned>(k1) < static_cast<unsigned>(K)) {
    const float a = gl[k1];
#pragma unroll
    for (int e = E0; e < E1; ++e) acc[e] += a * w1;
  }
  if (static_cast<unsigned>(k1 - 1) < static_cast<unsigned>(K)) {
    const float b = gl[k1 - 1];
#pragma unroll
    for (int e = E0; e < E1; ++e) acc[e] += b * w2;
  }
}

// persistent blocks over tiles of P pixels, as lookup_tile_kernel; a
// thread per (pixel, group of kCells consecutive cells). kCells = 4 stores
// 16 bytes (D % 4 == 0, dcorr 16-byte aligned)
template <bool kVec4, int kCells>
__global__ void __launch_bounds__(kThreads)
lookup_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x0,
                  float* __restrict__ dcorr, long long M, int D, int radius,
                  int num_levels, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = num_levels, K = 2 * radius + 1, T = L * K, G = D / kCells;
  const BwdLayout lay = bwd_layout(P, radius, L);
  float4* rec = reinterpret_cast<float4*>(smem + lay.rec);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long tiles = (M + P - 1) / P;
  auto gs_of = [&](int b) {
    return reinterpret_cast<float*>(smem) + b * P * T;
  };
  auto xs_of = [&](int b) {
    return reinterpret_cast<float*>(smem + lay.xs) + b * P;
  };
  auto pixels = [&](long long tile) {
    return static_cast<int>(min(static_cast<long long>(P), M - tile * P));
  };
  long long tile = blockIdx.x;
  if (tile < tiles)
    copy_tile<kVec4>(gs_of(0), xs_of(0), g, x0, tile * P, pixels(tile), T);
  const Stepper pl0(tid, L, nt), pc0(tid, G, nt);
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      copy_tile<kVec4>(gs_of(buf ^ 1), xs_of(buf ^ 1), g, x0, next * P,
                       pixels(next), T);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* gs = gs_of(buf);
    const float* xs = xs_of(buf);
    const int np = pixels(tile);

    // 1. each (pixel, level)'s record: the floor of q = x0 / 2^l and the
    // weights of its two taps, (1 - f) / 2^l and f / 2^l
    {
      Stepper pl = pl0;
      for (int i = tid; i < np * L; i += nt, pl.next()) {
        const float inv = pow2_neg(pl.r);
        const float q = xs[pl.q] * inv;
        const float c0 = floorf(q), f = q - c0;
        rec[i] = make_float4(__int_as_float(cell_of(c0)), (1.f - f) * inv,
                             f * inv, 0.f);
      }
    }
    __syncthreads();

    // 2. a thread per (pixel, group of cells): at level l, cell j's pooled
    // cell ci = j >> l (if whole, ci < D_l) is tap k1 = ci - c0 + r's first
    // cell and tap k1 - 1's second; the adds in level order, first tap
    // first, each tap loaded once for the cells that share it
    {
      Stepper pc = pc0;
      float* dst = dcorr + tile * P * D;
      for (int i = tid; i < np * G; i += nt, pc.next()) {
        const int j0 = pc.r * kCells;
        const float* gl = gs + pc.q * T;
        const float4* rp = rec + pc.q * L;
        float acc[kCells];
#pragma unroll
        for (int e = 0; e < kCells; ++e) acc[e] = 0.f;
        for (int lvl = 0; lvl < L; ++lvl, gl += K) {
          const float4 r = rp[lvl];
          const int base = radius - __float_as_int(r.x), Dl = D >> lvl;
          // j0 % 4 == 0: a group's cells share pooled cells from level 1 on
          if constexpr (kCells == 4) {
            if (lvl == 0) {
              add_taps<0, 1>(acc, gl, j0, Dl, base, K, r.y, r.z);
              add_taps<1, 2>(acc, gl, j0 + 1, Dl, base, K, r.y, r.z);
              add_taps<2, 3>(acc, gl, j0 + 2, Dl, base, K, r.y, r.z);
              add_taps<3, 4>(acc, gl, j0 + 3, Dl, base, K, r.y, r.z);
            } else if (lvl == 1) {
              add_taps<0, 2>(acc, gl, j0 >> 1, Dl, base, K, r.y, r.z);
              add_taps<2, 4>(acc, gl, (j0 >> 1) + 1, Dl, base, K, r.y, r.z);
            } else {
              add_taps<0, 4>(acc, gl, j0 >> lvl, Dl, base, K, r.y, r.z);
            }
          } else {
            add_taps<0, 1>(acc, gl, j0 >> lvl, Dl, base, K, r.y, r.z);
          }
        }
        if constexpr (kCells == 4)  // i * 4 = pixel * D + j0
          *reinterpret_cast<float4*>(dst + 4 * i) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        else
          dst[i] = acc[0];
      }
    }
    __syncthreads();  // rec and this buffer are rewritten next
  }
}

// as many blocks of `kernel` as stay resident at once (at most one per
// tile), each looping over tiles
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, long long M, int P, int smem_bytes,
                      void* stream, Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (M + P - 1) / P;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(tiles < resident ? tiles : resident), kThreads,
           smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the forward (kPrefix false) or the prefix-sum variant
template <bool kPrefix>
int launch_tiles(const float* corr, const float* x0, float* out, long long M,
                 int D, int radius, int num_levels, int P, int vec4,
                 int smem_bytes, void* stream) {
  if (M == 0) return static_cast<int>(cudaGetLastError());
  // a tap record packs its band offset into 16 bits
  if (P < 1 || (vec4 && (D % 4 != 0 || !aligned16(corr))) ||
      (kPrefix && D > kMaxD) ||
      static_cast<long long>(num_levels) * (2 * radius + 2) >= 65536 ||
      fwd_layout(P, D, radius, num_levels).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return vec4 ? launch_persistent(lookup_tile_kernel<true, kPrefix>, M, P,
                                  smem_bytes, stream, corr, x0, out, M, D,
                                  radius, num_levels, P)
              : launch_persistent(lookup_tile_kernel<false, kPrefix>, M, P,
                                  smem_bytes, stream, corr, x0, out, M, D,
                                  radius, num_levels, P);
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
  return launch_tiles<false>(corr, x0, out, M, D, radius, num_levels, P,
                             vec4, smem_bytes, stream);
}

// the prefix-sum variant of lookup_forward, at the forward's geometry;
// D <= 128
int lookup_v2_forward(const float* corr, const float* x0, float* out,
                      long long M, int D, int radius, int num_levels, int P,
                      int vec4, int smem_bytes, void* stream) {
  return launch_tiles<true>(corr, x0, out, M, D, radius, num_levels, P, vec4,
                            smem_bytes, stream);
}

// g (M, num_levels*(2*radius+1)) float32, x0 (M) float32 -> dcorr (M,D)
// float32; every element is written. P, vec4, cells and smem_bytes come
// from the wrapper's backward_launch_geometry: tiles of P pixels, 16-byte
// copies of g where vec4 (g 16-byte aligned, P * T % 4 == 0), 4 cells a
// thread and 16-byte stores where cells == 4 (D % 4 == 0, dcorr 16-byte
// aligned), and smem_bytes = bwd_layout(P, radius, num_levels).bytes; the
// launcher refuses others.
int lookup_backward(const float* g, const float* x0, float* dcorr,
                    long long M, int D, int radius, int num_levels, int P,
                    int vec4, int cells, int smem_bytes, void* stream) {
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const long long T = static_cast<long long>(num_levels) * (2 * radius + 1);
  if (P < 1 || (vec4 && (P * T % 4 != 0 || !aligned16(g))) ||
      (cells != 1 && cells != 4) ||
      (cells == 4 && (D % 4 != 0 || !aligned16(dcorr))) ||
      bwd_layout(P, radius, num_levels).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      cells == 4
          ? (vec4 ? lookup_bwd_kernel<true, 4> : lookup_bwd_kernel<false, 4>)
          : (vec4 ? lookup_bwd_kernel<true, 1> : lookup_bwd_kernel<false, 1>);
  return launch_persistent(kernel, M, P, smem_bytes, stream, g, x0, dcorr, M,
                           D, radius, num_levels, P);
}

const char* lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
