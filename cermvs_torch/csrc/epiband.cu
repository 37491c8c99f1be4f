// Rectified epipolar band resample ("epiband") for Hopper (sm_90a): the
// forward and its two backward kernels.
//
// Forward. Replaces the TPU kernels of the JAX package's ops/pallas/epiband.py
// reached from _epiband_fwd_impl: _epiband_kernel (dynamic base),
// _epiband_kernel_static (base == 0) and _epiband_kernel_chunked
// (hypothesis-chunked windows). One kernel covers all three: for each view v,
// rect row y, pixel x and hypothesis k
//
//   pos      = (x + s_max) - (base[v,y,x] + k * sigma[v,y,x])
//   G(s)     = <fr[v,y,x,:], fs[v,y,s,:]>                 (fp32 accumulate)
//   out[k]   = (1 - f) * G(i0) * [0 <= i0 <= ws-1] + f * G(i0+1) * [0 <= i0+1 <= ws-1]
//
// with i0 = floor(pos), f = pos - i0: linear interpolation along the source
// row with each tap zeroed outside [0, ws-1] (the oracle is
// corr_rectified._resample_rows_oracle). base may be null (stage 0: base == 0).
//
// What bounds it on this card. Per output the two taps cost 2*C multiply-adds
// (4*C flops); the bytes the function must move are fr and the fs columns
// the slabs reach read once and the fp32 volume written once, e.g. for the
// widest stage-0 view of the DTU slice (h_r x w_r = 512 x 512, ws = 1104,
// C = 64, D = 64, bf16 features) about 0.16 GB against 4.3 GFLOP:
// 27 flop/byte, far below the ~295 flop/byte
// ridge, so the least time is set by the bytes. The TPU kernels built a full
// G tile on the MXU and selected the band with barrel rolls and hat-matrix
// segment sums because Mosaic cannot gather; a GPU gathers from L1, so this
// kernel computes only the 2*D dot products each pixel needs.
//
// Design. One warp per rect pixel (8 pixels per block), one channel pair per
// lane (C <= 64, the model's feature width): the pixel's fr row is held in registers, and for every hypothesis
// the warp reads the two source rows as coalesced 4-byte (bf16x2) or 8-byte
// (float2) lane loads, forms the interpolated dot product lane-wise, and
// reduces it with a butterfly of warp shuffles. Neighbouring pixels and
// hypotheses read the same source rows, which L1/L2 can serve instead of
// device memory; G never exists in memory. Lane j keeps the result of hypothesis k0 + j so each group of
// 32 hypotheses leaves as one coalesced store. What limits it is the per-
// output instruction count (two row loads, the shuffle reduction), not the
// bytes; a tensor-core G tile (wgmma on a TMA-staged source band) is the
// path to the byte bound.
//
// Backward. Replaces the kernels reached from _epiband_bwd_impl
// (_epiband_bwd_kernel, _epiband_bwd_kernel_chunked,
// _epiband_bwd_kernel_static, with _d_window): given dout (V,h_r,w_r,D) fp32
//
//   dfr[v,y,x,:] = sum_k dout[k] * ((1-f) ok0 fs[i0] + f ok1 fs[i0+1])
//   dfs[v,y,s,:] = sum_{x,k} dout[x,k] * hat-weight(x,k,s) * fr[v,y,x,:]
//
// with the forward's positions, recomputed in its rounding order. base and
// sigma get no gradient. The TPU kernels formed dG with segment matmuls over
// static windows and accumulated dfs in a VMEM block revisited by the grid;
// here both walk a pixel's taps directly and form dG one column at a time
// in registers (for_each_column), rounding to bf16 where the TPU kernels do
// for bf16 features: dout, each tap's weight * dout, and dG. epiband_bwd_dfr
// is the forward's warp-per-pixel loop without the shuffle reduction (each
// lane accumulates dG[c] * fs[c] for its channel pair and stores it once, in
// the features' type); where no column has two taps it skips the column
// walk, whose bookkeeping about doubles its time. epiband_bwd_dfs scatters
// dG[c] * fr into a zeroed fp32 (V,h_r,ws,C) buffer with global atomics,
// one per column, pixel and channel. A source row (ws x C x 4 B = 282 KB at
// ws = 1104, C = 64) does not fit in shared memory, so the sums meet in L2.
// Both move the same bytes
// as the forward plus dout (V,h_r,w_r,D) fp32 read once and the gradient
// written once: bound by bytes, like the forward; the atomics' L2 round
// trips, not the bytes, limit epiband_bwd_dfs. Its sums meet in an order
// that changes from run to run.
//
// Exported with a plain C interface (loaded with ctypes). Each launch runs on
// the caller's stream and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rect pixels per block

__device__ __forceinline__ float2 load_pair(const float* p, int i) {
  return __ldg(reinterpret_cast<const float2*>(p) + i);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, int i) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p) + i));
}

// lane j holds channel pair j (C <= 64)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
epiband_kernel(const T* __restrict__ fr, const T* __restrict__ fs,
               const float* __restrict__ base, const float* __restrict__ sigma,
               float* __restrict__ out, int h_r, int w_r, int ws, int C, int D,
               float s_max) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int y = blockIdx.y;
  const int v = blockIdx.z;
  if (x >= w_r) return;  // whole warp leaves together
  const bool has = lane < (C >> 1);
  const size_t row = static_cast<size_t>(v) * h_r + y;
  const size_t pix = row * w_r + x;

  const float2 a = has ? load_pair(fr + pix * C, lane) : make_float2(0.f, 0.f);
  const float b = base != nullptr ? base[pix] : 0.f;
  const float sg = sigma[pix];
  // rounded separately, in the oracle's order (no fused multiply-add)
  const float xs = __fadd_rn(static_cast<float>(x), s_max);
  const T* src = fs + row * static_cast<size_t>(ws) * C;
  const float last = static_cast<float>(ws - 1);
  float* dst = out + pix * D;

  for (int k0 = 0; k0 < D; k0 += 32) {
    const int n = min(32, D - k0);
    float mine = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float kf = static_cast<float>(k0 + j);
      const float pos = __fsub_rn(xs, __fadd_rn(b, __fmul_rn(sg, kf)));
      const float fl = floorf(pos);
      const float f = __fsub_rn(pos, fl);
      const bool ok0 = fl >= 0.f && fl <= last;
      const bool ok1 = fl >= -1.f && fl <= last - 1.f;
      float part = 0.f;
      if ((ok0 || ok1) && has) {  // ok0/ok1 are uniform across the warp
        const int i0 = static_cast<int>(fl);
        float d0 = 0.f, d1 = 0.f;
        if (ok0) {
          const float2 s = load_pair(src + static_cast<size_t>(i0) * C, lane);
          d0 = a.x * s.x + a.y * s.y;
        }
        if (ok1) {
          const float2 s = load_pair(src + static_cast<size_t>(i0 + 1) * C, lane);
          d1 = a.x * s.x + a.y * s.y;
        }
        part = (ok0 ? 1.f - f : 0.f) * d0 + (ok1 ? f : 0.f) * d1;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == j) mine = part;
    }
    if (lane < n) dst[k0 + lane] = mine;
  }
}

// the forward's tap positions, in its rounding order (no fused multiply-add)
struct Taps {
  int i0;
  float f;
  bool ok0, ok1;
};

__device__ __forceinline__ Taps taps_at(float xs, float b, float sg, int k,
                                        float last) {
  const float pos = __fsub_rn(xs, __fadd_rn(b, __fmul_rn(sg, static_cast<float>(k))));
  const float fl = floorf(pos);
  Taps t;
  t.f = __fsub_rn(pos, fl);
  t.ok0 = fl >= 0.f && fl <= last;
  t.ok1 = fl >= -1.f && fl <= last - 1.f;
  t.i0 = (t.ok0 || t.ok1) ? static_cast<int>(fl) : 0;
  return t;
}

__device__ __forceinline__ void store_pair(float* p, int i, float2 v) {
  reinterpret_cast<float2*>(p)[i] = v;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int i, float2 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[i] = __floats2bfloat162_rn(v.x, v.y);
}

// The value as the features' type rounds it, widened back to fp32 (bf16
// values are exact in fp32); the identity for fp32 features.
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
constexpr bool kRounds = false;
template <>
constexpr bool kRounds<__nv_bfloat16> = true;

// sigma from which no two hypotheses' taps share a column: consecutive
// positions are then at least 2.5 columns apart (less their fp32 rounding,
// ~1e-4 at these row widths), so their floors differ by 2 or more
constexpr float kOneTapPerColumn = 2.5f;

// tap weights round((1 - f) * dout) and round(f * dout), in that order
template <typename T>
__device__ __forceinline__ float2 tap_weights(const Taps& t, float gk) {
  return make_float2(round_as<T>(__fmul_rn(__fsub_rn(1.f, t.f), gk)),
                     round_as<T>(__fmul_rn(t.f, gk)));
}

// One pixel's dG row, column by column: emit(c, dG[c]) once for every column
// c that an in-band tap reaches, with
//
//   dG[c] = round(sum_k round(weight_k(c) * round(dout[k])))
//
// (round: to the features' type, as the JAX package's backward kernels
// round dout, the hat-weighted products and dG for bf16 features; sums in
// fp32). The taps move left along the row as k grows (sigma >= 0, a rate
// times a step), so each column's taps are consecutive in this walk: two open
// columns (c_old, c_new) hold the running sums, and a column is emitted
// when a tap lands on a third. The walk is uniform across the warp; dout is
// read with one coalesced load per 32 hypotheses.
template <typename T, typename Emit>
__device__ __forceinline__ void for_each_column(const float* g, int D,
                                                float xs, float b, float sg,
                                                float last, int lane,
                                                Emit emit) {
  int c_old = -1, c_new = -1;
  float acc_old = 0.f, acc_new = 0.f;
  auto put = [&](int c, float w) {
    if (c == c_new) {
      acc_new += w;
    } else if (c == c_old) {
      acc_old += w;
    } else {
      if (c_old >= 0) emit(c_old, round_as<T>(acc_old));
      c_old = c_new;
      acc_old = acc_new;
      c_new = c;
      acc_new = w;
    }
  };
  for (int k0 = 0; k0 < D; k0 += 32) {
    const int n = min(32, D - k0);
    const float gl = lane < n ? round_as<T>(g[k0 + lane]) : 0.f;
    for (int j = 0; j < n; ++j) {
      const float gk = __shfl_sync(0xffffffffu, gl, j);
      const Taps t = taps_at(xs, b, sg, k0 + j, last);
      const float2 w = tap_weights<T>(t, gk);
      // the right tap first: as k grows the taps move left
      if (t.ok1) put(t.i0 + 1, w.y);
      if (t.ok0) put(t.i0, w.x);
    }
  }
  if (c_old >= 0) emit(c_old, round_as<T>(acc_old));
  if (c_new >= 0) emit(c_new, round_as<T>(acc_new));
}

// dfr: one warp per rect pixel, lane j accumulates channel pair j of
// dG[c] * fs[c] over the pixel's columns. Where nothing is rounded (fp32) or
// no column has two taps (sigma >= kOneTapPerColumn: stage 0), dG[c] is a
// single tap's weight or a plain sum, and the loop adds tap by tap as the
// forward reads them, without the column walk's bookkeeping.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
epiband_bwd_dfr_kernel(const T* __restrict__ fs, const float* __restrict__ base,
                       const float* __restrict__ sigma,
                       const float* __restrict__ dout, T* __restrict__ dfr,
                       int h_r, int w_r, int ws, int C, int D, float s_max) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int y = blockIdx.y;
  const int v = blockIdx.z;
  if (x >= w_r) return;  // whole warp leaves together
  const bool has = lane < (C >> 1);
  const size_t row = static_cast<size_t>(v) * h_r + y;
  const size_t pix = row * w_r + x;
  const float b = base != nullptr ? base[pix] : 0.f;
  const float sg = sigma[pix];
  const float xs = __fadd_rn(static_cast<float>(x), s_max);
  const T* src = fs + row * static_cast<size_t>(ws) * C;
  const float last = static_cast<float>(ws - 1);
  const float* g = dout + pix * D;

  float2 acc = make_float2(0.f, 0.f);
  auto add = [&](int c, float w) {
    const float2 s = load_pair(src + static_cast<size_t>(c) * C, lane);
    acc.x += w * s.x;
    acc.y += w * s.y;
  };
  if (!kRounds<T> || sg >= kOneTapPerColumn) {
    for (int k0 = 0; k0 < D; k0 += 32) {
      const int n = min(32, D - k0);
      const float gl = lane < n ? round_as<T>(g[k0 + lane]) : 0.f;
      for (int j = 0; j < n; ++j) {
        const float gk = __shfl_sync(0xffffffffu, gl, j);
        const Taps t = taps_at(xs, b, sg, k0 + j, last);
        const float2 w = tap_weights<T>(t, gk);
        if (has && t.ok0) add(t.i0, w.x);
        if (has && t.ok1) add(t.i0 + 1, w.y);
      }
    }
  } else {
    for_each_column<T>(g, D, xs, b, sg, last, lane, [&](int c, float w) {
      if (has) add(c, w);
    });
  }
  if (has) store_pair(dfr + pix * C, lane, acc);
}

// dfs: one warp per rect pixel scatters dG[c] * fr[pixel] into each of its
// columns, lane j channel pair j
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
epiband_bwd_dfs_kernel(const T* __restrict__ fr, const float* __restrict__ base,
                       const float* __restrict__ sigma,
                       const float* __restrict__ dout, float* __restrict__ dfs,
                       int h_r, int w_r, int ws, int C, int D, float s_max) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int y = blockIdx.y;
  const int v = blockIdx.z;
  if (x >= w_r) return;
  const bool has = lane < (C >> 1);
  const size_t row = static_cast<size_t>(v) * h_r + y;
  const size_t pix = row * w_r + x;
  const float2 a = has ? load_pair(fr + pix * C, lane) : make_float2(0.f, 0.f);
  const float b = base != nullptr ? base[pix] : 0.f;
  const float xs = __fadd_rn(static_cast<float>(x), s_max);
  float* dst = dfs + row * static_cast<size_t>(ws) * C + 2 * lane;

  for_each_column<T>(dout + pix * D, D, xs, b, sigma[pix],
                     static_cast<float>(ws - 1), lane, [&](int c, float w) {
    if (has) {
      atomicAdd(dst + static_cast<size_t>(c) * C, w * a.x);
      atomicAdd(dst + static_cast<size_t>(c) * C + 1, w * a.y);
    }
  });
}

template <typename T>
void launch(const void* fr, const void* fs, const float* base,
            const float* sigma, float* out, int V, int h_r, int w_r, int ws,
            int C, int D, int s_max, cudaStream_t stream) {
  const dim3 grid((w_r + kWarps - 1) / kWarps, h_r, V);
  const dim3 block(kWarps * 32);
  epiband_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(fr), static_cast<const T*>(fs), base, sigma, out,
      h_r, w_r, ws, C, D, static_cast<float>(s_max));
}

}  // namespace

extern "C" {

// dtype: 0 = float32 features, 1 = bfloat16 features. C must be even and at
// most 64, and fr/fs aligned to two elements (checked by the Python
// wrapper). Returns a cudaError_t value.
int epiband_forward(const void* fr, const void* fs, const float* base,
                    const float* sigma, float* out, int V, int h_r, int w_r,
                    int ws, int C, int D, int s_max, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(fr, fs, base, sigma, out, V, h_r, w_r, ws, C, D, s_max, st);
  else
    launch<float>(fr, fs, base, sigma, out, V, h_r, w_r, ws, C, D, s_max, st);
  return static_cast<int>(cudaGetLastError());
}

// dfr (V,h_r,w_r,C) in the features' type; every element is written.
int epiband_backward_dfr(const void* fs, const float* base, const float* sigma,
                         const float* dout, void* dfr, int V, int h_r,
                         int w_r, int ws, int C, int D, int s_max, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w_r + kWarps - 1) / kWarps, h_r, V);
  const dim3 block(kWarps * 32);
  const float sm = static_cast<float>(s_max);
  if (dtype == 1)
    epiband_bwd_dfr_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(fs), base, sigma, dout,
        static_cast<__nv_bfloat16*>(dfr), h_r, w_r, ws, C, D, sm);
  else
    epiband_bwd_dfr_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(fs), base, sigma, dout,
        static_cast<float*>(dfr), h_r, w_r, ws, C, D, sm);
  return static_cast<int>(cudaGetLastError());
}

// dfs (V,h_r,ws,C) fp32, accumulated into: the caller zeroes it.
int epiband_backward_dfs(const void* fr, const float* base, const float* sigma,
                         const float* dout, float* dfs, int V, int h_r,
                         int w_r, int ws, int C, int D, int s_max, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w_r + kWarps - 1) / kWarps, h_r, V);
  const dim3 block(kWarps * 32);
  const float sm = static_cast<float>(s_max);
  if (dtype == 1)
    epiband_bwd_dfs_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(fr), base, sigma, dout, dfs, h_r,
        w_r, ws, C, D, sm);
  else
    epiband_bwd_dfs_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(fr), base, sigma, dout, dfs, h_r, w_r, ws,
        C, D, sm);
  return static_cast<int>(cudaGetLastError());
}

const char* epiband_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
