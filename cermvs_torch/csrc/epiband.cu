// Rectified epipolar band resample ("epiband") for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's ops/pallas/epiband.py:
// _epiband_kernel (dynamic base), _epiband_kernel_static (base == 0) and
// _epiband_kernel_chunked (hypothesis-chunked windows). One kernel covers
// all three: for each view v, rect row y, pixel x and hypothesis k
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
// Exported with a plain C interface (loaded with ctypes). The launch runs on
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

const char* epiband_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
