// 1-D hat resample along rows ("hat_rows") for Hopper (sm_90a): the two
// passes of the two-pass homography warp and their transposes.
//
// Replaces the TPU kernels of the JAX package's ops/pallas/hatwarp.py:
// _hat_kernel (reached from _hat_fwd) and _hat_kernel_t (reached from
// _hat_vjp_bwd). For img (R,S,C) and pos (R,O)
//
//   out[r,o,c]  = sum_s hat(s - pos[r,o]) * img[r,s,c]          (fp32)
//   dimg[r,s,c] = sum_o hat(s - pos[r,o]) * dout[r,o,c]
//
// with hat(d) = max(0, 1 - |d|). The TPU kernels built the full (O x S) hat
// tile in VMEM and fed it to the MXU, because Mosaic cannot gather; almost
// all of that tile is zero: a hat of width 1 has at most two non-zero taps,
// s0 = floor(pos) and s0 + 1. These kernels compute the same function from
// those two taps, each zeroed outside [0, S-1]: the full-row product only
// adds zeros. Numerics follow the TPU kernels: the weight is formed as
// max(0, 1 - |s - pos|) in fp32, rounded to bf16 for a bf16 image (and, in
// the transpose, dout too), products and sums in fp32.
//
// What bounds them on this card. Per output element two multiply-adds
// against one 4-byte store and two 2- or 4-byte reads (mostly L1/L2 hits:
// neighbouring outputs read neighbouring source columns): far below the
// flop/byte ridge, so the bytes bound them: img and pos read once, out
// written once. The transpose scatters each (r,o,c) into two fp32 cells of
// a zeroed (R,S,C) buffer with global atomics; a warp's 32 lanes hit 32
// neighbouring channels of one cell, and a source column receives about
// O/S outputs' taps, so contention is low. The sums meet in an order that
// changes from run to run.
//
// Design. One thread per output element (r,o,c), c fastest, so a warp's
// loads and stores are coalesced along the channels; a grid-stride loop
// over the R*O*C elements. The hat tensors of the matrix-product
// formulation never exist in device memory, and autograd saves only pos.
//
// Exported with a plain C interface (loaded with ctypes). Each launch runs
// on the caller's stream and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// hat(s - p) in fp32, rounded to bf16 when the image is bf16
template <bool kBf16>
__device__ __forceinline__ float hat_weight(int s, float p) {
  const float w = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(static_cast<float>(s), p))));
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65536 ? blocks : 65536);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hat_rows_fwd_kernel(const T* __restrict__ img, const float* __restrict__ pos,
                    float* __restrict__ out, long long total, int S, int O,
                    int C) {
  constexpr bool kBf16 = sizeof(T) == 2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long ro = i / C;
    const int c = static_cast<int>(i - ro * C);
    const long long r = ro / O;
    const float p = pos[ro];
    const float fl = floorf(p);
    float acc = 0.f;
    if (fl >= -1.f && fl <= static_cast<float>(S - 1)) {  // a tap is inside
      const int s0 = static_cast<int>(fl);
      const T* src = img + r * S * C + c;
      if (s0 >= 0)
        acc = __fmul_rn(hat_weight<kBf16>(s0, p),
                        to_float(src[static_cast<long long>(s0) * C]));
      if (s0 + 1 <= S - 1)
        acc = __fadd_rn(acc, __fmul_rn(hat_weight<kBf16>(s0 + 1, p),
                                       to_float(src[static_cast<long long>(s0 + 1) * C])));
    }
    out[i] = acc;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
hat_rows_bwd_kernel(const float* __restrict__ dout,
                    const float* __restrict__ pos, float* __restrict__ dimg,
                    long long total, int S, int O, int C) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long ro = i / C;
    const int c = static_cast<int>(i - ro * C);
    const long long r = ro / O;
    const float p = pos[ro];
    const float fl = floorf(p);
    if (!(fl >= -1.f && fl <= static_cast<float>(S - 1))) continue;
    float g = dout[i];
    if (kBf16) g = __bfloat162float(__float2bfloat16_rn(g));
    const int s0 = static_cast<int>(fl);
    float* dst = dimg + r * S * C + c;
    if (s0 >= 0)
      atomicAdd(dst + static_cast<long long>(s0) * C,
                __fmul_rn(hat_weight<kBf16>(s0, p), g));
    if (s0 + 1 <= S - 1)
      atomicAdd(dst + static_cast<long long>(s0 + 1) * C,
                __fmul_rn(hat_weight<kBf16>(s0 + 1, p), g));
  }
}

}  // namespace

extern "C" {

// img (R,S,C) float32 (dtype 0) or bfloat16 (dtype 1), pos (R,O) float32 ->
// out (R,O,C) float32; every element is written.
int hat_rows_forward(const void* img, const float* pos, float* out, int R,
                     int S, int O, int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(R) * O * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 1)
    hat_rows_fwd_kernel<__nv_bfloat16><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(img), pos, out, total, S, O, C);
  else
    hat_rows_fwd_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(img), pos, out, total, S, O, C);
  return static_cast<int>(cudaGetLastError());
}

// dout (R,O,C) float32, pos (R,O) float32 -> dimg (R,S,C) float32,
// accumulated into (the caller zeroes it); dtype is the image's: 1 rounds
// the weights and dout to bf16.
int hat_rows_backward(const float* dout, const float* pos, float* dimg, int R,
                      int S, int O, int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(R) * O * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 1)
    hat_rows_bwd_kernel<true><<<grid_for(total), kThreads, 0, st>>>(
        dout, pos, dimg, total, S, O, C);
  else
    hat_rows_bwd_kernel<false><<<grid_for(total), kThreads, 0, st>>>(
        dout, pos, dimg, total, S, O, C);
  return static_cast<int>(cudaGetLastError());
}

const char* hatwarp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
