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
// written once.
//
// Forward design. A thread per element (r, o, c) spends more instructions
// on its own index divisions, its own reload of pos and its own floor and
// weights than on the bytes it moves, so it issues instructions, not
// bytes, at the limit (about 0.7 TB/s). Instead a block owns one row r and
// a tile of output positions; a group of threads covers one position, each
// thread a vector of `vec` channels (16 bytes of a bf16 image where C % 8
// == 0; narrower where C, or the image's alignment, allows no more). A
// thread forms the position's floor and two weights once for its vector,
// reads both taps as vector loads (neighbouring positions share columns in
// L1) and writes its fp32 channels as 16-byte stores. Index arithmetic
// inside a row is 32-bit; only the row's base offset is 64-bit. The launch
// geometry (vec, block shape, grid) comes from the Python wrapper's
// `launch_geometry`. Results are bit-identical to the element-per-thread
// formulation: the same weights, w0 * x0 then + w1 * x1, no fused
// multiply-add.
//
// Transpose. It scatters each (r,o,c) into two fp32 cells of a zeroed
// (R,S,C) buffer with global atomics; a warp's 32 lanes hit 32
// neighbouring channels of one cell, and a source column receives about
// O/S outputs' taps, so contention is low. The sums meet in an order that
// changes from run to run. One thread per element, a grid-stride loop.
// The hat tensors of the matrix-product formulation never exist in device
// memory, and autograd saves only pos.
//
// Exported with a plain C interface (loaded with ctypes). Each launch runs
// on the caller's stream and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// vec channels of a row, widened to fp32: one load of vec * sizeof(T) bytes
template <typename T, int kVec>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const float2 a = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = a.x; v[1] = a.y;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};

template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

// kVec fp32 values as 16-byte stores where there are four or more
template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (kVec >= 4) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      reinterpret_cast<float4*>(p)[i / 4] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// block (groups, positions): threadIdx.y picks the position in the tile,
// threadIdx.x (and its strides) the channel vector; grid (R, tiles)
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
hat_rows_fwd_kernel(const T* __restrict__ img, const float* __restrict__ pos,
                    float* __restrict__ out, int S, int O, int C) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int o = blockIdx.y * blockDim.y + threadIdx.y;
  if (o >= O) return;
  const size_t r = blockIdx.x;
  const float p = __ldg(pos + r * O + o);
  const float fl = floorf(p);
  const bool inside = fl >= -1.f && fl <= static_cast<float>(S - 1);
  const int s0 = inside ? static_cast<int>(fl) : 0;
  const bool tap0 = inside && s0 >= 0;
  const bool tap1 = inside && s0 + 1 <= S - 1;
  const float w0 = tap0 ? hat_weight<kBf16>(s0, p) : 0.f;
  const float w1 = tap1 ? hat_weight<kBf16>(s0 + 1, p) : 0.f;
  const T* src = img + r * S * C;
  float* dst = out + (r * O + o) * C;
  for (int c = threadIdx.x * kVec; c < C; c += blockDim.x * kVec) {
    float acc[kVec], x[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    if (tap0) {
      Vec<T, kVec>::load(src + s0 * C + c, x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = __fmul_rn(w0, x[i]);
    }
    if (tap1) {
      Vec<T, kVec>::load(src + (s0 + 1) * C + c, x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w1, x[i]));
    }
    store_vec<kVec>(dst + c, acc);
  }
}

template <typename T, int kVec>
void launch_forward(const void* img, const float* pos, float* out, int R,
                    int S, int O, int C, dim3 block, int tiles,
                    cudaStream_t st) {
  hat_rows_fwd_kernel<T, kVec><<<dim3(R, tiles), block, 0, st>>>(
      static_cast<const T*>(img), pos, out, S, O, C);
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
// out (R,O,C) float32; every element is written. vec, the block (bx, by)
// and the tile count come from the wrapper's launch geometry: vec divides C
// and the image's alignment, bx * by <= 256, tiles * by >= O, and S * C and
// O * C fit a 32-bit int.
int hat_rows_forward(const void* img, const float* pos, float* out, int R,
                     int S, int O, int C, int dtype, int vec, int bx, int by,
                     int tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(R) * O * C == 0)
    return static_cast<int>(cudaGetLastError());
  if (vec < 1 || C % vec != 0 || bx < 1 || by < 1 || bx * by > kThreads ||
      static_cast<long long>(tiles) * by < O)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(bx, by);
  if (dtype == 1) {
    switch (vec) {
      case 8: launch_forward<__nv_bfloat16, 8>(img, pos, out, R, S, O, C, block, tiles, st); break;
      case 4: launch_forward<__nv_bfloat16, 4>(img, pos, out, R, S, O, C, block, tiles, st); break;
      case 2: launch_forward<__nv_bfloat16, 2>(img, pos, out, R, S, O, C, block, tiles, st); break;
      case 1: launch_forward<__nv_bfloat16, 1>(img, pos, out, R, S, O, C, block, tiles, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (vec) {
      case 4: launch_forward<float, 4>(img, pos, out, R, S, O, C, block, tiles, st); break;
      case 2: launch_forward<float, 2>(img, pos, out, R, S, O, C, block, tiles, st); break;
      case 1: launch_forward<float, 1>(img, pos, out, R, S, O, C, block, tiles, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
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
