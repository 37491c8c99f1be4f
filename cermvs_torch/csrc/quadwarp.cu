// Bilinear inverse warp of an image at per-output pixel positions ("quad
// warp": four corner taps a position) for Hopper (sm_90a), and its
// transpose: the one-pass rectified construction's feature warps, volume
// back-warps and origin warp (ops/rectify.py `warp_image`).
//
// Replaces no TPU kernel: the JAX package's counterpart (its
// ops/rectify.py `warp_image`) is `jnp.take` left to XLA. In
// the port the plain version (four gathers, each followed by fp32 products
// and masks) made autograd scatter each gather back with aten's sort-based
// `index_put_(accumulate=True)` in the image's dtype, a launch per corner.
// For img (H,W,C) and positions x, y (P,)
//
//   out[p,c]    = sum_k w_k(p) * img[y_k(p), x_k(p), c]                (fp32)
//   dimg[s,c]   = sum_{p,k: (y_k,x_k)(p) = s} w_k(p) * dout[p,c]
//
// over the corners k = (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1) of
// (x0, y0) = floor(x, y), with w_k the fp32 lerp weights masked to zero
// where a corner falls off the image ("clamp" mode clamps the positions to
// the image first).
//
// What bounds them on this card. Per output element four multiplies
// against one 4-byte store and four 2- or 4-byte reads that neighbouring
// positions share (the positions come from homographies, so a tile of
// outputs reads a compact patch); per transposed element four
// multiply-adds against one 4-byte read: far below the flop/byte ridge, so
// bytes bound both: img and the positions read once and out written once;
// dout and the positions read once and dimg written once.
//
// Forward: a group of threads per position, each a vector of `vec`
// channels (16 bytes of the image where C and its alignment allow; the
// wrapper's `launch_geometry`), forms the position's corners and weights
// once and reads the four taps as vector loads. The arithmetic is the
// plain version's, operation for operation, with no fused multiply-add:
// weights (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx*fy times the 0/1 mask, each
// tap read at the clamped corner (also off the image, where its weight is
// 0) and widened to fp32, multiplied by its weight, and the taps summed as
// ((t00 + t01) + t10) + t11; so its output is bit for bit the plain
// version's.
//
// Transpose: a block owns a tile of kTile x kTile output positions (of the
// positions' (rows, cols) view). It forms the tile's corners into shared
// memory and the bounding box of those that land on the image. Where the
// box's fp32 channels fit the block's dynamic shared memory (the smooth
// maps of the warps: a tile reads a patch little wider than itself), the
// block zeroes the box there, every (position, channel) item adds its
// corners' shares with shared-memory atomics, and the block then adds the
// box to the zeroed fp32 buffer `dimg` once, an element each, with
// `red.global.add` (16-byte vector reductions where C % 4 == 0; elements
// that stayed zero skipped). A block whose box does not fit adds each
// share straight to `dimg` with global atomics. The choice is the block's,
// from the box its positions give. The wrapper rounds the buffer to the
// image's dtype in one pass. Sums are fp32 throughout; the order in which
// the atomics meet changes from launch to launch, so two launches agree to
// fp32 reordering: each element's sum of n terms to about
// n * 2^-24 * sum |terms|, then to one rounding in the image's dtype. An
// optional int[2] counter takes, per launch, the blocks with a corner on
// the image and, of those, the blocks that fell back to global atomics.
//
// Exported with a plain C interface (loaded with ctypes). Each launch runs
// on the caller's stream and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // the transpose's tile: kTile x kTile positions
constexpr int kTilePositions = kTile * kTile;
constexpr int kUnroll = 4;  // dout loads in flight per thread
constexpr int kMaxSmem = 232448;

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

// One position's corners: the clamped columns x0, x0+1 and rows y0, y0+1,
// the masked weights of (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1), and a
// bit per corner that lands on the image.
struct Corners {
  int x[2], y[2];
  float w[4];
  int in;
};

// torch.clamp(v, 0, hi): NaN stays NaN
__device__ __forceinline__ float clamp_position(float v, float hi) {
  return v != v ? v : fminf(fmaxf(v, 0.f), hi);
}

// an integer-valued float clamped to [0, n-1] (NaN to 0)
__device__ __forceinline__ int clamp_index(float v, int n) {
  return v >= static_cast<float>(n - 1) ? n - 1 : (v > 0.f ? static_cast<int>(v) : 0);
}

__device__ __forceinline__ Corners corners_of(float x, float y, int H, int W, bool clamp) {
  if (clamp) {
    x = clamp_position(x, static_cast<float>(W - 1));
    y = clamp_position(y, static_cast<float>(H - 1));
  }
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  // compared as floats: a huge or NaN position is never cast
  const bool inx0 = x0 >= 0.f && x0 <= static_cast<float>(W - 1);
  const bool inx1 = x0 >= -1.f && x0 <= static_cast<float>(W - 2);
  const bool iny0 = y0 >= 0.f && y0 <= static_cast<float>(H - 1);
  const bool iny1 = y0 >= -1.f && y0 <= static_cast<float>(H - 2);
  const bool in[4] = {iny0 && inx0, iny0 && inx1, iny1 && inx0, iny1 && inx1};
  const float w[4] = {__fmul_rn(gx, gy), __fmul_rn(fx, gy), __fmul_rn(gx, fy),
                      __fmul_rn(fx, fy)};
  Corners c;
  c.x[0] = clamp_index(x0, W);
  c.x[1] = clamp_index(__fadd_rn(x0, 1.f), W);
  c.y[0] = clamp_index(y0, H);
  c.y[1] = clamp_index(__fadd_rn(y0, 1.f), H);
  c.in = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.w[k] = __fmul_rn(w[k], in[k] ? 1.f : 0.f);
    c.in |= static_cast<int>(in[k]) << k;
  }
  return c;
}

// block (groups, positions): threadIdx.y picks the position, threadIdx.x
// (and its strides) the channel vector; grid (tiles)
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
quad_warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                     const float* __restrict__ ys, float* __restrict__ out,
                     int P, int H, int W, int C, int clamp) {
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= P) return;
  const Corners q = corners_of(__ldg(xs + p), __ldg(ys + p), H, W, clamp != 0);
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) off[k] = (q.y[k >> 1] * W + q.x[k & 1]) * C;
  float* dst = out + static_cast<size_t>(p) * C;
  for (int c = threadIdx.x * kVec; c < C; c += blockDim.x * kVec) {
    float v[4][kVec], acc[kVec];
#pragma unroll
    for (int k = 0; k < 4; ++k) Vec<T, kVec>::load(img + off[k] + c, v[k]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      acc[i] = __fmul_rn(v[0][i], q.w[0]);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v[1][i], q.w[1]));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v[2][i], q.w[2]));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v[3][i], q.w[3]));
    }
    store_vec<kVec>(dst + c, acc);
  }
}

template <typename T, int kVec>
void launch_forward(const void* img, const float* xs, const float* ys, float* out,
                    int P, int H, int W, int C, int clamp, dim3 block, int tiles,
                    cudaStream_t st) {
  quad_warp_fwd_kernel<T, kVec><<<tiles, block, 0, st>>>(
      static_cast<const T*>(img), xs, ys, out, P, H, W, C, clamp);
}

// grid (ceil(Q / kTile), ceil(R / kTile)) over the positions' (R, Q) view;
// `smem_floats` fp32 of dynamic shared memory for the box
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
quad_warp_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ xs,
                     const float* __restrict__ ys, float* __restrict__ dimg,
                     int R, int Q, int H, int W, int C, int clamp, int smem_floats,
                     int* __restrict__ counter) {
  extern __shared__ __align__(16) float box_acc[];
  __shared__ Corners tile[kTilePositions];
  __shared__ int box[4];  // lowest and highest column, lowest and highest row
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTile, q0 = blockIdx.x * kTile;

  // 1. the tile's corners, and the box around those that land on the image
  if (tid == 0) {
    box[0] = INT_MAX; box[1] = -1; box[2] = INT_MAX; box[3] = -1;
  }
  __syncthreads();
  if (tid < kTilePositions) {
    const int r = r0 + tid / kTile, q = q0 + tid % kTile;
    Corners c{};
    if (r < R && q < Q) {
      const size_t p = static_cast<size_t>(r) * Q + q;
      c = corners_of(__ldg(xs + p), __ldg(ys + p), H, W, clamp != 0);
    }
    tile[tid] = c;
    if (c.in) {
      const int xl = (c.in & 5) ? c.x[0] : c.x[1], xh = (c.in & 10) ? c.x[1] : c.x[0];
      const int yl = (c.in & 3) ? c.y[0] : c.y[1], yh = (c.in & 12) ? c.y[1] : c.y[0];
      atomicMin(box + 0, xl);
      atomicMax(box + 1, xh);
      atomicMin(box + 2, yl);
      atomicMax(box + 3, yh);
    }
  }
  __syncthreads();
  if (box[1] < 0) return;  // no corner of the tile lands on the image
  const int bx0 = box[0], by0 = box[2];
  const int bh = box[3] - by0 + 1;
  const int span = (box[1] - bx0 + 1) * C;  // floats of one box row
  const bool local = static_cast<long long>(bh) * span <= smem_floats;
  if (counter != nullptr && tid == 0) {
    atomicAdd(counter, 1);
    if (!local) atomicAdd(counter + 1, 1);
  }
  if (local) {
    for (int i = tid; i < bh * span; i += kThreads) box_acc[i] = 0.f;
    __syncthreads();
  }

  // 2. every (position, channel) item adds its corners' shares: to the box
  // in shared memory, or straight to dimg
  const int items = kTilePositions * C;
  for (int e0 = tid; e0 < items; e0 += kUnroll * kThreads) {
    int t[kUnroll], ch[kUnroll];
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      t[u] = -1;
      if (e < items) {
        const int tt = e / C;
        if (tile[tt].in) {
          t[u] = tt;
          ch[u] = e - tt * C;
          d[u] = __ldg(dout + (static_cast<size_t>(r0 + tt / kTile) * Q + q0 + tt % kTile) * C +
                       ch[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t[u] < 0) continue;
      const Corners& c = tile[t[u]];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!((c.in >> k) & 1)) continue;
        const float v = __fmul_rn(d[u], c.w[k]);
        const int x = c.x[k & 1], y = c.y[k >> 1];
        if (local)
          atomicAdd(box_acc + (y - by0) * span + (x - bx0) * C + ch[u], v);
        else
          atomicAdd(dimg + (static_cast<size_t>(y) * W + x) * C + ch[u], v);
      }
    }
  }
  if (!local) return;
  __syncthreads();

  // 3. the box into dimg, each element once; rows of the box are
  // contiguous in dimg
  if constexpr (kVec4) {
    const int span4 = span / 4;
    for (int i = tid; i < bh * span4; i += kThreads) {
      const int row = i / span4, col = i - row * span4;
      const float4 v = reinterpret_cast<const float4*>(box_acc)[i];
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(
                      dimg + (static_cast<size_t>(by0 + row) * W + bx0) * C) + col, v);
    }
  } else {
    for (int i = tid; i < bh * span; i += kThreads) {
      const int row = i / span, col = i - row * span;
      const float v = box_acc[i];
      if (v != 0.f)
        atomicAdd(dimg + (static_cast<size_t>(by0 + row) * W + bx0) * C + col, v);
    }
  }
}

template <bool kVec4>
cudaError_t launch_backward(const float* dout, const float* xs, const float* ys, float* dimg,
                            int R, int Q, int H, int W, int C, int clamp, int smem_bytes,
                            int* counter, cudaStream_t st) {
  const auto kernel = quad_warp_bwd_kernel<kVec4>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Q + kTile - 1) / kTile, (R + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem_bytes, st>>>(dout, xs, ys, dimg, R, Q, H, W, C, clamp,
                                             smem_bytes / 4, counter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img (H,W,C) float32 (dtype 0) or bfloat16 (dtype 1), x, y (P,) float32
// -> out (P,C) float32; every element is written. clamp: 1 clamps the
// positions to the image first. vec, the block (bx, by) and the tile count
// come from the wrapper's launch_geometry: vec divides C and the image's
// alignment, bx * by <= 256, tiles * by >= P, and H * W * C fits a 32-bit
// int.
int quad_warp_forward(const void* img, const float* xs, const float* ys, float* out,
                      int P, int H, int W, int C, int dtype, int clamp, int vec, int bx,
                      int by, int tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(P) * C == 0) return static_cast<int>(cudaGetLastError());
  if (H < 1 || W < 1 || static_cast<long long>(H) * W * C >= INT_MAX || vec < 1 ||
      C % vec != 0 || bx < 1 || by < 1 || bx * by > kThreads ||
      static_cast<long long>(tiles) * by < P)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(bx, by);
#define QUAD_FWD(T, V) \
  launch_forward<T, V>(img, xs, ys, out, P, H, W, C, clamp, block, tiles, st)
  if (dtype == 1) {
    switch (vec) {
      case 8: QUAD_FWD(__nv_bfloat16, 8); break;
      case 4: QUAD_FWD(__nv_bfloat16, 4); break;
      case 2: QUAD_FWD(__nv_bfloat16, 2); break;
      case 1: QUAD_FWD(__nv_bfloat16, 1); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (vec) {
      case 4: QUAD_FWD(float, 4); break;
      case 2: QUAD_FWD(float, 2); break;
      case 1: QUAD_FWD(float, 1); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef QUAD_FWD
  return static_cast<int>(cudaGetLastError());
}

// dout (R*Q, C) float32, x, y (R*Q,) float32 (the positions' (R, Q) view)
// -> adds the transpose into dimg (H,W,C) float32, which the caller zeroed
// and whose address is a multiple of 16 bytes. vec4: 1 for 16-byte
// reductions (C % 4 == 0). smem_bytes: the box's shared memory, a multiple
// of 16 up to a block's limit. counter: null, or int[2] (blocks with a
// corner on the image, and of those the blocks that fell back to global
// atomics), added to.
int quad_warp_backward(const float* dout, const float* xs, const float* ys, float* dimg,
                       int R, int Q, int H, int W, int C, int clamp, int vec4,
                       int smem_bytes, int* counter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(R) * Q * C == 0) return static_cast<int>(cudaGetLastError());
  if (H < 1 || W < 1 || static_cast<long long>(H) * W * C >= INT_MAX ||
      (vec4 && C % 4 != 0) || smem_bytes < 16 || smem_bytes % 16 != 0 ||
      smem_bytes > kMaxSmem - 4096 || (R + kTile - 1) / kTile > 65535 ||
      static_cast<long long>(kTilePositions) * C >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      vec4 ? launch_backward<true>(dout, xs, ys, dimg, R, Q, H, W, C, clamp, smem_bytes, counter, st)
           : launch_backward<false>(dout, xs, ys, dimg, R, Q, H, W, C, clamp, smem_bytes, counter, st);
  return static_cast<int>(e);
}

const char* quadwarp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
