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
// Transpose: a per-row gather. Scattering each (r,o,c) into two cells of
// a zeroed fp32 buffer with global atomics would need a memset, fp32
// atomics, a cast pass for a bf16 image, and sums that meet in an order
// that changes from run to run. Instead a block owns one row r (or a few
// rows, each with its own threads, where a row is too small for a block):
//   1. the row's O positions go to shared memory; each output's bin
//      b = floor(pos) + 1 in [0, S] is counted with integer shared atomics
//      (fp32 shared atomics compile to a compare-and-swap loop; integers
//      do not), with the first output of each bin;
//   2. an inclusive scan of the counts gives each bin's end;
//   3. each bin lists its outputs in ascending o as records (o * C, the
//      two tap weights): a thread per output counts the same-bin outputs
//      before it since the bin's first, where every output lies within
//      kScanSpan of its bin's first (the smooth maps of the warps); one warp
//      ranks them 32 at a time with __match_any_sync otherwise (positions
//      in any order, or many outputs piled on one column). Both give the
//      same list;
//   4. a group of threads per column s, each with a vector of `vec` fp32
//      channels of dout (16-byte loads where C and the alignment allow, four
//      records' loads in flight), sums bin s's records with their second
//      weight and bin s+1's with their first, in list order, in registers,
//      and writes dimg[r,s,:] once in the image's dtype. Where the rows
//      alone give the card too few blocks (a feature warp's 264 rows),
//      `splits` blocks share a row's columns, each ranking the whole row.
// No float atomics, no memset, no cast pass; the sums meet in one fixed
// order, so two launches give the same bits. Index arithmetic inside a row
// is 32-bit; only the row's base offsets are 64-bit. The bytes bound it as
// they bound the forward: dout and pos read once, dimg written once. The
// geometry (rows per block, vec, groups, splits, shared bytes) comes from
// the wrapper's `backward_launch_geometry`; the launcher refuses other
// bytes.
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

// kVec values of the image's type from fp32 sums: 16-, 8- or 4-byte stores
template <typename T, int kVec>
__device__ __forceinline__ void store_out(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    store_vec<kVec>(reinterpret_cast<float*>(p), v);
  } else if constexpr (kVec >= 2) {
    unsigned u[kVec / 2];
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      u[i] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))) << 16);
    if constexpr (kVec == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<unsigned*>(p) = u[0];
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// Within kScanSpan outputs of its bin's first, an output finds its rank by
// counting; past that the row is ranked by one warp.
constexpr int kScanSpan = 64;
constexpr int kUnroll = 4;  // dout loads in flight per thread and column

// bin of a position: floor(pos) + 1 in [0, S] where a tap lands on the row,
// -1 where none does (compared as a float: a huge or NaN pos is never cast)
__device__ __forceinline__ int bin_of(float p, int S) {
  const float fl = floorf(p);
  return (fl >= -1.f && fl <= static_cast<float>(S - 1))
             ? static_cast<int>(fl) + 1 : -1;
}

// Shared bytes of one row: records' weights (8 * O), positions (4 * O),
// records' offsets (4 * O), bin ends and firsts (4 * (S + 1) each); the
// wrapper's backward_launch_geometry counts the same.
__host__ __device__ __forceinline__ int bwd_row_bytes(int S, int O) {
  return static_cast<int>((16LL * O + 8LL * (S + 1) + 15) & ~15LL);
}

// block of kThreads threads, `rows` rows (tpr = kThreads / rows threads
// each, a whole number of warps); grid (ceil(R / rows), splits): block
// (x, j) writes the j-th of `splits` column ranges of its rows
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
hat_rows_bwd_kernel(const float* __restrict__ dout,
                    const float* __restrict__ pos, T* __restrict__ dimg,
                    int R, int S, int O, int C, int rows, int groups) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int span_cols = (S + gridDim.y - 1) / gridDim.y;
  const int s_lo = blockIdx.y * span_cols;
  const int s_hi = min(S, s_lo + span_cols);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int span[kThreads / 32];
  const int tpr = kThreads / rows;
  const int sub = threadIdx.x / tpr;  // the row's slot in the block
  const int t = threadIdx.x - sub * tpr;
  const int r = blockIdx.x * rows + sub;
  const bool live = r < R;          // a slot past R takes part in the
  const int n_out = live ? O : 0;   // barriers only
  unsigned char* base = smem + sub * bwd_row_bytes(S, O);
  float2* rec_w = reinterpret_cast<float2*>(base);
  float* ps = reinterpret_cast<float*>(base + 8 * O);
  int* rec_off = reinterpret_cast<int*>(base + 12 * O);
  int* ends = reinterpret_cast<int*>(base + 16 * O);
  int* first = ends + (S + 1);
  const float* prow = pos + static_cast<size_t>(live ? r : 0) * O;

  // 1. positions to shared memory; counts and first output of each bin
  for (int b = t; b <= S; b += tpr) {
    ends[b] = 0;
    first[b] = O;
  }
  if (t == 0) span[sub] = 0;
  __syncthreads();
  for (int o = t; o < n_out; o += tpr) {
    const float p = __ldg(prow + o);
    ps[o] = p;
    const int b = bin_of(p, S);
    if (b >= 0) {
      atomicAdd(ends + b, 1);
      atomicMin(first + b, o);
    }
  }
  __syncthreads();

  // 2. inclusive scan of the counts, a chunk of bins per thread; and the
  // widest distance of an output from its bin's first
  const int chunk = (S + 1 + tpr - 1) / tpr;
  const int j0 = min(t * chunk, S + 1), j1 = min(j0 + chunk, S + 1);
  int local = 0;
  for (int j = j0; j < j1; ++j) local += ends[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  int far = 0;
  for (int o = t; o < n_out; o += tpr) {
    const int b = bin_of(ps[o], S);
    if (b >= 0) far = max(far, o - first[b]);
  }
  if (far > kScanSpan) span[sub] = 1;  // any writer: the same value
  __syncthreads();
  int run = incl - local;
  for (int w = sub * (tpr >> 5); w < warp; ++w) run += warp_sum[w];
  for (int j = j0; j < j1; ++j) {
    run += ends[j];
    ends[j] = run;
  }
  __syncthreads();

  // 3. the records of each bin, in ascending o: slot = bin start + rank
  if (span[sub] == 0) {
    for (int o = t; o < n_out; o += tpr) {
      const float p = ps[o];
      const int b = bin_of(p, S);
      if (b < 0) continue;
      int rank = 0;
      for (int q = first[b]; q < o; ++q) rank += bin_of(ps[q], S) == b;
      const int slot = (b > 0 ? ends[b - 1] : 0) + rank;
      rec_off[slot] = o * C;
      rec_w[slot] = make_float2(hat_weight<kBf16>(b - 1, p),
                                hat_weight<kBf16>(b, p));
    }
  } else if (t < 32) {
    // first[] becomes each bin's cursor, from its start
    for (int b = t; b <= S; b += 32) first[b] = b > 0 ? ends[b - 1] : 0;
    __syncwarp();
    const unsigned before = (1u << t) - 1u;
    for (int o0 = 0; o0 < n_out; o0 += 32) {
      const int o = o0 + t;
      const float p = o < n_out ? ps[o] : -1e30f;
      const int b = bin_of(p, S);
      const unsigned same = __match_any_sync(0xffffffffu, b);
      const int slot = b >= 0 ? first[b] + __popc(same & before) : 0;
      __syncwarp();
      if (b >= 0) {
        if ((same & before) == 0) first[b] += __popc(same);
        rec_off[slot] = o * C;
        rec_w[slot] = make_float2(hat_weight<kBf16>(b - 1, p),
                                  hat_weight<kBf16>(b, p));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 4. column s: bin s's records with their second weight (tap s0 + 1 = s),
  // then bin s+1's with their first (tap s0 = s), in list order
  const int positions = tpr / groups;
  const int gx = t % groups, gy = t / groups;
  if (gy >= positions) return;
  const float* drow = dout + static_cast<size_t>(live ? r : 0) * O * C;
  T* irow = dimg + static_cast<size_t>(live ? r : 0) * S * C;
  for (int s = s_lo + gy; live && s < s_hi; s += positions) {
    const int lo = s > 0 ? ends[s - 1] : 0, mid = ends[s], hi = ends[s + 1];
    for (int c = gx * kVec; c < C; c += groups * kVec) {
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
      for (int e0 = lo; e0 < hi; e0 += kUnroll) {
        float x[kUnroll][kVec], w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = min(e0 + u, hi - 1);
          const float2 ww = rec_w[e];
          w[u] = e < mid ? ww.y : ww.x;
          Vec<float, kVec>::load(drow + rec_off[e] + c, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + u >= hi) break;
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float g = kBf16 ? __bfloat162float(__float2bfloat16_rn(x[u][i]))
                                  : x[u][i];
            acc[i] = __fmaf_rn(w[u], g, acc[i]);
          }
        }
      }
      store_out<T, kVec>(irow + s * C + c, acc);
    }
  }
}

template <typename T, int kVec>
cudaError_t launch_backward(const float* dout, const float* pos, void* dimg,
                            int R, int S, int O, int C, int rows, int groups,
                            int splits, int smem_bytes, cudaStream_t st) {
  const auto kernel = hat_rows_bwd_kernel<T, kVec>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((R + rows - 1) / rows, splits), kThreads, smem_bytes, st>>>(
      dout, pos, static_cast<T*>(dimg), R, S, O, C, rows, groups);
  return cudaGetLastError();
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

// dout (R,O,C) float32, pos (R,O) float32 -> dimg (R,S,C) in the image's
// dtype (0 float32, 1 bfloat16: the weights and dout rounded to bf16);
// every element is written once. vec, rows and groups come from the
// wrapper's backward_launch_geometry: vec in {4, 2, 1} divides C and the
// alignment of dout and dimg, rows in {1, 2, 4, 8}, groups <= 256 / rows,
// 1 <= splits <= 65535 column ranges, smem_bytes = rows *
// bwd_row_bytes(S, O), and S * C, O * C fit a 32-bit int.
int hat_rows_backward(const float* dout, const float* pos, void* dimg, int R,
                      int S, int O, int C, int dtype, int vec, int rows,
                      int groups, int splits, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(R) * S * C == 0)
    return static_cast<int>(cudaGetLastError());
  if (vec < 1 || C % vec != 0 || !(rows == 1 || rows == 2 || rows == 4 ||
                                   rows == 8) ||
      groups < 1 || groups > kThreads / rows || splits < 1 ||
      splits > 65535 ||
      static_cast<long long>(rows) * bwd_row_bytes(S, O) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
#define HAT_BWD(T, V)                                                      \
  e = launch_backward<T, V>(dout, pos, dimg, R, S, O, C, rows, groups,     \
                            splits, smem_bytes, st)
  if (dtype == 1) {
    switch (vec) {
      case 4: HAT_BWD(__nv_bfloat16, 4); break;
      case 2: HAT_BWD(__nv_bfloat16, 2); break;
      case 1: HAT_BWD(__nv_bfloat16, 1); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (vec) {
      case 4: HAT_BWD(float, 4); break;
      case 2: HAT_BWD(float, 2); break;
      case 1: HAT_BWD(float, 1); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef HAT_BWD
  return static_cast<int>(e);
}

const char* hatwarp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
