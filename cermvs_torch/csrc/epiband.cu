// Rectified epipolar band resample ("epiband") for Hopper (sm_90a): the
// forward and its two backward kernels.
//
// Forward. Replaces the TPU kernels of the JAX package's ops/pallas/epiband.py
// reached from _epiband_fwd_impl: _epiband_kernel (dynamic base),
// _epiband_kernel_static (base == 0) and _epiband_kernel_chunked
// (hypothesis-chunked windows). One kernel per feature type covers all
// three: for each view v, rect row y, pixel x and hypothesis k
//
//   pos      = (x + s_max) - (base[v,y,x] + k * sigma[v,y,x])
//   G(s)     = <fr[v,y,x,:], fs[v,y,s,:]>                 (fp32 accumulate)
//   out[k]   = (1 - f) * G(i0) * [0 <= i0 <= ws-1] + f * G(i0+1) * [0 <= i0+1 <= ws-1]
//
// with i0 = floor(pos), f = pos - i0: linear interpolation along the source
// row with each tap zeroed outside [0, ws-1] (the oracle is
// corr_rectified._resample_rows_oracle). base may be null (stage 0: base == 0).
//
// The output is NaN where the position is (a NaN base or sigma), as in the
// plain version, whose (1 - f) * G * 0 keeps the NaN; a finite position
// outside the band gives 0.
//
// What bounds it on this card. Per output the two taps cost 2*C multiply-adds
// (4*C flops); the bytes the function must move are fr and the fs columns
// the slabs reach read once and the fp32 volume written once, e.g. for the
// widest stage-0 view of the DTU slice (h_r x w_r = 512 x 512, ws = 1104,
// C = 64, D = 64, bf16 features) about 0.16 GB against 4.3 GFLOP:
// 27 flop/byte, far below the ~295 flop/byte ridge, so the least time is
// set by the bytes. The TPU kernels built a full G tile on the MXU and
// selected the band with barrel rolls and hat-matrix segment sums because
// Mosaic cannot gather.
//
// Design, bf16 features (the model's type): a G tile on the tensor cores.
// A warp per pixel that forms only the 2*D dot products a pixel needs
// spends, for every output, two source-row loads, a 5-step shuffle
// reduction and the position arithmetic in every lane: it is bound by
// instruction issue, ~30x its byte bound. Here a block (256 threads) takes
// one view v, rect row y and a tile of `tile` rect pixels (64 for D <= 64;
// 32 or 16 for wider D, so that each thread keeps at most 16 outputs in
// registers). It
//   1. stages the tile's fr rows (tile x C, zero-padded to a multiple of
//      16 channels) in shared memory with cp.async;
//   2. computes each output's tap position once, in the plain version's
//      rounding order (__fsub_rn/__fadd_rn/__fmul_rn, no contraction: a
//      floor that flips moves a tap a whole column), and marks, in a shared
//      bitmap, the 128-column chunks of the source row that an in-band tap
//      reaches: out-of-band, far and NaN positions mark nothing, so they
//      neither widen the band nor cost a chunk. A thread keeps its outputs'
//      positions in registers with lanes across pixels and warps across
//      hypotheses, so the 32 outputs of one warp slot sit at one hypothesis
//      of consecutive pixels and reach one or two chunks; lane i holds slot
//      i's chunk range;
//   3. walks the reached chunks in order, double-buffered: while chunk i is
//      used, cp.async brings chunk i+1 (128 x C bf16) into the other buffer;
//      for chunk i the block forms G = Fr_tile . Fs_chunk^T with mma.sync
//      m16n8k16 (bf16 in, fp32 accumulate; fragments from ldmatrix, A held
//      in registers for the whole walk) into a shared fp32 tile, and each
//      warp adds, for the slots a ballot finds in the chunk, every output's
//      weighted G term of its taps there. A tap pair that straddles two
//      chunks adds (1 - f) G(i0) in the first and f G(i0 + 1) in the next;
//      both start from 0 and add in that order, so the sum is the plain
//      version's (1 - f) G(i0) + f G(i0 + 1), rounded the same way;
//   4. writes the tile's (tile x D) fp32 outputs through shared memory, so
//      that they leave once, coalesced.
// The dense G tile computes more dot products than the taps need (a stage-0
// tile's band is about tile + s_max columns, of which 2*D are read): at the
// inference plan's stage 0 about 22 GFLOP against the 0.16 GB the function
// moves, under the tensor cores' ridge, so the bytes still bound the
// kernel. The source band is staged in chunks, never whole: a bf16 row at
// ws = 2448 (313 KB) does not fit a block's 227 KB. The tile, the copy
// width (`vec` channels, 16 bytes where C % 8 == 0) and the shared-memory
// bytes come from the wrapper's launch_geometry; the launcher refuses
// bytes that differ from Smem's.
//
// fp32 features (tests, a float32 model) keep CUDA-core fp32 arithmetic:
// one warp per rect pixel (8 pixels per block), one channel pair per lane,
// the fr row in registers; for every hypothesis the warp reads the two
// source rows, forms the interpolated dot product lane-wise and reduces it
// with warp shuffles. Never TF32.
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
// is the fp32 forward's warp-per-pixel loop without the shuffle reduction (each
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

// fp32 features: lane j holds channel pair j (C <= 64)
__global__ void __launch_bounds__(kWarps * 32)
epiband_fp32_kernel(const float* __restrict__ fr, const float* __restrict__ fs,
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
  const float* src = fs + row * static_cast<size_t>(ws) * C;
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
      if (lane == j) mine = f == f ? part : f;  // a NaN position: NaN
    }
    if (lane < n) dst[k0 + lane] = mine;
  }
}

// ---- bf16 forward: a G tile on the tensor cores ----------------------------

using bf16 = __nv_bfloat16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxOut = 16;       // outputs per thread: tile * D <= kThreads * kMaxOut
constexpr int kChunk = 128;       // source columns per staged chunk
constexpr int kReachWords = 64;   // reached-chunk bitmap: ws <= 2048 chunks
constexpr int kLocalChunks = 64;  // chunks a thread marks in registers first

__host__ __device__ constexpr int padded_channels(int C) { return (C + 15) & ~15; }

// Shared-memory layout (bytes) of the bf16 forward: the fr tile (tile rows),
// two source-chunk buffers (chunk rows each), the fp32 G tile (which at the
// end holds the output tile, rows of os = D | 1 floats), the tile's base
// and sigma, the reached-chunk bitmap. A staged row holds the padded
// channels plus 8 bf16, an odd number of 16-byte units, so ldmatrix's eight
// rows hit distinct banks; G rows are kChunk + 8 floats and output rows an
// odd number, so a warp's 32 pixels of one column hit distinct banks.
struct Smem {
  int lds, gs, os, a, b, g, prm, reach, total;
  __host__ __device__ Smem(int tile, int C, int D)
      : lds(padded_channels(C) + 8), gs(kChunk + 8), os(D | 1), a(0),
        b(tile * lds * 2), g(b + 2 * kChunk * lds * 2),
        prm(g + tile * (gs > os ? gs : os) * 4), reach(prm + 2 * tile * 4),
        total(reach + kReachWords * 4) {}
};

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// This thread's walk over the (row, vector) copies of staged rows of C
// channels, kVec channels per copy, kThreads copies apart: its first copy
// and the step, formed once so that no copy pays for a division.
struct CopyWalk {
  int r0, v0, dr, dv, per_row;
  __device__ CopyWalk(int C, int vec) : per_row(C / vec) {
    r0 = threadIdx.x / per_row;
    v0 = threadIdx.x - r0 * per_row;
    dr = kThreads / per_row;
    dv = kThreads - dr * per_row;
  }
};

// rows [0, n) of C channels (row stride C) into shared rows of stride lds
template <int kVec>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int n,
                                           int C, int lds, const CopyWalk& w) {
  for (int r = w.r0, v = w.v0; r < n;) {
    cp_async<kVec * 2>(dst + r * lds + v * kVec, src + r * C + v * kVec);
    r += w.dr;
    v += w.dv;
    if (v >= w.per_row) {
      v -= w.per_row;
      ++r;
    }
  }
}

// four 8x8 bf16 matrices, one row address per lane (lanes 8i..8i+7: matrix
// i), each lane receiving its mma fragment of each
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a . b for one m16n8k16 tile: bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's A fragments: its m-tile (16 rows of sA, warp % mt) as ldmatrix
// quarters (rows 0-7 | 8-15) x (k 0-7 | 8-15), for each 16-channel step.
__device__ __forceinline__ void load_a(unsigned (&af)[4][4], const bf16* sA,
                                       int mt, int ksteps, int lds) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  const bf16* row = sA + ((threadIdx.x >> 5) % mt * 16 + r + (q & 1) * 8) * lds +
                    (q >> 1) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < ksteps) ldmatrix_x4(af[ks], row + ks * 16);
}

// sG[m][n] = <sA[m], sB[n]> over the tile's rows and the chunk's columns:
// warp w takes m-tile w % mt and its share (2 * mt) of the chunk's 8-column
// n-tiles, four at a time; B comes from ldmatrix as two n-tiles' (k 0-7 |
// 8-15) halves.
__device__ __forceinline__ void g_tile(const unsigned (&af)[4][4],
                                       const bf16* sB, float* sG, int mt,
                                       int ksteps, int lds, int gs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r = lane & 7;
  const int m0 = (warp % mt) * 16;
  const int per_warp = kChunk / 8 * mt / kWarps;
  const int n_first = (warp / mt) * per_warp;
  for (int i0 = 0; i0 < per_warp; i0 += 4) {
    float d[4][4] = {};
    const bf16* b_row =
        sB + ((n_first + i0 + (q >> 1)) * 8 + r) * lds + (q & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < ksteps) {
        unsigned bf[2][4];
        ldmatrix_x4(bf[0], b_row + ks * 16);
        if (i0 + 2 < per_warp) ldmatrix_x4(bf[1], b_row + 16 * lds + ks * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i0 + i < per_warp)
            mma16816(d[i], af[ks], bf[i >> 1][(i & 1) * 2],
                     bf[i >> 1][(i & 1) * 2 + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i0 + i < per_warp) {
        float* o = sG + (m0 + g) * gs + (n_first + i0 + i) * 8 + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(d[i][0], d[i][1]);
        *reinterpret_cast<float2*>(o + 8 * gs) = make_float2(d[i][2], d[i][3]);
      }
    }
  }
}

// the first chunk after `after` whose bit is set, or -1
__device__ __forceinline__ int next_reached(const unsigned* reach, int after,
                                            int n_words) {
  const int c = after + 1;
  int w = c >> 5;
  if (w >= n_words) return -1;
  unsigned bits = reach[w] & (0xffffffffu << (c & 31));
  for (;;) {
    if (bits) return (w << 5) + __ffs(bits) - 1;
    if (++w >= n_words) return -1;
    bits = reach[w];
  }
}

// The outputs a thread keeps: with lanes across pixels and warps across
// hypotheses, slot (i, a) is pixel x = lane % L + 32 a and hypothesis
// k = warp + 8 (lane / L) + 8 (32 / L) i, L = min(tile, 32) lanes a pixel
// set: kPixels pixel slots a, kSlots hypothesis slots i. A warp's outputs
// of one slot i then cover consecutive pixels at (nearly) one hypothesis,
// whose taps fall in one or two chunks.
template <int kTile>
struct Slots {
  static constexpr int kLanes = kTile < 32 ? kTile : 32;
  static constexpr int kPixels = kTile / kLanes;
  static constexpr int kSlots = kMaxOut / kPixels;
  static constexpr int kStep = 8 * (32 / kLanes);
};

// block (tile pixels of row y of view v); see the notes at the top
template <int kTile, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
epiband_mma_kernel(const bf16* __restrict__ fr, const bf16* __restrict__ fs,
                   const float* __restrict__ base,
                   const float* __restrict__ sigma, float* __restrict__ out,
                   int h_r, int w_r, int ws, int C, int D, float s_max) {
  using S = Slots<kTile>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(kTile, C, D);
  bf16* sA = reinterpret_cast<bf16*>(smem + L.a);
  bf16* sB = reinterpret_cast<bf16*>(smem + L.b);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  float* sBase = reinterpret_cast<float*>(smem + L.prm);
  float* sSig = sBase + kTile;
  unsigned* sReach = reinterpret_cast<unsigned*>(smem + L.reach);
  constexpr int kShift = 7;  // log2(kChunk)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kTile;
  const int n_px = min(kTile, w_r - x0);
  const size_t row = static_cast<size_t>(blockIdx.z) * h_r + blockIdx.y;
  const size_t pix0 = row * w_r + x0;
  const bf16* src = fs + row * ws * C;
  const int n_words = (((ws + kChunk - 1) >> kShift) + 31) >> 5;
  const CopyWalk walk(C, kVec);

  // zeros in the padded channels and ragged rows of the staged tiles
  for (int i = tid; i < L.g / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kReachWords; i += kThreads) sReach[i] = 0u;
  for (int i = tid; i < n_px; i += kThreads) {
    sBase[i] = base != nullptr ? base[pix0 + i] : 0.f;
    sSig[i] = sigma[pix0 + i];
  }
  __syncthreads();
  stage_rows<kVec>(sA, fr + pix0 * C, n_px, C, L.lds, walk);
  cp_async_commit();

  // Positions. p keeps the position of an output with an in-band tap, else
  // -4 (its taps -4 and -3 miss every chunk); a NaN position makes the
  // output NaN. Lane i ends up holding slot i's reached chunks [c_lo, c_hi]
  // over the warp.
  const int xl = lane % S::kLanes;
  const int kl = warp + 8 * (lane / S::kLanes);
  float p[S::kSlots][S::kPixels], acc[S::kSlots][S::kPixels];
  int c_lo = 1 << 30, c_hi = -1;
  unsigned long long marks = 0;  // reached chunks below kLocalChunks
  auto mark = [&](int col) {
    const int c = col >> kShift;
    if (c < kLocalChunks)
      marks |= 1ull << c;
    else
      atomicOr(sReach + (c >> 5), 1u << (c & 31));
  };
  const float last = static_cast<float>(ws - 1);
#pragma unroll
  for (int i = 0; i < S::kSlots; ++i) {
    const int k = kl + S::kStep * i;
    int lo = 1 << 30, hi = -1;
#pragma unroll
    for (int a = 0; a < S::kPixels; ++a) {
      const int x = xl + 32 * a;
      p[i][a] = -4.f;
      acc[i][a] = 0.f;
      if (x < n_px && k < D) {
        const float xs = __fadd_rn(static_cast<float>(x0 + x), s_max);
        const float pos = __fsub_rn(
            xs, __fadd_rn(sBase[x], __fmul_rn(sSig[x], static_cast<float>(k))));
        const float fl = floorf(pos);
        if (pos != pos) acc[i][a] = pos;
        if (fl >= -1.f && fl <= last) {
          const int t0 = static_cast<int>(fl);
          p[i][a] = pos;
          if (t0 >= 0) mark(t0);
          if (t0 + 1 <= ws - 1) mark(t0 + 1);
          lo = min(lo, max(t0, 0) >> kShift);
          hi = max(hi, min(t0 + 1, ws - 1) >> kShift);
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == i) {
      c_lo = lo;
      c_hi = hi;
    }
  }
  const unsigned m_lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(marks));
  const unsigned m_hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(marks >> 32));
  if (lane == 0) {
    if (m_lo) atomicOr(sReach, m_lo);
    if (m_hi) atomicOr(sReach + 1, m_hi);
  }

  // the reached chunks in order, the next one's copy in flight
  const int mt = kTile >> 4, ksteps = padded_channels(C) >> 4;
  const int buf_elems = kChunk * L.lds;
  auto stage_chunk = [&](int c, int buf) {
    const int cb = c << kShift;
    stage_rows<kVec>(sB + buf * buf_elems, src + static_cast<size_t>(cb) * C,
                     min(kChunk, ws - cb), C, L.lds, walk);
  };
  __syncthreads();  // the bitmap is complete
  int c = next_reached(sReach, -1, n_words);
  if (c >= 0) stage_chunk(c, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the fr tile
  __syncthreads();
  unsigned af[4][4];
  load_a(af, sA, mt, ksteps, L.lds);
  for (int buf = 0; c >= 0; buf ^= 1) {
    const int cn = next_reached(sReach, c, n_words);
    if (cn >= 0) stage_chunk(cn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: chunk c
    __syncthreads();     // ... for every thread; and sG is free again
    g_tile(af, sB + buf * buf_elems, sG, mt, ksteps, L.lds, L.gs);
    __syncthreads();
    const int cb = c << kShift;
    const unsigned ncols = static_cast<unsigned>(min(kChunk, ws - cb));
    const unsigned active = __ballot_sync(0xffffffffu, c_lo <= c && c <= c_hi);
#pragma unroll
    for (int i = 0; i < S::kSlots; ++i) {
      if (!((active >> i) & 1u)) continue;  // uniform across the warp
#pragma unroll
      for (int a = 0; a < S::kPixels; ++a) {
        // (1 - f) G(i0) first, then f G(i0 + 1), in this chunk or the
        // next: the plain version's sum in its order
        const float fl = floorf(p[i][a]);
        const float f = __fsub_rn(p[i][a], fl);
        const int c0 = static_cast<int>(fl) - cb;
        const float* gx = sG + (xl + 32 * a) * L.gs;
        if (static_cast<unsigned>(c0) < ncols)
          acc[i][a] = __fadd_rn(acc[i][a], __fmul_rn(__fsub_rn(1.f, f), gx[c0]));
        if (static_cast<unsigned>(c0 + 1) < ncols)
          acc[i][a] = __fadd_rn(acc[i][a], __fmul_rn(f, gx[c0 + 1]));
      }
    }
    c = cn;
  }
  cp_async_wait<0>();

  // the output tile through shared memory (G's space), out coalesced
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S::kSlots; ++i) {
    const int k = kl + S::kStep * i;
#pragma unroll
    for (int a = 0; a < S::kPixels; ++a) {
      const int x = xl + 32 * a;
      if (x < n_px && k < D) sG[x * L.os + k] = acc[i][a];
    }
  }
  __syncthreads();
  float* dst = out + pix0 * D;
  const int dq = kThreads / D, dr = kThreads - dq * D;
  int x = tid / D, k = tid - x * D;
  for (int o = tid; o < n_px * D; o += kThreads) {
    dst[o] = sG[x * L.os + k];
    k += dr;
    x += dq;
    if (k >= D) {
      k -= D;
      ++x;
    }
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

template <int kTile, int kVec>
cudaError_t launch_mma(const void* fr, const void* fs, const float* base,
                       const float* sigma, float* out, int V, int h_r,
                       int w_r, int ws, int C, int D, float s_max,
                       int smem_bytes, cudaStream_t st) {
  const auto kernel = epiband_mma_kernel<kTile, kVec>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((w_r + kTile - 1) / kTile, h_r, V);
  kernel<<<grid, kThreads, smem_bytes, st>>>(
      static_cast<const bf16*>(fr), static_cast<const bf16*>(fs), base, sigma,
      out, h_r, w_r, ws, C, D, s_max);
  return cudaGetLastError();
}

template <int kTile>
cudaError_t launch_tile(int vec, const void* fr, const void* fs,
                        const float* base, const float* sigma, float* out,
                        int V, int h_r, int w_r, int ws, int C, int D,
                        float s_max, int smem_bytes, cudaStream_t st) {
  switch (vec) {
    case 8:
      return launch_mma<kTile, 8>(fr, fs, base, sigma, out, V, h_r, w_r, ws,
                                  C, D, s_max, smem_bytes, st);
    case 4:
      return launch_mma<kTile, 4>(fr, fs, base, sigma, out, V, h_r, w_r, ws,
                                  C, D, s_max, smem_bytes, st);
    case 2:
      return launch_mma<kTile, 2>(fr, fs, base, sigma, out, V, h_r, w_r, ws,
                                  C, D, s_max, smem_bytes, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 features, 1 = bfloat16 features. C must be even and at
// most 64, and fr/fs aligned to two elements (checked by the Python
// wrapper). tile, vec and smem_bytes come from the wrapper's launch
// geometry (epiband.launch_geometry): fp32 takes tile 8 (pixels per block);
// bf16 takes tile 16, 32 or 64 with tile * D <= 4096 and ws <= 2048 chunks,
// vec (channels per copy) 8, 4 or 2 dividing C and the features'
// alignment, and smem_bytes equal to Smem's total, so that a layout that
// drifted from the wrapper's is refused at its first launch. Returns a
// cudaError_t value.
int epiband_forward(const void* fr, const void* fs, const float* base,
                    const float* sigma, float* out, int V, int h_r, int w_r,
                    int ws, int C, int D, int s_max, int dtype, int tile,
                    int vec, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sm = static_cast<float>(s_max);
  if (dtype != 1) {
    if (tile != kWarps) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((w_r + kWarps - 1) / kWarps, h_r, V);
    epiband_fp32_kernel<<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(fr), static_cast<const float*>(fs), base,
        sigma, out, h_r, w_r, ws, C, D, sm);
    return static_cast<int>(cudaGetLastError());
  }
  const bool ok = (tile == 16 || tile == 32 || tile == 64) &&
                  tile * D <= kThreads * kMaxOut &&
                  static_cast<long long>(ws) <= 32LL * kReachWords * kChunk &&
                  C % 2 == 0 && C <= 64 && vec > 0 && C % vec == 0 &&
                  smem_bytes == Smem(tile, C, D).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 64)
    return static_cast<int>(launch_tile<64>(vec, fr, fs, base, sigma, out, V,
                                            h_r, w_r, ws, C, D, sm,
                                            smem_bytes, st));
  if (tile == 32)
    return static_cast<int>(launch_tile<32>(vec, fr, fs, base, sigma, out, V,
                                            h_r, w_r, ws, C, D, sm,
                                            smem_bytes, st));
  return static_cast<int>(launch_tile<16>(vec, fr, fs, base, sigma, out, V,
                                          h_r, w_r, ws, C, D, sm, smem_bytes,
                                          st));
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
