// Rectified epipolar band resample ("epiband") for Hopper (sm_90a): the
// forward and its two backward kernels.
//
// Forward. Replaces the TPU kernels of the JAX package's ops/pallas/epiband.py
// reached from _epiband_fwd_impl: _epiband_kernel (dynamic base),
// _epiband_kernel_static (base == 0) and _epiband_kernel_chunked
// (hypothesis-chunked windows). One kernel template covers all three, for
// bf16 and fp32 features: for each view v, rect row y, pixel x and
// hypothesis k
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
// set by the bytes. The TPU kernels built a full G tile on the MXU (for
// fp32 features at Precision.HIGHEST, a multi-pass bf16 product) and
// selected the band with barrel rolls and hat-matrix segment sums because
// Mosaic cannot gather.
//
// Design: a G tile on the tensor cores, one kernel template for both
// feature types (epiband_mma_kernel<T, ...>). A warp per pixel that forms
// only the 2*D dot products a pixel needs (the first design, for both types)
// spends, for every output, two source-row loads, a 5-step shuffle
// reduction and the position arithmetic in every lane: it is bound by
// instruction issue, 17-33x its byte bound. Here a block (256 threads) takes
// one view v, rect row y, a tile of `tile` rect pixels and `hyps` of the D
// hypotheses (all D unless the tile's outputs would not fit: each thread
// keeps at most 16 outputs in registers). bf16 takes tile 64 for D <= 64,
// 32 or 16 for wider D; fp32 always tile 64, and for D > 64 the fewest equal
// groups of hypotheses, one block each. A block
//   1. stages the tile's fr rows (tile x C, zero-padded to a multiple of
//      16 channels) in shared memory with cp.async;
//   2. computes each output's tap position once, in the plain version's
//      rounding order (__fsub_rn/__fadd_rn/__fmul_rn, no contraction: a
//      floor that flips moves a tap a whole column), and marks, in a shared
//      bitmap, the chunks of the source row (128 columns for bf16, 64 for
//      fp32) that an in-band tap reaches: out-of-band, far and NaN positions
//      mark nothing, so they neither widen the band nor cost a chunk. A
//      thread keeps its outputs' positions in registers with lanes across
//      pixels and warps across hypotheses, so the 32 outputs of one warp
//      slot sit at one hypothesis of consecutive pixels and reach one or two
//      chunks; lane i holds slot i's chunk range;
//   3. walks the reached chunks in order, double-buffered: while chunk i is
//      used, cp.async brings chunk i+1 into the other buffer; for chunk i
//      the block forms G = Fr_tile . Fs_chunk^T into a shared fp32 tile,
//      and each warp
//      adds, for the slots a ballot finds in the chunk, every output's
//      weighted G term of its taps there. A tap pair that straddles two
//      chunks adds (1 - f) G(i0) in the first and f G(i0 + 1) in the next;
//      both start from 0 and add in that order, so the sum is the plain
//      version's (1 - f) G(i0) + f G(i0 + 1), rounded the same way;
//   4. writes the tile's outputs through shared memory, so that they leave
//      once, coalesced.
// bf16 forms G with mma.sync m16n8k16 (bf16 in, fp32 accumulate; A
// fragments from ldmatrix, held in registers for the whole walk). fp32
// forms it as a split product, 3xTF32: each value v = hi + lo in two TF32
// values, G = A_lo B_hi + A_hi B_lo + A_hi B_hi with mma.sync m16n8k8 (TF32
// in, fp32 accumulate), ~2^-22 relative. A single TF32 pass (~2^-11
// relative per operand) is not fp32 arithmetic and is never used: it would
// not hold the fp32 forward's rtol 1e-4 / atol 1e-3. Three passes of half
// the bf16 depth make 6x the bf16 kernel's mma instructions over the same
// tile, and every operand is split before use; so the fp32 form reads A
// from shared memory at each step instead of holding it, which lets three
// blocks share an SM.
// The dense G tile computes more dot products than the taps need (a stage-0
// tile's band is about tile + s_max columns, of which 2*D are read): at the
// inference plan's stage 0 about 22 GFLOP with bf16 features against the
// 0.16 GB the function moves, under the tensor cores' ridge, so the bytes
// still bound the bf16 kernel in principle; the fp32 kernel's three passes
// over the same tile make the tensor cores' rate the nearer limit. The
// source band is staged in chunks, never whole: a bf16 row at ws = 2448
// (313 KB) does not fit a block's 227 KB. bf16's bitmap has a fixed 64 words (ws <= 2048 chunks); fp32's a bit
// per chunk of the row, so it takes any ws. The tile, the copy width (`vec`
// channels, 16 bytes where C and the alignment allow) and the shared-memory
// bytes come from the wrapper's launch_geometry; the launcher refuses bytes
// that differ from Smem's.
//
// Backward. Replaces the kernels reached from _epiband_bwd_impl
// (_epiband_bwd_kernel, _epiband_bwd_kernel_chunked,
// _epiband_bwd_kernel_static, with _d_window): given dout (V,h_r,w_r,D) fp32
//
//   dfr[v,y,x,:] = sum_k dout[k] * ((1-f) ok0 fs[i0] + f ok1 fs[i0+1])
//   dfs[v,y,s,:] = sum_{x,k} dout[x,k] * hat-weight(x,k,s) * fr[v,y,x,:]
//
// with the forward's positions, recomputed in its rounding order. base and
// sigma get no gradient. Both kernels form dG[c], a pixel's weight on source
// column c, as the sum over its in-band taps on c, rounding to bf16 where the
// TPU kernels do for bf16 features: dout, each tap's weight * dout, and dG.
// Both move the same bytes as the forward plus dout (V,h_r,w_r,D) fp32 read
// once and the gradient written once: bound by bytes, like the forward.
//
// epiband_bwd_dfr gathers, for each rect pixel, dG[c] * fs[c] over the
// columns its taps reach. The position arithmetic is done once per (pixel,
// hypothesis), never per channel. A block (kDfrWarps warps) takes one view
// v, rect row y and a tile of `tile` pixels (32), a warp two at a time:
//   A. for each pixel, lanes across hypotheses form its tap records and dG
//      columns with the device functions the dfs kernel uses (tap_record,
//      run_columns, reverse_runs; see phase A below): the first lane of each
//      run owns its columns and sums their dG. The lanes then list the
//      in-row columns with their dG, in ascending k (a run's column c before
//      c + 1), without gaps: a ballot counts where each lane writes. At the
//      training plan's stage 0 (sigma 2.4-7.5) the list is mostly the taps
//      themselves; where runs share columns (stage 1, sigma 0.5-1.5) a
//      column is listed once, which about halves the list.
//   B. a half-warp per pixel walks its list. Each lane holds four channels:
//      one 4-channel vector where C % 4 == 0 and the alignment allows it,
//      else the channel pairs at 2i and 32 + 2i. For each record it reads
//      the record (a broadcast), loads fs[c]'s four channels through the
//      read-only path and does four fp32 multiply-adds; eight records'
//      loads are in flight at once.
// Each lane writes its four channels once, in the features' type. What
// bounds it now is instruction issue and the L1 data path, not the bytes:
// per record a half-warp moves a C-wide row of fs from L1 and spends two
// instructions per channel (the bf16 unpack and the multiply-add), and
// phase A spends a few hundred instructions per pixel. Neighbouring pixels
// reach mostly the same columns: a probe whose loads all hit the same few
// rows took as long, so L1 misses do not bound phase B, and the columns are
// not staged in shared memory. Summation order: ascending k, a column's left
// tap before its right tap. Where no column has two taps (stage 0) that is
// the warp-per-pixel kernel's order, tap by tap, so dfr rounds as it did.
// Where runs share columns it differs: that kernel walked the columns in
// descending order, and in fp32 it added tap by tap instead of each
// column's dG, so its fp32 sums may differ in the last bits. dG itself
// rounds as before. The tile, the channel layout (vec) and the shared-memory
// bytes come from the wrapper's dfr_launch_geometry; the launcher refuses
// bytes that differ from DfrSmem's.
//
// epiband_bwd_dfs sums over the pixels of a rect row, into the source row:
// the TPU kernels accumulated it in a VMEM block revisited by the grid.
// Scattering dG[c] * fr into memory costs a read-modify-write per pixel,
// column and channel, and on this card an fp32 atomicAdd to shared memory
// is itself a compare-and-swap loop (ATOMS.CAST.SPIN), so no sum goes
// through memory here: each output column is owned by one lane, which
// keeps its C sums in registers and gathers the pixels that reach it.
//
// A block (kDfsWarps warps) takes one view v, rect row y and window of up
// to 32 * kDfsWarps source columns, 32 a warp, one a lane. It finds the
// row's pixels whose taps can reach the window (the columns between their
// first and last hypotheses' taps meet it; a NaN or far position meets
// none), packs them into a candidate list, and walks the list in chunks of
// kDfsChunk pixels, each in two phases:
//   A. each warp stages kDfsSlots pixels of the chunk: their fr rows, and
//      their dG rows over the window in shared memory (fp32, zeros where
//      no tap lands), marking in each column group's mask which pixels
//      reach it. For a pixel, the lanes (across hypotheses) form each
//      hypothesis's taps: the floor of its position (clamped to [-2,
//      ws + 1]) and the rounded weights of its left and right taps. The
//      positions fall as k grows (sigma >= 0), so the taps on column c are
//      one run of k whose floor is c (left taps) and the next, whose floor
//      is c - 1 (right taps): the first lane of each run sums them in
//      ascending k, left taps first (the plain version's order, so dG
//      rounds as it does) and writes dG[c] (and dG[c + 1] where no run has
//      floor c + 1). A negative sigma has one lane sum the row in the plain
//      version's order. The device functions tap_record, run_columns and
//      reverse_runs do this for both gradient kernels.
//   B. each warp adds, for its 32 columns, dG * fr of the pixels in its
//      mask, in pixel order, into its lanes' registers (fr read from
//      shared memory as 16-byte vectors, the same for every lane).
// Two buffers of dG rows, fr rows and masks take chunks in turn, so one
// barrier a chunk separates the phases and a warp's phase B overlaps
// other warps' next phase A. At the end each lane writes its column's C
// values once, in the features' type: no atomics, no zeroed buffer, no cast
// pass, and the sums meet in the same order on every run. What bounds it
// is the gather: C multiply-adds per pixel and column in the pixel's span
// (the columns between its first and last taps, reached or not) and phase
// A's latency, not the bytes. The window (a multiple of 32 columns) and the
// shared-memory bytes come from the wrapper's dfs_launch_geometry; the
// launcher refuses bytes that differ from DfsSmem's.
//
// Exported with a plain C interface (loaded with ctypes). Each launch runs on
// the caller's stream and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps per block of the forward
constexpr int kThreads = kWarps * 32;
constexpr int kMaxOut = 16;            // outputs per thread: tile * hyps <= kThreads * kMaxOut
constexpr int kReachWords = 64;        // bf16: reached-chunk bitmap, ws <= 2048 chunks
constexpr int kLocalChunks = 64;       // chunks a thread marks in registers first
constexpr int kFp32Tile = 64;          // fp32: rect pixels per block
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use

__device__ __forceinline__ float2 load_pair(const float* p, int i) {
  return __ldg(reinterpret_cast<const float2*>(p) + i);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, int i) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p) + i));
}

// ---- forward: a G tile on the tensor cores ----------------------------------

using bf16 = __nv_bfloat16;

// Source columns per staged chunk (and its log2) of each feature type, and
// the blocks an SM should hold (which caps a thread's registers): an fp32
// row is twice as wide, so its chunks are half as long, and three blocks'
// layouts (74 KB at C = 64) and registers (85 a thread) fit an SM; bf16
// keeps two.
template <typename T>
struct Fwd {
  static constexpr int kChunk = 64, kShift = 6, kMinBlocks = 3;
};

template <>
struct Fwd<bf16> {
  static constexpr int kChunk = 128, kShift = 7, kMinBlocks = 2;
};

__host__ __device__ constexpr int padded_channels(int C) { return (C + 15) & ~15; }

// Words of the reached-chunk bitmap: bf16 a fixed kReachWords; fp32 one bit
// per chunk of the row, so any ws fits.
__host__ __device__ inline int reach_words(int ws, bool bf16_features) {
  return bf16_features ? kReachWords
                       : ((ws + Fwd<float>::kChunk - 1) / Fwd<float>::kChunk + 31) / 32;
}

// The hypotheses a block takes: all D where the tile's outputs fit the
// threads' registers (tile * D <= kThreads * kMaxOut, always for bf16), else
// the fewest equal groups that do, one group per block.
__host__ __device__ inline int hyp_group(int tile, int D) {
  const long long cap = kThreads * kMaxOut;
  const int groups = static_cast<int>((static_cast<long long>(tile) * D + cap - 1) / cap);
  return (D + groups - 1) / groups;
}

// Shared-memory layout (bytes) of the forward, for `tile` pixels, C channels
// of `esize` bytes, `hyps` hypotheses, chunks of `chunk` columns and a
// bitmap of `words`: the fr tile (tile rows), two source-chunk buffers
// (chunk rows each), the fp32 G tile (which at the end holds the output
// tile, rows of os = hyps | 1 floats), the tile's base and sigma, the
// bitmap. A staged row holds the padded channels plus 8 elements: for bf16
// an odd number of 16-byte units, so ldmatrix's eight rows hit distinct
// banks; for fp32 8 words past a multiple of 16, so the float2 fragment
// loads of a half-warp (rows g..g+3, words 2t, 2t+1) hit distinct banks. G
// rows are chunk + 8 floats and output rows an odd number, so a warp's 32
// pixels of one column hit distinct banks.
struct Smem {
  int lds, gs, os, a, b, g, prm, reach, words, total;
  __host__ __device__ Smem(int tile, int C, int hyps, int chunk, int n_words,
                           int esize)
      : lds(padded_channels(C) + 8), gs(chunk + 8), os(hyps | 1), a(0),
        b(tile * lds * esize), g(b + 2 * chunk * lds * esize),
        prm(g + tile * (gs > os ? gs : os) * 4), reach(prm + 2 * tile * 4),
        words(n_words), total(reach + n_words * 4) {}
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
template <int kVec, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int n, int C,
                                           int lds, const CopyWalk& w) {
  for (int r = w.r0, v = w.v0; r < n;) {
    cp_async<kVec * static_cast<int>(sizeof(T))>(dst + r * lds + v * kVec,
                                                 src + r * C + v * kVec);
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
  constexpr int kChunk = Fwd<bf16>::kChunk;
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

// fp32 features: G as a split (3xTF32) product on the tensor cores. One
// TF32 product keeps 10 of fp32's 23 mantissa bits, ~2^-11 relative per
// operand: a single pass errs by more than the fp32 forward's rtol 1e-4 /
// atol 1e-3 allow, and is never used. Each value v is split as v = hi +
// lo, hi = rna_tf32(v), lo = rna_tf32(v - hi) (v - hi is exact), and G =
// A_lo B_hi + A_hi B_lo + A_hi B_hi with mma.sync m16n8k8 (TF32 in, fp32
// accumulate, each product exact): what it drops, A_lo B_lo and lo's own
// rounding, is ~2^-22 relative (test_torch_kernel_geometry.py emulates it).
// The rounding is cvt.rna.tf32.f32's, done in integer operations: half a
// TF32 unit added to the magnitude, the 13 low bits cleared (ties away from
// zero); with the conversion instruction the kernel took 15-20% longer on
// an H100 (benchmarks/port_epiband_probe.py, cvt_split).
__device__ __forceinline__ unsigned rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a . b for one m16n8k8 tile: TF32 in, fp32 accumulate
__device__ __forceinline__ void mma1688(float* d, const unsigned* a,
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sG[m][n] = <sA[m], sB[n]> for fp32 features: warp w takes m-tile w % mt
// (its rows of sA from a_row on) and its share of the chunk's 8-column
// n-tiles, four at a time. Per 8-channel step the warp loads and splits its
// A fragment {a0, a1, a2, a3} = rows (g, g + 8, g, g + 8) at k (t, t, t + 4,
// t + 4) and each B fragment {b0, b1} = column g at k (t, t + 4), one
// float2 each: a thread's k positions t and t + 4 are channels 2t and 2t + 1
// in A and B alike, so G sums the same channels. Then the three products,
// the small ones first, four independent tiles in a row. A is read from
// shared memory at every step, not held in registers: 64 registers of
// split A fragments would leave room for two blocks an SM, not three.
__device__ __forceinline__ void g_tile_tf32(const float* a_row,
                                            const float* sB, float* sG,
                                            int mt, int ksteps, int lds,
                                            int gs) {
  constexpr int kChunk = Fwd<float>::kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % mt) * 16;
  const int per_warp = kChunk / 8 * mt / kWarps;
  const int n_first = (warp / mt) * per_warp;
  for (int i0 = 0; i0 < per_warp; i0 += 4) {
    float d[4][4] = {};
    const float* b_row = sB + ((n_first + i0) * 8 + g) * lds + 2 * t;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < ksteps) {
        unsigned ah[4], al[4];
        const float2 u = *reinterpret_cast<const float2*>(a_row + ks * 8);
        const float2 w =
            *reinterpret_cast<const float2*>(a_row + 8 * lds + ks * 8);
        split_tf32(u.x, ah[0], al[0]);
        split_tf32(w.x, ah[1], al[1]);
        split_tf32(u.y, ah[2], al[2]);
        split_tf32(w.y, ah[3], al[3]);
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 b = *reinterpret_cast<const float2*>(
              b_row + i * 8 * lds + ks * 8);
          split_tf32(b.x, bh[i][0], bl[i][0]);
          split_tf32(b.y, bh[i][1], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(d[i], al, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(d[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(d[i], ah, bh[i][0], bh[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* o = sG + (m0 + g) * gs + (n_first + i0 + i) * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(d[i][0], d[i][1]);
      *reinterpret_cast<float2*>(o + 8 * gs) = make_float2(d[i][2], d[i][3]);
    }
  }
}

// The A fragments of a warp's m-tile for the whole walk, and its G tile per
// chunk, for each feature type: fp32, the rows of sA, split at every use,
// and m16n8k8 over 8-channel steps; bf16, ldmatrix fragments held in
// registers and m16n8k16 over 16-channel steps.
template <typename T>
struct Frags {
  const float* row;
  static __device__ int steps(int C) { return (C + 7) >> 3; }
  __device__ void load(const float* sA, int mt, int ksteps, int lds) {
    const int lane = threadIdx.x & 31;
    row = sA + ((threadIdx.x >> 5) % mt * 16 + (lane >> 2)) * lds +
          2 * (lane & 3);
  }
  __device__ void g(const float* sB, float* sG, int mt, int ksteps, int lds,
                    int gs) const {
    g_tile_tf32(row, sB, sG, mt, ksteps, lds, gs);
  }
};

template <>
struct Frags<bf16> {
  unsigned f[4][4];
  static __device__ int steps(int C) { return padded_channels(C) >> 4; }
  __device__ void load(const bf16* sA, int mt, int ksteps, int lds) {
    load_a(f, sA, mt, ksteps, lds);
  }
  __device__ void g(const bf16* sB, float* sG, int mt, int ksteps, int lds,
                    int gs) const {
    g_tile(f, sB, sG, mt, ksteps, lds, gs);
  }
};

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
// k = k0 + warp + 8 (lane / L) + 8 (32 / L) i, L = min(tile, 32) lanes a
// pixel set: kPixels pixel slots a, kSlots hypothesis slots i. A warp's
// outputs of one slot i then cover consecutive pixels at (nearly) one
// hypothesis, whose taps fall in one or two chunks.
template <int kTile>
struct Slots {
  static constexpr int kLanes = kTile < 32 ? kTile : 32;
  static constexpr int kPixels = kTile / kLanes;
  static constexpr int kSlots = kMaxOut / kPixels;
  static constexpr int kStep = 8 * (32 / kLanes);
};

// block (tile pixels of row y of view v, hypotheses [k0, k0 + hyps) of D);
// see the notes at the top
template <typename T, int kTile, int kVec>
__global__ void __launch_bounds__(kThreads, Fwd<T>::kMinBlocks)
epiband_mma_kernel(const T* __restrict__ fr, const T* __restrict__ fs,
                   const float* __restrict__ base,
                   const float* __restrict__ sigma, float* __restrict__ out,
                   int h_r, int w_r, int ws, int C, int D, int hyps,
                   float s_max) {
  using S = Slots<kTile>;
  constexpr int kChunk = Fwd<T>::kChunk, kShift = Fwd<T>::kShift;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_words = (((ws + kChunk - 1) >> kShift) + 31) >> 5;
  const Smem L(kTile, C, hyps, kChunk, reach_words(ws, kBf16),
               static_cast<int>(sizeof(T)));
  T* sA = reinterpret_cast<T*>(smem + L.a);
  T* sB = reinterpret_cast<T*>(smem + L.b);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  float* sBase = reinterpret_cast<float*>(smem + L.prm);
  float* sSig = sBase + kTile;
  unsigned* sReach = reinterpret_cast<unsigned*>(smem + L.reach);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (D + hyps - 1) / hyps;
  const int tile_i = blockIdx.x / groups;
  const int k0 = (blockIdx.x - tile_i * groups) * hyps;
  const int k_end = min(D, k0 + hyps);
  const int x0 = tile_i * kTile;
  const int n_px = min(kTile, w_r - x0);
  const size_t row = static_cast<size_t>(blockIdx.z) * h_r + blockIdx.y;
  const size_t pix0 = row * w_r + x0;
  const T* src = fs + row * ws * C;
  const CopyWalk walk(C, kVec);

  // zeros in the padded channels and ragged rows of the staged tiles
  for (int i = tid; i < L.g / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < L.words; i += kThreads) sReach[i] = 0u;
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
  const int kl = k0 + warp + 8 * (lane / S::kLanes);
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
      if (x < n_px && k < k_end) {
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
  const int mt = kTile >> 4, ksteps = Frags<T>::steps(C);
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
  Frags<T> af;
  af.load(sA, mt, ksteps, L.lds);
  for (int buf = 0; c >= 0; buf ^= 1) {
    const int cn = next_reached(sReach, c, n_words);
    if (cn >= 0) stage_chunk(cn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: chunk c
    __syncthreads();     // ... for every thread; and sG is free again
    af.g(sB + buf * buf_elems, sG, mt, ksteps, L.lds, L.gs);
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

  // the output tile through shared memory (G's space), out coalesced: rows
  // of n_k = k_end - k0 outputs, D apart
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S::kSlots; ++i) {
    const int k = kl + S::kStep * i;
#pragma unroll
    for (int a = 0; a < S::kPixels; ++a) {
      const int x = xl + 32 * a;
      if (x < n_px && k < k_end) sG[x * L.os + k - k0] = acc[i][a];
    }
  }
  __syncthreads();
  float* dst = out + pix0 * D + k0;
  const int n_k = k_end - k0;
  const int dq = kThreads / n_k, dr = kThreads - dq * n_k;
  int x = tid / n_k, k = tid - x * n_k;
  for (int o = tid; o < n_px * n_k; o += kThreads) {
    dst[x * D + k] = sG[x * L.os + k];
    k += dr;
    x += dq;
    if (k >= n_k) {
      k -= n_k;
      ++x;
    }
  }
}

// ---- backward: tap records and column sums, shared by dfr and dfs -----------

constexpr int kRunLook = 4;       // tap records a run walk reads at once

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

// the forward's tap position of hypothesis k, in its rounding order (no
// fused multiply-add)
__device__ __forceinline__ float tap_position(float xs, float b, float sg,
                                              int k) {
  return __fsub_rn(xs, __fadd_rn(b, __fmul_rn(sg, static_cast<float>(k))));
}

__device__ __forceinline__ void store_two(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_two(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Hypothesis k's tap record, from its output gradient gk: the floor of its
// position, clamped to [-2, ws + 1] (a NaN position gives -2, whose taps
// miss the row), and the bits of its left and right taps' weights
// round((1 - f) * round(gk)) and round(f * round(gk)) (round: to the
// features' type, as the JAX package's backward kernels round dout and the
// hat-weighted products for bf16 features; the identity for fp32).
template <typename T>
__device__ __forceinline__ int4 tap_record(float xs, float b, float sg, int k,
                                           float gk, float last) {
  const float pos = tap_position(xs, b, sg, k);
  const float fl = floorf(pos);
  const float f = __fsub_rn(pos, fl);
  gk = round_as<T>(gk);
  return make_int4(static_cast<int>(fminf(fmaxf(fl, -2.f), last + 2.f)),
                   __float_as_int(
                       round_as<T>(__fmul_rn(__fsub_rn(1.f, f), gk))),
                   __float_as_int(round_as<T>(__fmul_rn(f, gk))), 0);
}

// The columns of a pixel's dG row that the lane of hypothesis k owns, from
// the pixel's D tap records, for sigma >= 0. Every lane of the warp calls
// it, with k = k0 + lane. The positions fall as k grows, so the taps on
// column c are the run of k whose floor is c (left taps), then the run
// whose floor is c - 1 (right taps). The first lane of a run of floor c
// owns column c, and column c + 1 too where no run has floor c + 1: each
// column has one owner. It sums each of its columns in ascending k, left
// taps first (the plain version's order, so dG rounds as it does).
struct RunColumns {
  int c;              // the run's floor
  bool left, right;   // owns column c; owns column c + 1
  float dl, dr;       // their dG, rounded to the features' type
};

template <typename T>
__device__ __forceinline__ RunColumns run_columns(const int4* rec, int D,
                                                  int k, int lane) {
  const int4 r = k < D ? rec[k] : make_int4(INT_MIN, 0, 0, 0);
  const int prev_lane = __shfl_up_sync(0xffffffffu, r.x, 1);
  RunColumns o{r.x, false, false, 0.f, 0.f};
  if (k >= D) return o;
  const int c = r.x;
  const int prev = lane > 0 ? prev_lane : k > 0 ? rec[k - 1].x : INT_MAX;
  if (prev == c) return o;
  // the records after k, kRunLook at a time: the rest of the run of floor
  // c, then the run of floor c - 1
  float sl = __int_as_float(r.y), sr = __int_as_float(r.z);
  bool done = false;
  for (int e = k + 1; !done; e += kRunLook) {
    int4 t[kRunLook];
#pragma unroll
    for (int v = 0; v < kRunLook; ++v)
      t[v] = e + v < D ? rec[e + v] : make_int4(INT_MIN, 0, 0, 0);
#pragma unroll
    for (int v = 0; v < kRunLook; ++v) {  // selects, not branches
      const bool same = !done && t[v].x == c;
      const bool right = !done && t[v].x == c - 1;
      sl = same    ? sl + __int_as_float(t[v].y)
           : right ? sl + __int_as_float(t[v].z)
                   : sl;
      sr = same ? sr + __int_as_float(t[v].z) : sr;
      done = !(same || right);
    }
  }
  o.left = true;
  o.right = prev != c + 1;
  o.dl = round_as<T>(sl);
  o.dr = round_as<T>(sr);
  return o;
}

// A negative sigma reverses the runs (the positions rise with k): one lane
// walks them in ascending k and calls emit(c, dG[c]) for each column an
// in-row or out-of-row tap lands on, in ascending c, summed in the plain
// version's order: the left taps on c (the run of floor c), then the right
// taps (the run of floor c - 1, the run before).
template <typename T, typename Emit>
__device__ __forceinline__ void reverse_runs(const int4* rec, int D,
                                             Emit emit) {
  int pc = INT_MIN, ps = 0, pe = 0;  // the previous run: floor, [ps, pe)
  for (int k = 0; k < D;) {
    const int c = rec[k].x;
    int e = k + 1;
    while (e < D && rec[e].x == c) ++e;
    float s = 0.f;
    for (int j = k; j < e; ++j) s += __int_as_float(rec[j].y);
    if (pc == c - 1)
      for (int j = ps; j < pe; ++j) s += __int_as_float(rec[j].z);
    emit(c, round_as<T>(s));
    if (e >= D || rec[e].x != c + 1) {  // no later run sums column c + 1
      float t = 0.f;
      for (int j = k; j < e; ++j) t += __int_as_float(rec[j].z);
      emit(c + 1, round_as<T>(t));
    }
    pc = c;
    ps = k;
    pe = e;
    k = e;
  }
}

// ---- dfr: column records built once, a channel loop that loads and adds -----

constexpr int kDfrWarps = 8;      // a block's warps: two pixels at a time each
constexpr int kDfrThreads = kDfrWarps * 32;
constexpr int kDfrAhead = 2;      // dout values per lane loaded before use
constexpr int kDfrBatch = 8;      // column records a lane's loads take at once

// Shared-memory layout (bytes) of epiband_bwd_dfr, per warp: the tap records
// of one pixel (D int4, as dfs's) and the column records of two (2 D int2
// each: the column and the bits of its dG, listed without gaps).
struct DfrSmem {
  int taps, cols, total;
  __host__ __device__ explicit DfrSmem(int D)
      : taps(kDfrWarps * D * 16), cols(kDfrWarps * 2 * 2 * D * 8),
        total(taps + cols) {}
};

__device__ __forceinline__ float2 bf16_pair(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// p + off elements as one wide multiply-add: left to itself the compiler
// forms each of phase B's addresses from the kernel's fs pointer in four
// instructions
template <typename T>
__device__ __forceinline__ const T* at(const T* p, unsigned off) {
  const T* q;
  asm("mad.wide.u32 %0, %1, %2, %3;"
      : "=l"(q)
      : "r"(off), "r"(static_cast<unsigned>(sizeof(T))), "l"(p));
  return q;
}

// A lane's four channels of the row at element offset off, as floats: one
// 4-channel vector at p0 + off (kVec == 4), or the channel pairs at p0 + off
// and p1 + off (kVec == 2).
template <int kVec, typename T>
__device__ __forceinline__ void load_quad(const T* p0, const T* p1,
                                          unsigned off, float (&f)[4]) {
  float2 a, b;
  if constexpr (kVec == 4 && sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(at(p0, off)));
    a = make_float2(v.x, v.y);
    b = make_float2(v.z, v.w);
  } else if constexpr (kVec == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(at(p0, off)));
    a = bf16_pair(u.x);
    b = bf16_pair(u.y);
  } else {
    a = load_pair(at(p0, off), 0);
    b = load_pair(at(p1, off), 0);
  }
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

template <int kVec, typename T>
__device__ __forceinline__ void store_quad(T* p, int ch0, int ch1, bool has1,
                                           const float (&f)[4]) {
  if constexpr (kVec == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p + ch0) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (kVec == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(p + ch0) =
        make_uint2(*reinterpret_cast<const unsigned*>(&a),
                   *reinterpret_cast<const unsigned*>(&b));
  } else {
    store_two(p + ch0, f[0], f[1]);
    if (has1) store_two(p + ch1, f[2], f[3]);
  }
}

// block (tile pixels of row y of view v); see the notes at the top. Warp w
// takes the tile's pixels 2w + 16i and 2w + 16i + 1, a pair at a time.
template <typename T, int kVec>
__global__ void __launch_bounds__(kDfrThreads)
epiband_bwd_dfr_kernel(const T* __restrict__ fs, const float* __restrict__ base,
                       const float* __restrict__ sigma,
                       const float* __restrict__ dout, T* __restrict__ dfr,
                       int h_r, int w_r, int ws, int C, int D, float s_max,
                       int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DfrSmem L(D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, hl = lane & 15;
  int4* rec = reinterpret_cast<int4*>(smem) + warp * D;
  int2* cols = reinterpret_cast<int2*>(smem + L.taps) + warp * 2 * 2 * D;
  const size_t row = static_cast<size_t>(blockIdx.z) * h_r + blockIdx.y;
  const T* src = fs + row * ws * C;
  const float last = static_cast<float>(ws - 1);
  const int x_end = min(w_r, static_cast<int>(blockIdx.x + 1) * tile);
  // this lane's channels in phase B: ch0 .. ch0 + 3, or pairs ch0 and ch1;
  // a lane past C loads the row's first channels and stores nothing, so
  // that no load is predicated
  const int ch0 = kVec == 4 ? 4 * hl : 2 * hl;
  const int ch1 = kVec == 4 ? ch0 + 2 : 32 + 2 * hl;
  const bool has0 = ch0 < C, has1 = ch1 < C;
  const T* src0 = src + (has0 ? ch0 : 0);
  const T* src1 = src + (has1 ? ch1 : 0);

  for (int x0 = blockIdx.x * tile + 2 * warp; x0 < x_end;
       x0 += 2 * kDfrWarps) {
    // the pair's base, sigma and first dout values, loaded before use
    float b[2], sg[2], g[2][kDfrAhead];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = x0 + h < x_end;
      const size_t pix = row * w_r + (in ? x0 + h : x0);
      b[h] = in && base != nullptr ? base[pix] : 0.f;
      sg[h] = in ? sigma[pix] : 0.f;
#pragma unroll
      for (int j = 0; j < kDfrAhead; ++j)
        g[h][j] = in && lane + 32 * j < D ? dout[pix * D + lane + 32 * j] : 0.f;
    }

    // A. each pixel's column records, lanes across hypotheses: its tap
    // records, then the columns each run's first lane owns, listed in
    // ascending k (column c before c + 1) without gaps, each as its row's
    // element offset c * C and its dG; columns outside [0, ws - 1] are
    // left out
    int n[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (x0 + h >= x_end) continue;  // uniform across the warp
      const size_t pix = row * w_r + x0 + h;
      const float xs = __fadd_rn(static_cast<float>(x0 + h), s_max);
#pragma unroll
      for (int j = 0; j < kDfrAhead; ++j) {
        const int k = lane + 32 * j;
        if (k < D) rec[k] = tap_record<T>(xs, b[h], sg[h], k, g[h][j], last);
      }
      for (int k = lane + 32 * kDfrAhead; k < D; k += 32)
        rec[k] = tap_record<T>(xs, b[h], sg[h], k, dout[pix * D + k], last);
      __syncwarp();
      int2* col = cols + h * 2 * D;
      if (sg[h] >= 0.f) {
        for (int k0 = 0; k0 < D; k0 += 32) {
          const RunColumns r = run_columns<T>(rec, D, k0 + lane, lane);
          const bool cl = r.left && r.c >= 0 && r.c <= ws - 1;
          const bool cr = r.right && r.c >= -1 && r.c <= ws - 2;
          const unsigned bl = __ballot_sync(0xffffffffu, cl);
          const unsigned br = __ballot_sync(0xffffffffu, cr);
          const unsigned below = (1u << lane) - 1u;
          int slot = n[h] + __popc(bl & below) + __popc(br & below);
          if (cl) col[slot++] = make_int2(r.c * C, __float_as_int(r.dl));
          if (cr) col[slot] = make_int2((r.c + 1) * C, __float_as_int(r.dr));
          n[h] += __popc(bl) + __popc(br);
        }
      } else {
        int cnt = 0;
        if (lane == 0)
          reverse_runs<T>(rec, D, [&](int c, float d) {
            if (c >= 0 && c <= ws - 1)
              col[cnt++] = make_int2(c * C, __float_as_int(d));
          });
        n[h] = __shfl_sync(0xffffffffu, cnt, 0);
      }
      __syncwarp();  // the column records are written; rec is free again
    }

    // B. half-warp h adds dG[c] * fs[c] over pixel x0 + h's column records,
    // in their order, into its lanes' four channels: a record (the same for
    // the half-warp), a load of fs[c], four multiply-adds
    const int cnt = half ? n[1] : n[0];
    const int2* col = cols + half * 2 * D;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + kDfrBatch <= cnt; j += kDfrBatch) {
      int2 r[kDfrBatch];
      float v[kDfrBatch][4];
#pragma unroll
      for (int i = 0; i < kDfrBatch; ++i) r[i] = col[j + i];
#pragma unroll
      for (int i = 0; i < kDfrBatch; ++i)
        load_quad<kVec>(src0, src1, r[i].x, v[i]);
#pragma unroll
      for (int i = 0; i < kDfrBatch; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = fmaf(__int_as_float(r[i].y), v[i][q], acc[q]);
    }
    for (; j < cnt; ++j) {
      const int2 r = col[j];
      float v[4];
      load_quad<kVec>(src0, src1, r.x, v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = fmaf(__int_as_float(r.y), v[q], acc[q]);
    }
    // each lane's channels, once, in the features' type
    if (x0 + half < x_end && has0)
      store_quad<kVec>(dfr + (row * w_r + x0 + half) * C, ch0, ch1, has1, acc);
    __syncwarp();  // the pair's column records are consumed
  }
}

// ---- dfs: column groups that gather their pixels ----------------------------

constexpr int kDfsWarps = 8;      // a block's warps: a 32-column group each
constexpr int kDfsThreads = kDfsWarps * 32;
constexpr int kDfsChunk = 32;     // pixels whose dG rows are staged at once
constexpr int kDfsSlots = kDfsChunk / kDfsWarps;  // a warp's pixels of a chunk
constexpr int kDfsAhead = 2;      // dout values per lane loaded before use
constexpr int kDfsPass = 2 * kDfsThreads;  // pixels a candidate pass checks

// Staged fr rows hold the channels padded to 16 bytes, so that a row is read
// as 16-byte vectors.
__host__ __device__ constexpr int fr_stride(int C, int esize) {
  return (C * esize + 15) / 16 * (16 / esize);
}

// Shared-memory layout (bytes) of epiband_bwd_dfs: the tap records of each
// warp's slots (D each: an int4 of the floor of the hypothesis's position,
// clamped to [-2, ws + 1], and the bits of its left and right taps' rounded
// weights); two buffers, for chunks in turn, of the chunk's dG rows over the
// window (fp32), its fr rows (the features' type) and each column group's
// mask of the chunk's pixels that reach it; the pass's candidate pixels (x,
// first and last column in the window, base and sigma) and a count per
// warp.
struct DfsSmem {
  int rows, frs, masks, cand, total;
  __host__ __device__ DfsSmem(int window, int C, int D, int esize)
      : rows(kDfsChunk * D * 16),
        frs(rows + 2 * kDfsChunk * window * 4),
        masks(frs + 2 * kDfsChunk * fr_stride(C, esize) * esize),
        cand(masks + 2 * kDfsWarps * 4),
        total(cand + kDfsPass * 5 * 4 + 2 * kDfsWarps * 4) {}
};

// the 16-byte vector q of a staged fr row as floats (8 bf16 or 4 fp32)
__device__ __forceinline__ void unpack16(const __nv_bfloat16* row, int q,
                                         float* f) {
  const uint4 u = reinterpret_cast<const uint4*>(row)[q];
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack16(const float* row, int q, float* f) {
  const float4 v = reinterpret_cast<const float4*>(row)[q];
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// block (column window) x rect row y x view v; see the notes at the top.
// kChan >= C channels of a column's sums in each lane's registers.
template <typename T, int kChan>
__global__ void __launch_bounds__(kDfsThreads, 2)
epiband_bwd_dfs_kernel(const T* __restrict__ fr, const float* __restrict__ base,
                       const float* __restrict__ sigma,
                       const float* __restrict__ dout, T* __restrict__ dfs,
                       int h_r, int w_r, int ws, int C, int D, float s_max,
                       int window) {
  constexpr int kEsize = static_cast<int>(sizeof(T));
  constexpr int kVec = 16 / kEsize;  // channels per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const DfsSmem L(window, C, D, kEsize);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int4* recs = reinterpret_cast<int4*>(smem) + warp * kDfsSlots * D;
  const int cs = fr_stride(C, kEsize);
  int* cand_x = reinterpret_cast<int*>(smem + L.cand);
  int* cand_lo = cand_x + kDfsPass;
  int* cand_hi = cand_lo + kDfsPass;
  float* cand_b = reinterpret_cast<float*>(cand_hi + kDfsPass);
  float* cand_sg = cand_b + kDfsPass;
  int* warp_count = reinterpret_cast<int*>(cand_sg + kDfsPass);

  const int c0 = blockIdx.x * window;  // the window's first column
  const int ncols = min(window, ws - c0);
  const size_t row = static_cast<size_t>(blockIdx.z) * h_r + blockIdx.y;
  const float last = static_cast<float>(ws - 1);
  const float win_lo = static_cast<float>(c0);
  const float win_hi = static_cast<float>(c0 + ncols - 1);

  for (int i = tid; i < L.cand / 4; i += kDfsThreads)
    reinterpret_cast<unsigned*>(smem)[i] = 0u;  // rows, fr padding, masks
  // the columns this warp last wrote in each buffer's rows of its slots
  int zero_lo[2][kDfsSlots], zero_hi[2][kDfsSlots];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int s = 0; s < kDfsSlots; ++s) {
      zero_lo[u][s] = 0;
      zero_hi[u][s] = -1;
    }
  float acc[kChan];
#pragma unroll
  for (int ch = 0; ch < kChan; ++ch) acc[ch] = 0.f;
  const int col = 32 * warp + lane;  // this lane's column in the window
  const bool group = 32 * warp < ncols;
  int chunk = 0;  // chunks staged so far: buffer chunk & 1

  for (int p0 = 0; p0 < w_r; p0 += kDfsPass) {
    // the pass's pixels that reach the window: the columns between their
    // first and last hypotheses' taps meet it (a NaN position meets none);
    // two a thread, listed in pixel order
    int lo[2], hi[2];
    float b[2], sg[2];
    unsigned m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = p0 + h * kDfsThreads + tid;
      lo[h] = 1;
      hi[h] = 0;
      b[h] = sg[h] = 0.f;
      if (x < w_r) {
        const size_t pix = row * w_r + x;
        b[h] = base != nullptr ? base[pix] : 0.f;
        sg[h] = sigma[pix];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = p0 + h * kDfsThreads + tid;
      if (x < w_r) {
        const float xs = __fadd_rn(static_cast<float>(x), s_max);
        const float q0 = tap_position(xs, b[h], sg[h], 0);
        const float q1 = tap_position(xs, b[h], sg[h], D - 1);
        const float l = fmaxf(floorf(fminf(q0, q1)), win_lo);
        const float e = fminf(floorf(fmaxf(q0, q1)) + 1.f, win_hi);
        if (q0 == q0 && q1 == q1 && l <= e) {
          lo[h] = static_cast<int>(l);
          hi[h] = static_cast<int>(e);
        }
      }
      m[h] = __ballot_sync(0xffffffffu, lo[h] <= hi[h]);
    }
    __syncthreads();  // the previous pass's candidates are consumed
    if (lane == 0) {
      warp_count[warp] = __popc(m[0]);
      warp_count[kDfsWarps + warp] = __popc(m[1]);
    }
    __syncthreads();
    int n_cand = 0;
    int before[2] = {0, 0};
    for (int w = 0; w < 2 * kDfsWarps; ++w) {
      before[0] += w < warp ? warp_count[w] : 0;
      before[1] += w < kDfsWarps + warp ? warp_count[w] : 0;
      n_cand += warp_count[w];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (lo[h] <= hi[h]) {
        const int q = before[h] + __popc(m[h] & ((1u << lane) - 1u));
        cand_x[q] = p0 + h * kDfsThreads + tid;
        cand_lo[q] = lo[h];
        cand_hi[q] = hi[h];
        cand_b[q] = b[h];
        cand_sg[q] = sg[h];
      }
    }
    __syncthreads();

    for (int q0 = 0; q0 < n_cand; q0 += kDfsChunk, ++chunk) {
      const int u = chunk & 1;
      float* rows = reinterpret_cast<float*>(smem + L.rows) + u * kDfsChunk * window;
      T* frs = reinterpret_cast<T*>(smem + L.frs) + u * kDfsChunk * cs;
      unsigned* masks = reinterpret_cast<unsigned*>(smem + L.masks) + u * kDfsWarps;

      // A. each warp stages the dG rows and fr rows of its chunk slots
      // (warp + kDfsWarps * s) in buffer u: first every slot's taps, then
      // every slot's dG row, so that the slots' latencies overlap. Every
      // warp has left the chunk that last used buffer u (it came before
      // the previous chunk's barrier).
      float g[kDfsSlots][kDfsAhead];
      float2 fv[kDfsSlots];
      int px[kDfsSlots];
#pragma unroll
      for (int s = 0; s < kDfsSlots; ++s) {
        const int q = q0 + warp + kDfsWarps * s;
        px[s] = q < n_cand ? cand_x[q] : -1;
        const size_t pix = row * w_r + max(px[s], 0);
#pragma unroll
        for (int j = 0; j < kDfsAhead; ++j)
          g[s][j] = px[s] >= 0 && lane + 32 * j < D ? dout[pix * D + lane + 32 * j] : 0.f;
        fv[s] = px[s] >= 0 && 2 * lane < C ? load_pair(fr + pix * C, lane)
                                           : make_float2(0.f, 0.f);
      }
      // A1. the taps of each slot, lanes across hypotheses
#pragma unroll
      for (int s = 0; s < kDfsSlots; ++s) {
        const int slot = warp + kDfsWarps * s;
        float* drow = rows + slot * window - c0;  // indexed by column
        for (int c = zero_lo[u][s] + lane; c <= zero_hi[u][s]; c += 32) drow[c] = 0.f;
        zero_hi[u][s] = -1;
        if (px[s] < 0) continue;  // uniform across the warp
        const float bi = cand_b[q0 + slot], sgi = cand_sg[q0 + slot];
        const int plo = cand_lo[q0 + slot], phi = cand_hi[q0 + slot];
        zero_lo[u][s] = plo;
        zero_hi[u][s] = phi;
        // the column groups this pixel reaches
        if (lane <= (phi - c0) / 32 - (plo - c0) / 32)
          atomicOr(masks + (plo - c0) / 32 + lane, 1u << slot);
        if (2 * lane < C) store_two(frs + slot * cs + 2 * lane, fv[s].x, fv[s].y);
        const size_t pix = row * w_r + px[s];
        const float xs = __fadd_rn(static_cast<float>(px[s]), s_max);
        int4* rec = recs + s * D;
#pragma unroll
        for (int j = 0; j < kDfsAhead; ++j)
          if (lane + 32 * j < D)
            rec[lane + 32 * j] =
                tap_record<T>(xs, bi, sgi, lane + 32 * j, g[s][j], last);
        for (int k = lane + 32 * kDfsAhead; k < D; k += 32)
          rec[k] = tap_record<T>(xs, bi, sgi, k, dout[pix * D + k], last);
      }
      __syncwarp();

      // A2. the dG row of each slot, lanes across hypotheses: each column
      // of the pixel has one owner (run_columns, reverse_runs), which writes
      // its dG into the pixel's row
#pragma unroll
      for (int s = 0; s < kDfsSlots; ++s) {
        if (px[s] < 0) continue;  // uniform across the warp
        const int slot = warp + kDfsWarps * s;
        float* drow = rows + slot * window - c0;
        const int4* rec = recs + s * D;
        if (cand_sg[q0 + slot] >= 0.f) {
          for (int k0 = 0; k0 < D; k0 += 32) {
            const RunColumns r = run_columns<T>(rec, D, k0 + lane, lane);
            if (r.left && r.c >= c0 && r.c < c0 + ncols) drow[r.c] = r.dl;
            if (r.right && r.c + 1 >= c0 && r.c + 1 < c0 + ncols)
              drow[r.c + 1] = r.dr;
          }
        } else if (lane == 0) {
          reverse_runs<T>(rec, D, [&](int c, float d) {
            if (c >= c0 && c < c0 + ncols) drow[c] = d;
          });
        }
      }
      // one barrier a chunk: after it, buffer u is staged, and every warp
      // has left the previous chunk, whose buffer the next chunk reuses
      __syncthreads();

      // B. each warp adds, for its 32 columns, dG * fr of the chunk's
      // pixels that reach them (its mask), in pixel order, into its lanes'
      // registers, two pixels at a time
      if (group) {
        unsigned bits = masks[warp];
        __syncwarp();
        if (lane == 0) masks[warp] = 0u;
        while (bits) {
          const int s0 = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int s1 = bits ? __ffs(bits) - 1 : s0;
          const float w1 = bits ? 1.f : 0.f;
          bits &= bits - 1u;
          const float d0 = col < ncols ? rows[s0 * window + col] : 0.f;
          const float d1 = col < ncols ? w1 * rows[s1 * window + col] : 0.f;
          const T* f0 = frs + s0 * cs;
          const T* f1 = frs + s1 * cs;
#pragma unroll
          for (int q = 0; q < kChan / kVec; ++q) {
            if (q * kVec < C) {
              float a[kVec], b2[kVec];
              unpack16(f0, q, a);
              unpack16(f1, q, b2);
#pragma unroll
              for (int i = 0; i < kVec; ++i)
                acc[q * kVec + i] =
                    fmaf(d1, b2[i], fmaf(d0, a[i], acc[q * kVec + i]));
            }
          }
        }
      }
    }
  }

  // this lane's column, every channel, once
  if (group && col < ncols) {
    T* dst = dfs + (row * ws + c0 + col) * C;
#pragma unroll
    for (int ch = 0; ch < kChan; ch += 2)
      if (ch < C) store_two(dst + ch, acc[ch], acc[ch + 1]);
  }
}

template <typename T, int kVec>
cudaError_t launch_dfr(const void* fs, const float* base, const float* sigma,
                       const float* dout, void* dfr, int V, int h_r, int w_r,
                       int ws, int C, int D, float s_max, int tile,
                       int smem_bytes, cudaStream_t st) {
  const auto kernel = epiband_bwd_dfr_kernel<T, kVec>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((w_r + tile - 1) / tile, h_r, V);
  kernel<<<grid, kDfrThreads, smem_bytes, st>>>(
      static_cast<const T*>(fs), base, sigma, dout, static_cast<T*>(dfr), h_r,
      w_r, ws, C, D, s_max, tile);
  return cudaGetLastError();
}

template <typename T, int kChan>
cudaError_t launch_dfs(const void* fr, const float* base, const float* sigma,
                       const float* dout, void* dfs, int V, int h_r, int w_r,
                       int ws, int C, int D, float s_max, int window,
                       int smem_bytes, cudaStream_t st) {
  const auto kernel = epiband_bwd_dfs_kernel<T, kChan>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((ws + window - 1) / window, h_r, V);
  kernel<<<grid, kDfsThreads, smem_bytes, st>>>(
      static_cast<const T*>(fr), base, sigma, dout, static_cast<T*>(dfs), h_r,
      w_r, ws, C, D, s_max, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dfs_chan(const void* fr, const float* base,
                            const float* sigma, const float* dout, void* dfs,
                            int V, int h_r, int w_r, int ws, int C, int D,
                            float s_max, int window, int smem_bytes,
                            cudaStream_t st) {
  if (C <= 16)
    return launch_dfs<T, 16>(fr, base, sigma, dout, dfs, V, h_r, w_r, ws, C,
                             D, s_max, window, smem_bytes, st);
  if (C <= 32)
    return launch_dfs<T, 32>(fr, base, sigma, dout, dfs, V, h_r, w_r, ws, C,
                             D, s_max, window, smem_bytes, st);
  return launch_dfs<T, 64>(fr, base, sigma, dout, dfs, V, h_r, w_r, ws, C, D,
                           s_max, window, smem_bytes, st);
}

template <typename T, int kTile, int kVec>
cudaError_t launch_mma(const void* fr, const void* fs, const float* base,
                       const float* sigma, float* out, int V, int h_r,
                       int w_r, int ws, int C, int D, int hyps, float s_max,
                       int smem_bytes, cudaStream_t st) {
  const auto kernel = epiband_mma_kernel<T, kTile, kVec>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((w_r + kTile - 1) / kTile * ((D + hyps - 1) / hyps), h_r,
                  V);
  kernel<<<grid, kThreads, smem_bytes, st>>>(
      static_cast<const T*>(fr), static_cast<const T*>(fs), base, sigma, out,
      h_r, w_r, ws, C, D, hyps, s_max);
  return cudaGetLastError();
}

template <typename T, int kTile>
cudaError_t launch_tile(int vec, const void* fr, const void* fs,
                        const float* base, const float* sigma, float* out,
                        int V, int h_r, int w_r, int ws, int C, int D,
                        int hyps, float s_max, int smem_bytes,
                        cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {  // 16-byte copies: 8 bf16
    if (vec == 8)
      return launch_mma<T, kTile, 8>(fr, fs, base, sigma, out, V, h_r, w_r,
                                     ws, C, D, hyps, s_max, smem_bytes, st);
  }
  if (vec == 4)
    return launch_mma<T, kTile, 4>(fr, fs, base, sigma, out, V, h_r, w_r, ws,
                                   C, D, hyps, s_max, smem_bytes, st);
  if (vec == 2)
    return launch_mma<T, kTile, 2>(fr, fs, base, sigma, out, V, h_r, w_r, ws,
                                   C, D, hyps, s_max, smem_bytes, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 features, 1 = bfloat16 features. C must be even and at
// most 64, and fr/fs aligned to two elements (checked by the Python
// wrapper). tile, vec and smem_bytes come from the wrapper's launch
// geometry (epiband.launch_geometry): bf16 takes tile 16, 32 or 64 with
// tile * D <= 4096 and ws <= 2048 chunks, vec (channels per copy) 8, 4 or 2;
// fp32 takes tile 64, any D (in groups of hyp_group(64, D) hypotheses, a
// block each) and ws, vec 4 or 2; vec must divide C and the features'
// alignment, and smem_bytes equal Smem's total and fit a block, so that a
// layout that drifted from the wrapper's is refused at its first launch.
// Returns a cudaError_t value.
int epiband_forward(const void* fr, const void* fs, const float* base,
                    const float* sigma, float* out, int V, int h_r, int w_r,
                    int ws, int C, int D, int s_max, int dtype, int tile,
                    int vec, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sm = static_cast<float>(s_max);
  const bool bf = dtype == 1;
  bool ok = tile > 0 && D > 0 && ws > 0 && w_r > 0 && C > 0 && C % 2 == 0 &&
            C <= 64 && vec > 0 && C % vec == 0 && smem_bytes <= kMaxSmem &&
            (bf ? (tile == 16 || tile == 32 || tile == 64) &&
                      tile * D <= kThreads * kMaxOut &&
                      static_cast<long long>(ws) <=
                          32LL * kReachWords * Fwd<bf16>::kChunk
                : tile == kFp32Tile && vec <= 4);
  const int hyps = ok ? hyp_group(tile, D) : 0;
  ok = ok && smem_bytes == Smem(tile, C, hyps,
                                bf ? Fwd<bf16>::kChunk : Fwd<float>::kChunk,
                                reach_words(ws, bf), bf ? 2 : 4).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (!bf)
    return static_cast<int>(launch_tile<float, kFp32Tile>(
        vec, fr, fs, base, sigma, out, V, h_r, w_r, ws, C, D, hyps, sm,
        smem_bytes, st));
  if (tile == 64)
    return static_cast<int>(launch_tile<bf16, 64>(vec, fr, fs, base, sigma,
                                                  out, V, h_r, w_r, ws, C, D,
                                                  hyps, sm, smem_bytes, st));
  if (tile == 32)
    return static_cast<int>(launch_tile<bf16, 32>(vec, fr, fs, base, sigma,
                                                  out, V, h_r, w_r, ws, C, D,
                                                  hyps, sm, smem_bytes, st));
  return static_cast<int>(launch_tile<bf16, 16>(vec, fr, fs, base, sigma,
                                                out, V, h_r, w_r, ws, C, D,
                                                hyps, sm, smem_bytes, st));
}

// dfr (V,h_r,w_r,C) in the features' type; every element is written. tile
// (pixels per block, a multiple of 2 * kDfrWarps up to 64), vec (4: each
// lane's channels one vector, which C % 4 == 0 and 4-element alignment of fs
// and dfr allow; else 2) and smem_bytes come from the wrapper's
// dfr_launch_geometry: smem_bytes must equal DfrSmem's total and fit a
// block. C must be even and at most 64, and ws * C below 2^31 (a row's
// column offsets are 32-bit).
int epiband_backward_dfr(const void* fs, const float* base, const float* sigma,
                         const float* dout, void* dfr, int V, int h_r,
                         int w_r, int ws, int C, int D, int s_max, int dtype,
                         int tile, int vec, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = tile > 0 && tile % (2 * kDfrWarps) == 0 && tile <= 64 &&
                  (vec == 4 || vec == 2) && C > 0 && C % vec == 0 &&
                  C <= 64 && ws > 0 && w_r > 0 && D > 0 && h_r > 0 &&
                  h_r <= 65535 && V > 0 && V <= 65535 &&
                  static_cast<long long>(ws) * C <= INT_MAX &&
                  static_cast<long long>(D) * 48 * kDfrWarps <= kMaxSmem &&
                  smem_bytes == DfrSmem(D).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float sm = static_cast<float>(s_max);
  if (dtype == 1)
    return static_cast<int>(
        vec == 4 ? launch_dfr<__nv_bfloat16, 4>(fs, base, sigma, dout, dfr, V,
                                                h_r, w_r, ws, C, D, sm, tile,
                                                smem_bytes, st)
                 : launch_dfr<__nv_bfloat16, 2>(fs, base, sigma, dout, dfr, V,
                                                h_r, w_r, ws, C, D, sm, tile,
                                                smem_bytes, st));
  return static_cast<int>(
      vec == 4 ? launch_dfr<float, 4>(fs, base, sigma, dout, dfr, V, h_r, w_r,
                                      ws, C, D, sm, tile, smem_bytes, st)
               : launch_dfr<float, 2>(fs, base, sigma, dout, dfr, V, h_r, w_r,
                                      ws, C, D, sm, tile, smem_bytes, st));
}

// dfs (V,h_r,ws,C) in the features' type; every element is written. window
// (source columns per block, a multiple of 32 up to 32 * kDfsWarps) and
// smem_bytes come from the wrapper's dfs_launch_geometry: smem_bytes must
// equal DfsSmem's total and fit a block. C must be even and at most 64.
int epiband_backward_dfs(const void* fr, const float* base, const float* sigma,
                         const float* dout, void* dfs, int V, int h_r,
                         int w_r, int ws, int C, int D, int s_max, int dtype,
                         int window, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int esize = dtype == 1 ? 2 : 4;
  const bool ok = window > 0 && window % 32 == 0 && window <= 32 * kDfsWarps &&
                  ws > 0 && w_r > 0 && D > 0 && C > 0 && C % 2 == 0 &&
                  C <= 64 && h_r > 0 && h_r <= 65535 && V > 0 && V <= 65535 &&
                  static_cast<long long>(D) * kDfsChunk * 16 < kMaxSmem &&
                  smem_bytes <= kMaxSmem &&
                  smem_bytes == DfsSmem(window, C, D, esize).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float sm = static_cast<float>(s_max);
  if (dtype == 1)
    return static_cast<int>(launch_dfs_chan<__nv_bfloat16>(
        fr, base, sigma, dout, dfs, V, h_r, w_r, ws, C, D, sm, window,
        smem_bytes, st));
  return static_cast<int>(launch_dfs_chan<float>(
      fr, base, sigma, dout, dfs, V, h_r, w_r, ws, C, D, sm, window,
      smem_bytes, st));
}

const char* epiband_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
