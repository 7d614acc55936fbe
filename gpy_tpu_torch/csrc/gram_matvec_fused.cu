// Fused stationary Gram-matvec (B5) and its gradient moments (B6) for
// Hopper (sm_90a), float32.
//
// B5:  out[i, c] = sum_j K(xs_i, x2s_j) V[j, c]
// B6:  mom = [ sum_ij W_ij K_ij / v,  sum_ij W_ij (-dK/dr2)_ij dx_ij,d^2  (d = 1..D) ]
//      with W = G V' (square Gram: both sides are xs)
//
// K is a stationary family of the squared scaled distance r2 (xs, x2s are the
// lengthscale-scaled inputs): 0 RBF v exp(-r2/2); 1 Matern32
// v (1 + s) exp(-s), s = sqrt(3) r; 2 Matern52 v (1 + s + s^2/3) exp(-s),
// s = sqrt(5) r; 3 Exponential v exp(-r); r = sqrt(r2 + 1e-30) as in the
// reference. v is a one-element device tensor, read on the device.
//
// Replaces the TPU kernels gpy_tpu/ops/pallas_gram_matvec.py:71
// (_pallas_call, pallas_call at :144) and :268 (_pallas_gram_moments,
// pallas_call at :312). Those walk 512x512 tiles in grid order and carry
// the sum in the output block from one grid step to the next; they pad N
// to 512 rows and R to 128 lanes, and use the expansion |x|^2 + |x'|^2 -
// 2 x.x' (clamped) above D = 8.
//
// Here r2 is a sum of direct squared differences (exact; a square Gram's
// diagonal is exactly v) in every kernel but B5's for 8 < D <= 64 and
// R <= 16, which forms it as the TPU kernel does above D = 8, by the
// expansion with the cross term on the tensor cores, and sets it to 0 on
// the diagonal the caller names, so that K_ii is exactly v there too.
// Ragged edges are masked instead of padded, and every index that
// multiplies two extents is 64-bit (N*M is 2.5e9 at N = 50k).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores): at N = M = 50,000, D = 4, R = 9 the kernel reads ~2.6 MB and
// writes 1.8 MB (~1.5 us) but does ~(3D + 3) + 2R = 33 operations per
// entry, 8.3e10 in all (~1.2 ms). It is bound by operations, and the exp of
// every entry also runs on the special-function units.
//
// B5 for D <= 8 and R <= 16 (the main path) is the register-tile kernel
// gram_matvec_tile_kernel below; for 8 < D <= 64 and R <= 16 (the CG of an
// iterative exact GP on more than 8 input dimensions) it is the cross-term
// kernel gram_matvec_cross_kernel: rows staged once, column tiles copied
// ahead with cp.async, the expansion's cross term in 3xTF32 on mma.sync,
// r2, K and the contraction with V on the SIMT cores.
//
// B5 for R > 16 (a predict's n* right-hand sides), any D, and for D > 64
// at any R, is the tensor-core kernel gram_matvec_tc_kernel below: K formed once per block
// of 128 rows and 128 columns of R (twice at R = 256) by producer warps on
// the SIMT cores, split into TF32 hi and lo, and contracted with V's split
// tile in 3xTF32 on wgmma by consumer warps, each tile's product promoted
// once into float32 running sums.
//
// Which contraction runs does not depend on the reference's accum mode
// ("exact", "f32x3", "fast"): R <= 16 contracts in float32 FFMA, R > 16 in
// 3xTF32 with per-tile promotion, each at least as accurate as the
// reference's 3-pass bfloat16 "f32x3" and 1-pass "fast".
//
// B6 for D <= 8 and R <= 16 (the main path) is the register-tile kernel
// gram_moments_tile_kernel below, on B5's column walk. The mma kernel
// gram_moments_mma_kernel takes the rest (D > 8 or R > 16, D <= 127): rows
// staged once, column tiles copied ahead with cp.async, W = G V' in 3xTF32 on
// mma.sync, every dimension in one pass over the columns. In both, each
// thread sums a tile's entries in float and the block adds them into float64
// in a fixed order, one partial row a block; a second one-block kernel sums
// the rows in a fixed order in float64. The gradient repeats bit for bit.
//
// Exponential's -dK/dr2 = v exp(-r) / (2r) is ~5e14 v at r = sqrt(1e-30):
// finite, and it multiplies an exactly-zero dx^2 on the diagonal. The build
// uses no fast-math flag and flushes no denormals, so this stays 0, not
// inf * 0.
//
// What the kernels leave on the table: TMA and a persistent schedule. Where
// the tensor-core kernels' time goes: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;    // threads of a B6 block (both kernels)
constexpr int kMomRow = 128;   // doubles of a B6 partial row: [s0, m_1..m_D], D + 1 <= 128

// Sum each of the block's kBlock threads' NQ values into row[0, NQ) in a
// fixed order (warp shuffles, then warps 0, 1, ... in turn), so a B6
// kernel's partial rows repeat bit for bit; `add` adds them to the row's
// values instead.
template <int NQ>
__device__ __forceinline__ void block_sum(double (&mom)[NQ], double* __restrict__ row, int tid,
                                          bool add) {
  __shared__ double sred[kBlock / 32][NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mom[q] += __shfl_xor_sync(0xffffffffu, mom[q], off);
  const int warp = tid / 32;
  if (tid % 32 == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) sred[warp][q] = mom[q];
  }
  __syncthreads();
  if (tid < NQ) {
    double s = 0.0;
    for (int wi = 0; wi < kBlock / 32; ++wi) s += sred[wi][tid];
    row[tid] = add ? row[tid] + s : s;
  }
}

// out[0] = sum_t s0_t / v; out[1 + dd] = mscale * sum_t m_t,dd (mscale: the
// family's folded constant, moments_scale); the `rows` partial rows summed
// in order.
__global__ void gram_moments_reduce(const double* __restrict__ partial,
                                    const float* __restrict__ var, double* __restrict__ out,
                                    int rows, int d, double mscale) {
  const int q = threadIdx.x;
  if (q > d) return;
  double s = 0.0;
  for (int t = 0; t < rows; ++t) s += partial[static_cast<int64_t>(t) * kMomRow + q];
  out[q] = q == 0 ? s / static_cast<double>(var[0]) : s * mscale;
}

// B5 for D <= 8 and R <= 16 (the main path: D = 4, R = 9), redesigned for
// Hopper. One 256-thread block owns 128 rows, 16 a warp; each thread keeps
// the coordinates of its two rows (g and g + 8 of its warp's 16, g =
// lane / 4) in registers for the whole column walk, DMAX of them, the
// runtime D padded with zeros ((0 - 0)^2 adds exactly 0). The block walks
// X2 in tiles of kCols columns. The raw rows of X2 and V of tile j + 1 are
// copied into shared memory with 16-byte cp.async (the ragged last tile
// zero-filled) while tile j computes, and each tile is re-laid once, after
// it lands: X2's coordinates scaled by the family's constant and padded to
// DMAX, V's rows padded to a multiple of 4, columns past M as zeros. One
// barrier a tile. Per 8-column step a thread forms four entries of K (rows
// g, g + 8 by columns t, t + 4, t = lane % 4) with one ex2.approx each on
// the SFU, K = v * ex2(.) with the multiply by v last (a square Gram's
// diagonal stays exactly v), and adds K V into 2 x RC float32 accumulators
// with FFMA; after the last tile the four lanes that share a row sum them
// with shuffles in a fixed order. V is zero past M, so the ragged last tile
// needs no mask. Each output entry is written once by one thread: no
// atomics, and the result does not depend on scheduling. Every accum mode
// runs this FFMA contraction at R <= 16: a 3xTF32 contraction on the tensor
// cores, its sums never promoted, was slower at R = 9 and moved the CG's
// NLML estimate past its limit (PERF.md, the B5 findings).
constexpr int kTileRows = 128;  // rows a block: 8 warps x 16
constexpr int kTileThreads = kTileRows / 16 * 32;

// Columns a tile: 128, or 64 where four 128-column buffers would pass the
// 48 KB of static shared memory (RC = 16 with DMAX = 8).
template <int RC, int DMAX>
__host__ __device__ constexpr int tile_cols() { return RC == 16 && DMAX == 8 ? 64 : 128; }

// Blocks per SM the register budget is set for: 65,536 / (256 * 3) = 85
// registers a thread, so the 391 blocks of N = 50,000 are resident at once;
// 2 where the 2 RC accumulators and 2 DMAX coordinates pass 26 (RC = 16, or
// RC = 9 with DMAX = 8), which spill at 80.
constexpr int tile_min_blocks(int rc, int dmax) { return 2 * (rc + dmax) > 26 ? 2 : 3; }

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The family's constant, folded into the coordinates: with x' = c x on
// both sides (one rounding each, never fused into an FMA, so equal points
// stay equal and the diagonal's r2 is exactly 0), r2' = c^2 r2 and exp(-a)
// = ex2(-a log2 e) needs no multiply an entry: RBF c^2 = log2(e) / 2, so
// K = v ex2(-r2'); Matern32 and 52 c = sqrt(3) log2(e) and sqrt(5) log2(e),
// Exponential c = log2(e), each on r' = c r = sqrt(r2' + 1e-30), s = r' ln 2.
template <int FAM>
constexpr float kCoordScale = FAM == 0 ? 0.84932180028801904f    // sqrt(log2(e) / 2)
                              : FAM == 1 ? 2.4988211106473432f  // sqrt(3) log2(e)
                              : FAM == 2 ? 3.2259641822295610f  // sqrt(5) log2(e)
                                         : 1.4426950408889634f; // log2(e)
constexpr float kLn2 = 0.69314718055994531f;

// K from the scaled r2' with one ex2.approx on the SFU, the multiply by v
// last; r' = sqrt(r2' + 1e-30) as the reference's r.
template <int FAM>
__device__ __forceinline__ float k_of_r2_fast(float r2, float v) {
  if (FAM == 0) return v * ex2_approx(-r2);
  const float r = sqrt_approx(r2 + 1e-30f);
  const float e = ex2_approx(-r);
  if (FAM == 1) return v * (fmaf(r, kLn2, 1.0f) * e);
  if (FAM == 2) return v * (fmaf(r, fmaf(r, kLn2 * kLn2 / 3.0f, kLn2), 1.0f) * e);
  return v * e;
}

// Copy `count` floats from global `src` (16-byte aligned) to shared `dst`,
// 16 bytes a thread and chunk with cp.async, `kMax` floats at most; a last
// partial chunk reads only its own bytes and zero-fills the rest.
template <int kMax>
__device__ __forceinline__ void copy_async(float* dst, const float* src, int count, int tid) {
#pragma unroll
  for (int it = 0; it < (kMax / 4 + kTileThreads - 1) / kTileThreads; ++it) {
    const int c = tid + it * kTileThreads;
    if (4 * c < count) {
      const int bytes = min(16, 4 * (count - 4 * c));
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(s), "l"(src + 4 * c), "r"(bytes) : "memory");
    }
  }
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// V's row stride in the re-laid tile: RC padded to a multiple of 4 (one at
// RC = 1), so a thread reads a row with 16-byte loads, and to 4 past a
// multiple of 8, so the four rows a warp reads at once (t = 0..3) fall in
// four different quarters of the 32 banks.
template <int RC>
__host__ __device__ constexpr int v_stride() {
  return RC == 1 ? 1 : ((RC + 3) / 4 * 4) % 8 == 0 ? (RC + 3) / 4 * 4 + 4 : (RC + 3) / 4 * 4;
}

// Re-lay one landed tile (`cols` valid columns) for the compute. Each
// thread's share is the same in every tile.
template <int RC, int DMAX>
__device__ __forceinline__ void relayout(float* __restrict__ cx, float* __restrict__ cv,
                                         const float* __restrict__ rx,
                                         const float* __restrict__ rv, float scale, int cols,
                                         int d, int r, int tid) {
  constexpr int kX = tile_cols<RC, DMAX>() * DMAX;
#pragma unroll
  for (int it = 0; it < (kX + kTileThreads - 1) / kTileThreads; ++it) {
    const int i = tid + it * kTileThreads;
    const int j = i / DMAX;
    const int k = i % DMAX;
    if (kX % kTileThreads == 0 || i < kX)
      cx[i] = (j < cols && k < d) ? __fmul_rn(scale, rx[j * d + k]) : 0.0f;
  }
  constexpr int kStride = v_stride<RC>();
  constexpr int kV = tile_cols<RC, DMAX>() * kStride;
#pragma unroll
  for (int it = 0; it < (kV + kTileThreads - 1) / kTileThreads; ++it) {
    const int i = tid + it * kTileThreads;
    const int j = i / kStride;
    const int c = i % kStride;
    if (kV % kTileThreads == 0 || i < kV) cv[i] = (j < cols && c < r) ? rv[j * r + c] : 0.0f;
  }
}

// The column walk of the register-tile kernels (B5 and B6). The block's
// threads walk the M columns of X2 and V in tiles of kCols: the raw rows of
// tile j + 1 are copied into shared memory with 16-byte cp.async (the
// ragged last tile zero-filled) while tile j computes, and each tile is
// re-laid once, after it lands. One barrier a tile. For each 8-column step
// of a tile, step(ya, yb, va, vb) gets the re-laid coordinates (DMAX) and V
// rows (v_stride) of columns 8 s + t and 8 s + t + 4, t = lane % 4; after
// each tile, tile_end().
template <int RC, int DMAX, class Step, class TileEnd>
__device__ __forceinline__ void walk_tiles(const float* __restrict__ x2s,
                                           const float* __restrict__ vmat, float scale,
                                           int64_t m, int d, int r, Step&& step,
                                           TileEnd&& tile_end) {
  constexpr int kCols = tile_cols<RC, DMAX>();
  constexpr int kSteps = kCols / 8;
  constexpr int kStride = v_stride<RC>();
  __shared__ __align__(16) float rx[2][kCols * DMAX];    // raw X2 rows, stride d
  __shared__ __align__(16) float rv[2][kCols * RC];      // raw V rows, stride r
  __shared__ __align__(16) float cx[2][kCols * DMAX];    // X2 rows, stride DMAX
  __shared__ __align__(16) float cv[2][kCols * kStride]; // V rows, stride kStride

  const int tid = threadIdx.x;
  const int t = tid % 4;
  const int64_t tiles = (m + kCols - 1) / kCols;
  auto valid = [&](int64_t tile) {  // the tile's columns inside M
    const int64_t left = m - tile * kCols;
    return static_cast<int>(left < kCols ? left : kCols);
  };
  auto issue = [&](int64_t tile) {
    const int64_t col0 = tile * kCols;
    const int cols = valid(tile);
    copy_async<kCols * DMAX>(rx[tile % 2], x2s + col0 * d, cols * d, tid);
    copy_async<kCols * RC>(rv[tile % 2], vmat + col0 * r, cols * r, tid);
    copy_async_commit();
  };
  if (tiles > 0) {
    issue(0);
    copy_async_wait();
    __syncthreads();
    relayout<RC, DMAX>(cx[0], cv[0], rx[0], rv[0], scale, valid(0), d, r, tid);
    if (tiles > 1) issue(1);
  }
  for (int64_t tile = 0; tile < tiles; ++tile) {
    const int cur = static_cast<int>(tile % 2);
    // tile + 1 has landed; every thread is done with tile - 1's compute
    // buffers and with tile's raw buffers
    copy_async_wait();
    __syncthreads();
    if (tile + 1 < tiles)
      relayout<RC, DMAX>(cx[cur ^ 1], cv[cur ^ 1], rx[cur ^ 1], rv[cur ^ 1], scale,
                         valid(tile + 1), d, r, tid);
    if (tile + 2 < tiles) issue(tile + 2);
    const float4* xt = reinterpret_cast<const float4*>(cx[cur]);
    const float* vt = cv[cur];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float ya[DMAX], yb[DMAX];  // columns 8 s + t and 8 s + t + 4
#pragma unroll
      for (int k = 0; k < DMAX / 4; ++k) {
        const float4 p = xt[(s * 8 + t) * (DMAX / 4) + k];
        const float4 q = xt[(s * 8 + t + 4) * (DMAX / 4) + k];
        ya[4 * k] = p.x; ya[4 * k + 1] = p.y; ya[4 * k + 2] = p.z; ya[4 * k + 3] = p.w;
        yb[4 * k] = q.x; yb[4 * k + 1] = q.y; yb[4 * k + 2] = q.z; yb[4 * k + 3] = q.w;
      }
      float va[kStride], vb[kStride];  // V rows 8 s + t and 8 s + t + 4
      if constexpr (kStride % 4 == 0) {
        const float4* pa = reinterpret_cast<const float4*>(vt) + (s * 8 + t) * (kStride / 4);
#pragma unroll
        for (int c = 0; c < (RC + 3) / 4; ++c) {
          const float4 p = pa[c];
          const float4 q = pa[kStride + c];
          va[4 * c] = p.x; va[4 * c + 1] = p.y; va[4 * c + 2] = p.z; va[4 * c + 3] = p.w;
          vb[4 * c] = q.x; vb[4 * c + 1] = q.y; vb[4 * c + 2] = q.z; vb[4 * c + 3] = q.w;
        }
      } else {
        va[0] = vt[s * 8 + t];
        vb[0] = vt[s * 8 + t + 4];
      }
      step(ya, yb, va, vb);
    }
    tile_end();
  }
}

template <int FAM, int RC, int DMAX>
__global__ void __launch_bounds__(kTileThreads, tile_min_blocks(RC, DMAX))
gram_matvec_tile_kernel(const float* __restrict__ xs, const float* __restrict__ x2s,
                        const float* __restrict__ vmat, const float* __restrict__ var,
                        float* __restrict__ out, int64_t n, int64_t m, int d, int r) {
  constexpr float scale = kCoordScale<FAM>;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int64_t row_a = static_cast<int64_t>(blockIdx.x) * kTileRows + (tid / 32) * 16 + lane / 4;
  const int64_t row_b = row_a + 8;
  const float vv = var[0];

  float xa[DMAX], xb[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    xa[k] = (row_a < n && k < d) ? __fmul_rn(scale, xs[row_a * d + k]) : 0.0f;
    xb[k] = (row_b < n && k < d) ? __fmul_rn(scale, xs[row_b * d + k]) : 0.0f;
  }
  float acc[2 * RC];  // rows a and b, partial over this thread's columns
#pragma unroll
  for (int c = 0; c < 2 * RC; ++c) acc[c] = 0.0f;

  walk_tiles<RC, DMAX>(x2s, vmat, scale, m, d, r, [&](const float* ya, const float* yb,
                                                      const float* va, const float* vb) {
    float k[4];  // (a, 8 s + t), (b, 8 s + t), (a, 8 s + t + 4), (b, 8 s + t + 4)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* x = (q & 1) ? xb : xa;
      const float* y = (q & 2) ? yb : ya;
      float r2 = 0.0f;
#pragma unroll
      for (int e = 0; e < DMAX; ++e) {
        const float diff = x[e] - y[e];
        r2 = fmaf(diff, diff, r2);
      }
      k[q] = k_of_r2_fast<FAM>(r2, vv);
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      acc[c] = fmaf(k[0], va[c], acc[c]);
      acc[RC + c] = fmaf(k[1], va[c], acc[RC + c]);
      acc[c] = fmaf(k[2], vb[c], acc[c]);
      acc[RC + c] = fmaf(k[3], vb[c], acc[RC + c]);
    }
  }, [] {});

  // the four lanes of a row group hold column partial sums: add them
#pragma unroll
  for (int c = 0; c < 2 * RC; ++c) {
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 1);
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 2);
  }
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    if (c % 4 != t || c >= r) continue;
    if (row_a < n) out[row_a * r + c] = acc[c];
    if (row_b < n) out[row_b * r + c] = acc[RC + c];
  }
}

// B6 for D <= 8 and R <= 16 (the main path: D = 4, R = 9), redesigned for
// Hopper on B5's walk (walk_tiles, square: the columns are X's own rows).
// One 256-thread block owns 128 rows, 16 a warp; each thread keeps its two
// rows' folded coordinates (DMAX, zero-padded) and G rows (RC, zero past R,
// times v) in registers for the whole walk. Per entry (rows a, b by columns
// 8 s + t, 8 s + t + 4): q_e = (x'_e - y'_e)^2 on the folded coordinates,
// r2' = sum q_e, one ex2.approx, W' = v (G V')_ij in RC FFMA, then two
// weights (moment_weights): wk = W' K / v into s0, and wn into
// m_e += wn q_e (D FFMA; q_e is reused from r2', not recomputed). V is zero
// past N, so W' is 0 there and the ragged tile needs no mask; padded rows
// have G = 0. The folded constant (q_e = c^2 dx_e^2, and -dK/dr2 = f v e
// p_n(r') for each family) is undone once, in float64, by the reduce:
// m_d = mscale * sum wn q_d, mscale = moments_scale<FAM>(). Each thread sums
// a tile's entries in float32 and adds them to D + 1 float64 sums after the
// tile; block_sum and gram_moments_reduce add those in a fixed order, so the
// result repeats bit for bit. W is FFMA, not the tensor cores: their
// truncating sums failed the fused CG's NLML limit in B5 (PERF.md).
//
// Bound on an H100 SXM at N = 50,000, D = 4, R = 9: 2R + 6D + 5 = 47
// operations an entry (gram_moments_bound), 1.75 ms; the kernel issues
// about as many instructions an entry, so it is bound by issue.
//
// Blocks per SM the register budget is set for, from ptxas on sm_90a: RC = 1
// at DMAX = 4 fits 3 (80 registers); RC = 9 and 16 at DMAX = 4 need 123-128
// (at 3 blocks they spill), so 2; DMAX = 8 above RC = 1 spills even at 128,
// so 1 (PERF.md, the B6 findings).
constexpr int moments_min_blocks(int rc, int dmax) {
  return rc == 1 && dmax == 4 ? 3 : dmax == 8 && rc > 1 ? 1 : 2;
}

// The weights of one entry from the folded r2' and w = v W, with e the
// family's exponential factor ex2(-r2') or ex2(-r'), r' = c r (the guard
// 1e-30 added to r2' as k_of_r2_fast adds it), s = r' ln 2:
//   wk = w K / v: RBF w e; Matern32 w (1 + s) e; Matern52
//   w (1 + s + s^2 / 3) e; Exponential w e;
//   wn = w (-dK/dr2) / (f v): RBF and Matern32 w e, Matern52 w (1 + s) e,
//   Exponential w e / r' (f = 1/2, 3/2, 5/6 and c/2; moments_scale).
// On the diagonal q_e = 0 exactly, so Exponential's finite 1/r' = 1e15
// multiplies 0.
template <int FAM>
__device__ __forceinline__ void moment_weights(float r2, float w, float& wk, float& wn) {
  if (FAM == 0) {
    wk = wn = w * ex2_approx(-r2);
  } else if (FAM == 3) {
    const float x = r2 + 1e-30f;
    const float rs = rsqrt_approx(x);
    wk = w * ex2_approx(-(x * rs));
    wn = wk * rs;
  } else {
    const float r = sqrt_approx(r2 + 1e-30f);
    const float we = w * ex2_approx(-r);
    const float p = fmaf(r, kLn2, 1.0f);
    if (FAM == 1) {
      wk = we * p;
      wn = we;
    } else {
      wk = we * fmaf(r, fmaf(r, kLn2 * kLn2 / 3.0f, kLn2), 1.0f);
      wn = we * p;
    }
  }
}

// m_d = moments_scale * sum wn q_d: -dK/dr2 = f v e p_n, and q_d = c^2 dx_d^2
// with c the float32 kCoordScale, so f / c^2; Exponential's 1/r = c / r'
// leaves f c / c^2 = 1 / (2 c).
template <int FAM>
constexpr double moments_scale() {
  constexpr double c = kCoordScale<FAM>;
  return FAM == 0 ? 0.5 / (c * c) : FAM == 1 ? 1.5 / (c * c)
         : FAM == 2 ? (5.0 / 6.0) / (c * c) : 0.5 / c;
}

template <int FAM, int RC, int DMAX>
__global__ void __launch_bounds__(kTileThreads, moments_min_blocks(RC, DMAX))
gram_moments_tile_kernel(const float* __restrict__ xs, const float* __restrict__ g,
                         const float* __restrict__ vmat, const float* __restrict__ var,
                         double* __restrict__ partial, int64_t n, int d, int r) {
  constexpr float scale = kCoordScale<FAM>;
  const int tid = threadIdx.x;
  const int64_t row_a =
      static_cast<int64_t>(blockIdx.x) * kTileRows + (tid / 32) * 16 + (tid % 32) / 4;
  const int64_t row_b = row_a + 8;
  const float vv = var[0];

  float xa[DMAX], xb[DMAX], ga[RC], gb[RC];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    xa[k] = (row_a < n && k < d) ? __fmul_rn(scale, xs[row_a * d + k]) : 0.0f;
    xb[k] = (row_b < n && k < d) ? __fmul_rn(scale, xs[row_b * d + k]) : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    ga[c] = (row_a < n && c < r) ? vv * g[row_a * r + c] : 0.0f;
    gb[c] = (row_b < n && c < r) ? vv * g[row_b * r + c] : 0.0f;
  }
  double mom[DMAX + 1];  // [s0, m_1..m_DMAX] over the walk
#pragma unroll
  for (int q = 0; q <= DMAX; ++q) mom[q] = 0.0;
  float s0 = 0.0f, mt[DMAX];  // the same over one tile
#pragma unroll
  for (int e = 0; e < DMAX; ++e) mt[e] = 0.0f;

  walk_tiles<RC, DMAX>(xs, vmat, scale, n, d, r, [&](const float* ya, const float* yb,
                                                     const float* va, const float* vb) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // (a, 8 s + t), (b, 8 s + t), (a, 8 s + t + 4), (b, ...)
      const float* x = (q & 1) ? xb : xa;
      const float* y = (q & 2) ? yb : ya;
      const float* gq = (q & 1) ? gb : ga;
      const float* vq = (q & 2) ? vb : va;
      float dq[DMAX];  // q_e: r2' and the moments both read them
      float r2 = 0.0f;
#pragma unroll
      for (int e = 0; e < DMAX; ++e) {
        const float diff = x[e] - y[e];
        dq[e] = __fmul_rn(diff, diff);
        r2 = e == 0 ? dq[0] : __fadd_rn(r2, dq[e]);
      }
      float w = gq[0] * vq[0];
#pragma unroll
      for (int c = 1; c < RC; ++c) w = fmaf(gq[c], vq[c], w);
      float wk, wn;
      moment_weights<FAM>(r2, w, wk, wn);
      s0 += wk;
#pragma unroll
      for (int e = 0; e < DMAX; ++e) mt[e] = fmaf(wn, dq[e], mt[e]);
    }
  }, [&] {
    mom[0] += s0;
    s0 = 0.0f;
#pragma unroll
    for (int e = 0; e < DMAX; ++e) {
      mom[1 + e] += mt[e];
      mt[e] = 0.0f;
    }
  });
  block_sum(mom, partial + static_cast<int64_t>(blockIdx.x) * kMomRow, tid, false);
}

// B5 for R > 16 (the iterative predict's CG: R = n* right-hand sides),
// redesigned for Hopper with the contraction on the tensor cores (wgmma).
// One block owns 128 rows and 128 right-hand-side columns (grid.y walks R in
// chunks of 128) and walks X2 and V in tiles of 32 columns (rows of V). Its
// 512 threads are four warpgroups with two roles, handing tiles over through
// shared memory (K's fragments and V's split tiles double-buffered, V's raw
// rows in three buffers) and named barriers, so that forming K runs beside
// the tensor cores:
//  - the two producer warpgroups (warps 8-15; setmaxnreg down to 72
//    registers) copy V's rows of tile j + 2 into shared memory with cp.async
//    (16 bytes where R % 4 == 0, else 4; the ragged edges zero-filled) and
//    load X2's coordinates of tile j + 2 while they form K of tile j, a
//    tile ahead of the consumers (FULL: K formed and V's rows landed; EMPTY:
//    the consumers are done with that buffer's tile and with the raw rows
//    the next copy lands in). Producer warp
//    p forms rows 16 p .. 16 p + 15, each thread the four entries of an
//    m16n8k8 A fragment (rows g, g + 8 by columns t, t + 4 of each 8-column
//    step, g = lane / 4, t = lane % 4), both sides' coordinates times the
//    family's folded constant and padded to DMAX in shared memory (DMAX 0
//    reads them through L1 for D > 8), r2 a sum of direct differences, K =
//    v ex2(.) with the multiply by v last (k_of_r2_fast, so a square Gram's
//    diagonal is exactly v). K and V are split into hi = tf32(x) (round to
//    nearest, ties away) and lo = x - hi (exact; the tensor cores read its
//    top 19 bits); K is written in its A fragments' order (one 16-byte store
//    and load a lane, so without bank conflicts);
//  - the two consumer warpgroups (warps 0-7; setmaxnreg up to 184): warpgroup
//    c owns rows 64 c .. 64 c + 63 and all 128 columns. Per tile it loads its
//    K fragments into registers and issues, for each 8-column step, lo.hi,
//    hi.lo and hi.hi (wgmma.mma_async m64n128k8, TF32, A from registers, B
//    from shared memory read once for the warpgroup, float32 accumulators;
//    lo.lo dropped: 3xTF32) into a fresh accumulator. While those run, the
//    consumers split tile j + 1's V and transpose it into wgmma's K-major
//    core matrices (8 columns of V by 4 rows, 128 bytes; a warp writes one,
//    a lane a float, reading the raw rows with a stride 8 past a multiple of
//    32 banks, so without bank conflicts). Then they wait for the tensor
//    cores and add the fresh sum once, in round-to-nearest FADD, into the
//    float32 running sum (promotion: the tensor cores' own accumulation order
//    and rounding reach at most 12 products of 8 deep).
// Each output entry is written once by one thread: no atomics, and the
// result does not depend on scheduling. Every accum mode runs this kernel.
//
// Why K is formed once per 128 columns of R and not per 256: a block of 128
// rows by 256 columns needs two float32 accumulators (fresh and running) of
// 128 x 256 entries, the whole register file; a block of 64 rows by 256
// columns (in tiles of 16 columns, for shared memory) stages each column of
// V for twice as many row blocks and ran 25.4 ms at R = 256 against this
// layout's 17.1-17.5 on an H100 (PERF.md).
//
// Bound on an H100 SXM at N = M = 50,000, D = 4, R = 256: 3 passes of 2R
// operations an entry on the tensor cores at 495 TFLOP/s TF32 is 7.76 ms; K's
// 3D + 3 at the float32 peak 0.56 ms.
constexpr int kWideRows = 128;       // rows a block: 8 m-blocks of 16
constexpr int kWideCols = 128;       // right-hand-side columns a block
constexpr int kWideDepth = 32;       // columns of X2 (rows of V) a tile
constexpr int kWideSteps = kWideDepth / 8;
constexpr int kConsumers = 256;      // 2 warpgroups of 64 rows
constexpr int kProducers = 256;      // 8 warps
constexpr int kWideThreads = kConsumers + kProducers;
constexpr int kRawStride = kWideCols + 8;  // raw V rows: the transposing reads
                                           // (rows l % 4, columns l / 4) miss no bank
constexpr int kKFrag = kWideRows * kWideDepth * 2;  // floats of a K tile, hi and lo
constexpr int kVTile = kWideDepth * kWideCols;      // floats of V's hi (or lo) tile
constexpr int kRawV = kWideDepth * kRawStride;
constexpr int kTileX = kWideDepth * 8;    // X2's coordinates of a tile, stride DMAX
constexpr int kRowX = kWideRows * 8;      // the block's rows' coordinates, stride DMAX
constexpr int kRawBufs = 3;  // V's raw rows: tile j + 2 lands while j + 1 is read
constexpr int kWideSmem = static_cast<int>(sizeof(float)) *
                          (2 * (kKFrag + 2 * kVTile + kTileX) + kRawBufs * kRawV + kRowX);
static_assert(kProducers / 32 == kWideRows / 16, "a producer warp forms one m-block");
static_assert(kProducers == kWideDepth * 8, "a producer thread loads one coordinate of X2");
// V's tile in shared memory, for each 8-column step: 16 groups of 8 columns
// (N) by 2 groups of 4 rows (K), one 128-byte core matrix each, K-major: the
// descriptor's leading byte offset steps K (128 bytes), its stride byte
// offset N (256 bytes), both in 16-byte units
constexpr uint64_t kDescLBO = 128 / 16;
constexpr uint64_t kDescSBO = 256 / 16;

// named barriers (0 is __syncthreads): the producers among themselves, each
// buffer's FULL (producers arrive, consumers wait) and EMPTY (consumers
// arrive, producers wait), and the consumers among themselves
constexpr int kBarProducers = 1;
constexpr int kBarFull = 2;   // + buffer
constexpr int kBarEmpty = 4;  // + buffer
constexpr int kBarConsumers = 6;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// x = hi + lo: hi = tf32(x) rounded to nearest, ties away from zero (as
// cvt.rna.tf32.f32, without its NaN test: two integer operations), lo =
// x - hi exact; the tensor cores read lo's top 19 bits
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

// d (+)= A B on a warpgroup's 64 x 128 tile, 8 deep (wgmma, TF32): A from
// registers (each warp its 16 rows, mma.sync's m16n8k8 A fragment), B from
// shared memory through `desc`; d[4 j + q]: row g + 8 (q / 2), column
// 8 j + 2 t + q % 2 of the warp's rows. `accumulate` 0 starts a fresh sum.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// a shared-memory matrix descriptor of V's hi or lo tile of one step: no
// swizzle, K-major core matrices
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr & 0x3ffff) >> 4) | (kDescLBO << 16) | (kDescSBO << 32);
}

// keeps the compiler from moving a register's reads or writes across the
// wgmma fence, commit and wait around it
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }

__device__ __forceinline__ void copy_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" :: "r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" :: "r"(s), "l"(src), "r"(bytes)
               : "memory");
}

// The producer warpgroup's walk: copies, forms and splits every tile.
template <int FAM, int DMAX>
__device__ __forceinline__ void wide_produce(const float* __restrict__ xs,
                                             const float* __restrict__ x2s,
                                             const float* __restrict__ vmat, float vv,
                                             float* kf, float* rawv, float* tx,
                                             float* rx, int64_t row0, int c0, int live,
                                             int64_t n, int64_t m, int d, int r, int64_t tiles) {
  constexpr float scale = kCoordScale<FAM>;
  constexpr int kDX = DMAX > 0 ? DMAX : 1;
  const int p = threadIdx.x - kConsumers;  // 0 .. kProducers - 1
  const int lane = p % 32;
  const int warp = p / 32;
  const int g = lane / 4;
  const int t = lane % 4;

  if (DMAX > 0 && p < kWideRows) {  // the block's rows' folded coordinates
    const int64_t row = row0 + p;
#pragma unroll
    for (int k = 0; k < kDX; ++k)
      rx[p * kDX + k] = (row < n && k < d) ? __fmul_rn(scale, xs[row * d + k]) : 0.0f;
  }
  // V's rows of a tile: the 16-byte path copies columns 4 (p % 32) .. + 3 of
  // rows p / 32 + 8 i, the 4-byte path column p % 128 of rows p / 128 + 2 i
  const bool wide_copy = r % 4 == 0;
  const int vc = wide_copy ? (p % 32) * 4 : p % kWideCols;
  const int vj = wide_copy ? p / 32 : p / kWideCols;
  const bool v_in = vc < live;
  const float* v_row = vmat + static_cast<int64_t>(vj) * r + c0 + vc;  // in tile 0
  const int64_t v_step = static_cast<int64_t>(wide_copy ? 8 : 2) * r;   // between copies
  float* v_dst = rawv + vj * kRawStride + vc;
  auto fetch = [&](int64_t tile) {  // an empty group past the last tile
    if (tile < tiles) {
      const int64_t left = m - tile * kWideDepth;
      const int rows = static_cast<int>(left < kWideDepth ? left : kWideDepth) - vj;
      const float* src = v_row + tile * kWideDepth * static_cast<int64_t>(r);
      float* dst = v_dst + static_cast<int>(tile % kRawBufs) * kRawV;
      if (wide_copy) {
#pragma unroll
        for (int i = 0; i < kWideDepth / 8; ++i, src += v_step) {
          const bool in = v_in && 8 * i < rows;
          copy_async16(dst + 8 * i * kRawStride, in ? src : vmat, in ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < kWideDepth / 2; ++i, src += v_step) {
          const bool in = v_in && 2 * i < rows;
          copy_async4(dst + 2 * i * kRawStride, in ? src : vmat, in ? 4 : 0);
        }
      }
    }
    copy_async_commit();
  };
  // X2's coordinate (tile's column p / DMAX, dimension p % DMAX), folded
  const bool x_in = DMAX > 0 && p < kWideDepth * kDX && p % kDX < d;
  const float* x_src = x2s + static_cast<int64_t>(p / kDX) * d + p % kDX;  // in tile 0
  auto coord = [&](int64_t tile) {
    return (x_in && tile * kWideDepth + p / kDX < m)
               ? __fmul_rn(scale, x_src[tile * kWideDepth * static_cast<int64_t>(d)]) : 0.0f;
  };
  auto put_coord = [&](int64_t tile, float x) {
    if (DMAX > 0 && p < kWideDepth * kDX) tx[static_cast<int>(tile % 2) * kTileX + p] = x;
  };

  // K of m-block `warp` into the tile's A fragments, split hi / lo
  auto form = [&](int64_t tile) {
    const int buf = static_cast<int>(tile % 2);
    {
      const int mb = warp;
      float* kt = kf + buf * kKFrag + mb * (kWideSteps * 256) + lane * 4;
      float xa[kDX], xb[kDX];  // rows 16 mb + g and + 8
      if constexpr (DMAX > 0) {
        const float4* r4 = reinterpret_cast<const float4*>(rx);
#pragma unroll
        for (int e = 0; e < DMAX / 4; ++e) {
          const float4 u = r4[(mb * 16 + g) * (DMAX / 4) + e];
          const float4 w = r4[(mb * 16 + g + 8) * (DMAX / 4) + e];
          xa[4 * e] = u.x; xa[4 * e + 1] = u.y; xa[4 * e + 2] = u.z; xa[4 * e + 3] = u.w;
          xb[4 * e] = w.x; xb[4 * e + 1] = w.y; xb[4 * e + 2] = w.z; xb[4 * e + 3] = w.w;
        }
      }
#pragma unroll
      for (int s = 0; s < kWideSteps; ++s) {
        const int ca = s * 8 + t;  // the tile's columns t and t + 4 of step s
        const int cb = ca + 4;
        float ka[4];  // (a, ca), (b, ca), (a, cb), (b, cb): a0..a3 of the A fragment
        if constexpr (DMAX > 0) {
          const float4* x4 = reinterpret_cast<const float4*>(tx + buf * kTileX);
          float ya[DMAX], yb[DMAX];
#pragma unroll
          for (int e = 0; e < DMAX / 4; ++e) {
            const float4 u = x4[ca * (DMAX / 4) + e];
            const float4 w = x4[cb * (DMAX / 4) + e];
            ya[4 * e] = u.x; ya[4 * e + 1] = u.y; ya[4 * e + 2] = u.z; ya[4 * e + 3] = u.w;
            yb[4 * e] = w.x; yb[4 * e + 1] = w.y; yb[4 * e + 2] = w.z; yb[4 * e + 3] = w.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* x = (q & 1) ? xb : xa;
            const float* y = (q & 2) ? yb : ya;
            float r2 = 0.0f;
#pragma unroll
            for (int e = 0; e < DMAX; ++e) {
              const float diff = x[e] - y[e];
              r2 = fmaf(diff, diff, r2);
            }
            ka[q] = k_of_r2_fast<FAM>(r2, vv);
          }
        } else {  // D > 8: both sides' coordinates through L1, indices clamped
          const int64_t ia = row0 + mb * 16 + g;
          const int64_t ib = ia + 8;
          const int64_t ja = tile * kWideDepth + ca;
          const int64_t jb = ja + 4;
          const float* pa = xs + (ia < n ? ia : n - 1) * d;
          const float* pb = xs + (ib < n ? ib : n - 1) * d;
          const float* qa = x2s + (ja < m ? ja : m - 1) * d;
          const float* qb = x2s + (jb < m ? jb : m - 1) * d;
          float r2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int e = 0; e < d; ++e) {
            const float xa_e = __ldg(pa + e), xb_e = __ldg(pb + e);
            const float ya_e = __ldg(qa + e), yb_e = __ldg(qb + e);
            const float d0 = xa_e - ya_e, d1 = xb_e - ya_e, d2 = xa_e - yb_e, d3 = xb_e - yb_e;
            r2[0] = fmaf(d0, d0, r2[0]);
            r2[1] = fmaf(d1, d1, r2[1]);
            r2[2] = fmaf(d2, d2, r2[2]);
            r2[3] = fmaf(d3, d3, r2[3]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) ka[q] = k_of_r2_fast<FAM>(r2[q] * (scale * scale), vv);
        }
        float4 hi, lo;
        split_tf32(ka[0], hi.x, lo.x);
        split_tf32(ka[1], hi.y, lo.y);
        split_tf32(ka[2], hi.z, lo.z);
        split_tf32(ka[3], hi.w, lo.w);
        *reinterpret_cast<float4*>(kt + s * 256) = hi;
        *reinterpret_cast<float4*>(kt + s * 256 + 128) = lo;
      }
    }
  };

  // V's rows land two tiles ahead (three raw buffers; the consumers read
  // tile j + 1's while they contract j) and X2's coordinates are loaded two
  // ahead and stored one ahead
  put_coord(0, coord(0));
  fetch(0);
  fetch(1);
  float x_next = coord(1);
  for (int64_t tile = 0; tile < tiles; ++tile) {
    // tile's V rows have landed and its coordinates are stored; every
    // producer is done with tile - 1's raw rows and coordinates
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    bar_sync(kBarProducers, kProducers);
    const int buf = static_cast<int>(tile % 2);
    // the consumers are done with tile - 2 and with tile - 1's raw rows,
    // where fetch(tile + 2) lands (at tile 1: tile 0's, read before their walk)
    if (tile >= 1) bar_sync(kBarEmpty + buf, kWideThreads);
    form(tile);
    put_coord(tile + 1, x_next);
    bar_arrive(kBarFull + buf, kWideThreads);  // K's fragments and V's rows of tile
    fetch(tile + 2);
    x_next = coord(tile + 2);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int FAM, int DMAX>
__global__ void __launch_bounds__(kWideThreads, 1)
gram_matvec_tc_kernel(const float* __restrict__ xs, const float* __restrict__ x2s,
                      const float* __restrict__ vmat, const float* __restrict__ var,
                      float* __restrict__ out, int64_t n, int64_t m, int d, int r) {
  extern __shared__ __align__(16) float wide_smem[];
  float* kf = wide_smem;            // [2][m-block][step][hi, lo][lane][4]
  float* vb = kf + 2 * kKFrag;      // [2][hi, lo][step][16][2][32]: V's core matrices
  float* rawv = vb + 4 * kVTile;    // [kRawBufs][kWideDepth][kRawStride]
  float* tx = rawv + kRawBufs * kRawV;  // [2][kWideDepth][DMAX], folded
  float* rx = tx + 2 * kTileX;      // [kWideRows][DMAX], folded

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kWideRows;
  const int c0 = blockIdx.y * kWideCols;
  const int live = min(kWideCols, r - c0);  // this block's columns of R
  const int64_t tiles = (m + kWideDepth - 1) / kWideDepth;
  const float vv = var[0];

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;" ::: "memory");
    wide_produce<FAM, DMAX>(xs, x2s, vmat, vv, kf, rawv, tx, rx, row0, c0, live, n, m, d, r,
                            tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;" ::: "memory");
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int mb = warp;  // warpgroup warp / 4, its rows 16 warp .. 16 warp + 15
    float run[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = part[i] = 0.0f;
    // V's tile into wgmma's layout: core matrix c = (step s, column group
    // cn, row group ck) holds V[8 s + 4 ck + l % 4][8 cn + l / 4] at float l
    // (lanes read the raw rows without bank conflicts); warp w writes 16 of
    // the tile's 128
    const float* rv_lane = rawv + (lane % 4) * kRawStride + lane / 4;
    auto transpose = [&](int64_t tile) {
      const float* rv = rv_lane + static_cast<int>(tile % kRawBufs) * kRawV;
      float* vt = vb + static_cast<int>(tile % 2) * 2 * kVTile + lane;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = warp * 16 + i;
        const int s = c / 32, cn = (c % 32) / 2, ck = c % 2;
        float hi, lo;
        split_tf32(rv[(8 * s + 4 * ck) * kRawStride + 8 * cn], hi, lo);
        vt[c * 32] = hi;
        vt[kVTile + c * 32] = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma's reads
    };

    if (tiles > 0) {
      bar_sync(kBarFull, kWideThreads);
      transpose(0);
      // tile 0's raw rows are read: the producers' copy of tile 3 may land there
      if (tiles > 1) bar_arrive(kBarEmpty + 1, kWideThreads);
      bar_sync(kBarConsumers, kConsumers);
    }
    for (int64_t tile = 0; tile < tiles; ++tile) {
      // tile's K is formed and its V transposed
      const int buf = static_cast<int>(tile % 2);
      // the warp's K fragments of the tile's steps
      uint32_t ah[kWideSteps][4], al[kWideSteps][4];
      const float* kt = kf + buf * kKFrag + mb * (kWideSteps * 256) + lane * 4;
#pragma unroll
      for (int s = 0; s < kWideSteps; ++s) {
        const float4 h = *reinterpret_cast<const float4*>(kt + s * 256);
        const float4 l = *reinterpret_cast<const float4*>(kt + s * 256 + 128);
        ah[s][0] = __float_as_uint(h.x); ah[s][1] = __float_as_uint(h.y);
        ah[s][2] = __float_as_uint(h.z); ah[s][3] = __float_as_uint(h.w);
        al[s][0] = __float_as_uint(l.x); al[s][1] = __float_as_uint(l.y);
        al[s][2] = __float_as_uint(l.z); al[s][3] = __float_as_uint(l.w);
      }
      const float* vh = vb + buf * 2 * kVTile;
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(part[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < kWideSteps; ++s) {
        const uint64_t bh = b_desc(vh + s * (kVTile / kWideSteps));
        const uint64_t bl = b_desc(vh + kVTile + s * (kVTile / kWideSteps));
        wgmma_tf32(part, al[s], bh, s > 0);  // a fresh sum at the tile's first step
        wgmma_tf32(part, ah[s], bl, 1);
        wgmma_tf32(part, ah[s], bh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (tile + 1 < tiles) {  // the next tile's V, while the tensor cores run
        bar_sync(kBarFull + (buf ^ 1), kWideThreads);
        transpose(tile + 1);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(part[i]);
      if (tile + 2 < tiles) bar_arrive(kBarEmpty + buf, kWideThreads);  // the producers refill it
      bar_sync(kBarConsumers, kConsumers);  // the next V is whole; this one is read
      // promotion
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = __fadd_rn(run[i], part[i]);
    }

#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t row = row0 + mb * 16 + g + (q >= 2 ? 8 : 0);
        const int col = c0 + 8 * j + 2 * t + (q & 1);
        if (row < n && col < r) out[row * r + col] = run[4 * j + q];
      }
  }
}

// B5 for 8 < D <= kCrossMaxD and R <= 16 (an iterative exact GP on more
// than 8 input dimensions: its CG's 1 + n_probes columns), redesigned for
// Hopper with the cross term on the tensor cores. r2 is the TPU kernel's
// expansion above D = 8 (gpy_tpu/ops/pallas_gram_matvec.py:98-106), |x|^2 +
// |y|^2 - 2 x.y clamped at 0, on the family's folded coordinates x' = c x
// (kCoordScale); the wrapper centres both sides on the columns' mean first,
// which leaves every distance as it was and shrinks |x|^2, and with it the
// expansion's rounding. One block owns 128 rows, MB m-blocks of 16 a warp
// (two, in 4 warps, where three such blocks fit in an SM's shared memory,
// else one, in 8: launch_cross), and stages them once: their 2 x' padded
// with zeros to a multiple of 8 dimensions and split into TF32 hi and lo
// (split_tf32) in mma.sync m16n8k8's A-fragment order in shared memory, and
// |x'|^2 of the thread's rows (g, g + 8 of each m-block, g = lane / 4) in
// registers, in float32. The block walks X2 and V in tiles of kCrossCols columns: the raw
// rows of tile j + 1 are copied into shared memory with 16-byte cp.async
// (the ragged last tile zero-filled) while tile j computes, and each landed
// tile is re-laid once, a warp an 8-column step: X2's folded coordinates
// split hi / lo in B-fragment order, -|y'|^2 of each column (its four
// lanes' parts summed in a fixed order), V's rows padded to v_stride. One
// barrier a tile. A warp takes a tile in passes of kCrossPass steps: each
// step's accumulators (rows g, g + 8 by columns 2t, 2t + 1, t = lane % 4,
// of each m-block) start at -(|x'|^2 + |y'|^2) and take lo.hi, hi.lo and
// hi.hi of every 8 dimensions (3xTF32, lo.lo dropped), so they end at
// -r2'; then K = v ex2(-max(r2', 0)) on the SFU with the multiply by v last
// (k_of_r2_fast), and K V into MB x 2 RC float32 FFMA accumulators, each V
// row read from shared memory serving every m-block. `diag` >= 0 says row i
// of xs is row i + diag of x2s (a square Gram, or a row slab of one): there
// r2' is set to 0, so K_ii is exactly v; only the passes that meet that
// diagonal test for it. After the last tile the four lanes that share a
// row sum their accumulators with shuffles in a fixed order, and each
// output entry is written once by one thread: no atomics, and a second
// launch repeats bit for bit. A row's sum does not depend on where it sits
// in its block, so a row slab equals the square Gram's rows bit for bit.
//
// Bound on an H100 SXM at N = M = 50,000, D = 12, R = 9: the SIMT
// operations of the direct form, (3D + 3) + 2R = 57 an entry, are 2.13 ms
// at 67 TFLOP/s; with the cross term on the tensor cores (3 x 2 x 16 TF32
// operations an entry, 0.48 ms at 495 TFLOP/s) the SIMT cores keep the
// contraction's 2R and ~4 for r2 and K: 0.82 ms. The parts run one after
// another rather than beside each other: at D = 12, R = 9 the contraction,
// the cross term, the re-layout and the exp take about 1.2, 1.1, 0.6 and 0.3
// ms of 3.2 (PERF.md). The cross term on wgmma (m64n32k8, A from registers,
// B from shared memory, waited on per 8 dimensions) ran 2% slower there on
// an H100 and was not kept.
constexpr int kCrossRows = 128;      // rows a block: 8 m-blocks of 16
constexpr int kCrossCols = 64;       // columns of X2 (rows of V) a tile
constexpr int kCrossSteps = kCrossCols / 8;
constexpr int kCrossPass = 4;        // 8-column steps a pass
constexpr int kCrossMaxD = 64;       // past it the rows' fragments and a tile's
                                     // pass 227 KB of shared memory
// A block's warps and threads with MB m-blocks a warp: 8 and 256 at MB = 1,
// 4 and 128 at MB = 2
template <int MB>
constexpr int kCrossWarps = kCrossRows / 16 / MB;
template <int MB>
constexpr int kCrossThreads = 32 * kCrossWarps<MB>;

// Blocks per SM the register budget is set for: 3, so that the 391 blocks
// of N = 50,000 are resident at once (168 registers a thread at MB = 2, 80
// at MB = 1), but 2 at MB = 1, R = 16 (128), where 80 spilled 144 bytes and
// ran 1.2x slower on an H100. At 4 blocks of MB = 2 (128 registers) R = 9
// spilled and ran 3-4% slower at D = 12 (PERF.md).
constexpr int cross_min_blocks(int rc, int mb) { return mb == 1 && rc > 9 ? 2 : 3; }

// Floats of the cross kernel's dynamic shared memory at D = d: the rows' A
// fragments, two tiles' B fragments, column norms and re-laid V rows, and
// two raw tiles of X2 and V; every part a multiple of 4 floats.
__host__ __device__ constexpr int cross_smem_floats(int d, int rc, int vstride) {
  return (kCrossRows / 16) * ((d + 7) / 8) * 256 + 2 * kCrossSteps * ((d + 7) / 8) * 128 +
         2 * kCrossCols + 2 * kCrossCols * vstride + 2 * kCrossCols * d + 2 * kCrossCols * rc;
}

// c += a b on one m16n8k8 tile: mma.sync, TF32 operands (the tensor cores
// read the top 19 bits of each float), float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float4& a, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

template <int FAM, int RC, int MB>
__global__ void __launch_bounds__(kCrossThreads<MB>, cross_min_blocks(RC, MB))
gram_matvec_cross_kernel(const float* __restrict__ xs, const float* __restrict__ x2s,
                         const float* __restrict__ vmat, const float* __restrict__ var,
                         float* __restrict__ out, int64_t n, int64_t m, int d, int r,
                         int64_t diag) {
  constexpr float scale = kCoordScale<FAM>;
  constexpr int kStride = v_stride<RC>();
  constexpr int kWarps = kCrossWarps<MB>;
  constexpr int kThreads = kCrossThreads<MB>;
  static_assert(kCrossSteps % kWarps == 0, "the warps share a tile's steps evenly");
  extern __shared__ __align__(16) float cross_smem[];
  const int ks_n = (d + 7) / 8;                     // 8-dimension steps
  const int frag_n = kCrossSteps * ks_n * 128;      // floats of a tile's B fragments
  float* rowf = cross_smem;                         // [m-block][ks][hi, lo][lane][4]
  float* bfr = rowf + (kCrossRows / 16) * ks_n * 256;  // [2][step][ks][lane][hi b0, b1, lo b0, b1]
  float* nrm = bfr + 2 * frag_n;                    // [2][kCrossCols]: -|y'|^2
  float* cv = nrm + 2 * kCrossCols;                 // [2][kCrossCols][kStride]
  float* rawx = cv + 2 * kCrossCols * kStride;      // [2][kCrossCols * d]
  float* rawv = rawx + 2 * kCrossCols * d;          // [2][kCrossCols * RC], stride r

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int t = lane % 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kCrossRows;
  const int64_t wrow = row0 + warp * MB * 16;  // the warp's first row
  const float vv = var[0];

  // the block's rows, once: 2 x' in A-fragment order (a0..a3: rows g, g + 8,
  // g, g + 8 by dimensions t, t, t + 4, t + 4 of each step), hi and lo
  for (int i = tid; i < (kCrossRows / 16) * ks_n * 32; i += kThreads) {
    const int l = i % 32;
    const int ks = (i / 32) % ks_n;
    const int mbi = i / (32 * ks_n);
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t row = row0 + mbi * 16 + l / 4 + (q & 1) * 8;
      const int k = ks * 8 + l % 4 + (q & 2) * 2;
      x[q] = (row < n && k < d) ? 2.0f * __fmul_rn(scale, xs[row * d + k]) : 0.0f;
    }
    float4 hi, lo;
    split_tf32(x[0], hi.x, lo.x);
    split_tf32(x[1], hi.y, lo.y);
    split_tf32(x[2], hi.z, lo.z);
    split_tf32(x[3], hi.w, lo.w);
    float* dst = rowf + (mbi * ks_n + ks) * 256 + l * 4;
    *reinterpret_cast<float4*>(dst) = hi;
    *reinterpret_cast<float4*>(dst + 128) = lo;
  }
  // |x'|^2 of the thread's rows g and g + 8 of each of its m-blocks
  float nx[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = wrow + mb * 16 + lane / 4 + h * 8;
      float sq = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float x = row < n ? __fmul_rn(scale, xs[row * d + k]) : 0.0f;
        sq = fmaf(x, x, sq);
      }
      nx[mb][h] = sq;
    }

  const int tiles = static_cast<int>((m + kCrossCols - 1) / kCrossCols);
  auto valid = [&](int tile) {  // the tile's columns inside M
    const int64_t left = m - static_cast<int64_t>(tile) * kCrossCols;
    return static_cast<int>(left < kCrossCols ? left : kCrossCols);
  };
  auto issue = [&](int tile) {
    const int64_t col0 = static_cast<int64_t>(tile) * kCrossCols;
    const int nx2 = valid(tile) * d, nv = valid(tile) * r;
    float* dx = rawx + (tile % 2) * kCrossCols * d;
    float* dv = rawv + (tile % 2) * kCrossCols * RC;
    for (int c = tid; 4 * c < nx2; c += kThreads)
      copy_async16(dx + 4 * c, x2s + col0 * d + 4 * c, min(16, 4 * (nx2 - 4 * c)));
    for (int c = tid; 4 * c < nv; c += kThreads)
      copy_async16(dv + 4 * c, vmat + col0 * r + 4 * c, min(16, 4 * (nv - 4 * c)));
    copy_async_commit();
  };
  // warp w re-lays steps w, w + kWarps, ... of a tile: in each, lane l
  // takes column j = 8 step + l / 4 and, of each 8 dimensions, t and t + 4:
  // its B fragment, and its part of -|y'|^2, which the column's four lanes
  // then sum in a fixed order
  auto relayout = [&](int buf, int cols) {
#pragma unroll
    for (int st = warp; st < kCrossSteps; st += kWarps) {
      const int j = st * 8 + lane / 4;
      const float* rx = rawx + buf * kCrossCols * d + j * d + t;
      float* bf = bfr + buf * frag_n + st * ks_n * 128 + lane * 4;
      const bool in = j < cols;
      float sq = 0.0f;
      for (int ks = 0; ks < ks_n; ++ks) {
        const int k = ks * 8 + t;
        const float y0 = (in && k < d) ? __fmul_rn(scale, rx[ks * 8]) : 0.0f;
        const float y1 = (in && k + 4 < d) ? __fmul_rn(scale, rx[ks * 8 + 4]) : 0.0f;
        sq = fmaf(y0, y0, sq);
        sq = fmaf(y1, y1, sq);
        float4 f;  // hi b0, hi b1, lo b0, lo b1
        split_tf32(y0, f.x, f.z);
        split_tf32(y1, f.y, f.w);
        *reinterpret_cast<float4*>(bf + ks * 128) = f;
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (t == 0) nrm[buf * kCrossCols + j] = -sq;
    }
    const float* rv = rawv + buf * kCrossCols * RC;
    float* cvb = cv + buf * kCrossCols * kStride;
#pragma unroll
    for (int it = 0; it < (kCrossCols * kStride + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kStride;
      const int c = i - j * kStride;
      if ((kCrossCols * kStride) % kThreads == 0 || i < kCrossCols * kStride)
        cvb[i] = (j < cols && c < r) ? rv[j * r + c] : 0.0f;
    }
  };

  float acc[MB][2 * RC];  // per m-block rows g and g + 8, partial over the thread's columns
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int c = 0; c < 2 * RC; ++c) acc[mb][c] = 0.0f;
  if (tiles > 0) {
    issue(0);
    copy_async_wait();
    __syncthreads();
    relayout(0, valid(0));
    if (tiles > 1) issue(1);
  }
  const float* at = rowf + warp * MB * ks_n * 256 + lane * 4;
  for (int tile = 0; tile < tiles; ++tile) {
    const int cur = tile % 2;
    // tile + 1 has landed; every thread is done with tile - 1's re-laid
    // buffers and with tile's raw ones
    copy_async_wait();
    __syncthreads();
    if (tile + 1 < tiles) relayout(cur ^ 1, valid(tile + 1));
    if (tile + 2 < tiles) issue(tile + 2);
    const int64_t col0 = static_cast<int64_t>(tile) * kCrossCols;
    const float* bt = bfr + cur * frag_n + lane * 4;
    const float* nt = nrm + cur * kCrossCols;
    const float* vt = cv + cur * kCrossCols * kStride;
#pragma unroll
    for (int p = 0; p < kCrossSteps / kCrossPass; ++p) {
      // -r2' of (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of each
      // m-block and step
      float c[MB][kCrossPass][4];
#pragma unroll
      for (int s = 0; s < kCrossPass; ++s) {
        const float2 y = *reinterpret_cast<const float2*>(nt + (p * kCrossPass + s) * 8 + 2 * t);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          c[mb][s][0] = y.x - nx[mb][0];
          c[mb][s][1] = y.y - nx[mb][0];
          c[mb][s][2] = y.x - nx[mb][1];
          c[mb][s][3] = y.y - nx[mb][1];
        }
      }
      for (int ks = 0; ks < ks_n; ++ks) {
        float4 ah[MB], al[MB];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          ah[mb] = *reinterpret_cast<const float4*>(at + (mb * ks_n + ks) * 256);
          al[mb] = *reinterpret_cast<const float4*>(at + (mb * ks_n + ks) * 256 + 128);
        }
#pragma unroll
        for (int s = 0; s < kCrossPass; ++s) {
          const float4 b =
              *reinterpret_cast<const float4*>(bt + ((p * kCrossPass + s) * ks_n + ks) * 128);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            mma_tf32(c[mb][s], al[mb], b.x, b.y);
            mma_tf32(c[mb][s], ah[mb], b.z, b.w);
            mma_tf32(c[mb][s], ah[mb], b.x, b.y);
          }
        }
      }
      const int64_t pc0 = col0 + p * kCrossPass * 8;  // the pass's first column
      if (diag >= 0 && wrow + diag < pc0 + kCrossPass * 8 &&
          pc0 < wrow + diag + MB * 16) {         // the pass meets the warp's diagonal
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int s = 0; s < kCrossPass; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (pc0 + s * 8 + 2 * t + (q & 1) ==
                  wrow + mb * 16 + lane / 4 + (q & 2) * 4 + diag)
                c[mb][s][q] = 0.0f;
      }
#pragma unroll
      for (int s = 0; s < kCrossPass; ++s) {
        float k[MB][4];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int q = 0; q < 4; ++q) k[mb][q] = k_of_r2_fast<FAM>(fmaxf(-c[mb][s][q], 0.0f), vv);
        const float* va = vt + ((p * kCrossPass + s) * 8 + 2 * t) * kStride;  // V row 2t
        if constexpr (kStride % 4 == 0) {
#pragma unroll
          for (int c4 = 0; c4 < (RC + 3) / 4; ++c4) {
            const float4 pa = reinterpret_cast<const float4*>(va)[c4];
            const float4 pb = reinterpret_cast<const float4*>(va + kStride)[c4];
            const float ea[4] = {pa.x, pa.y, pa.z, pa.w}, eb[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cc = 4 * c4 + e;
              if (cc >= RC) break;
#pragma unroll
              for (int mb = 0; mb < MB; ++mb) {
                acc[mb][cc] = fmaf(k[mb][0], ea[e], acc[mb][cc]);
                acc[mb][cc] = fmaf(k[mb][1], eb[e], acc[mb][cc]);
                acc[mb][RC + cc] = fmaf(k[mb][2], ea[e], acc[mb][RC + cc]);
                acc[mb][RC + cc] = fmaf(k[mb][3], eb[e], acc[mb][RC + cc]);
              }
            }
          }
        } else {
          const float ea = va[0], eb = va[kStride];
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            acc[mb][0] = fmaf(k[mb][0], ea, acc[mb][0]);
            acc[mb][0] = fmaf(k[mb][1], eb, acc[mb][0]);
            acc[mb][RC] = fmaf(k[mb][2], ea, acc[mb][RC]);
            acc[mb][RC] = fmaf(k[mb][3], eb, acc[mb][RC]);
          }
        }
      }
    }
  }

  // the four lanes of a row group hold column partial sums: add them
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int c = 0; c < 2 * RC; ++c) {
      acc[mb][c] += __shfl_xor_sync(0xffffffffu, acc[mb][c], 1);
      acc[mb][c] += __shfl_xor_sync(0xffffffffu, acc[mb][c], 2);
    }
    const int64_t row_a = wrow + mb * 16 + lane / 4;
    const int64_t row_b = row_a + 8;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c % 4 != t || c >= r) continue;
      if (row_a < n) out[row_a * r + c] = acc[mb][c];
      if (row_b < n) out[row_b * r + c] = acc[mb][RC + c];
    }
  }
}

// B6 for D > 8 or R > 16 (D <= 127; the iterative exact GP's backward on
// more than 8 input dimensions: one launch an NLML+gradient), redesigned for
// Hopper with W on the tensor cores. One 256-thread block owns 128 rows, 16
// a warp, and stages them once: v G's rows (V's columns c0 .. c0 + rc - 1)
// split into TF32 hi and lo (split_tf32) in mma.sync m16n8k8's A-fragment
// order in shared memory, and the rows' coordinates times the family's
// folded constant (kCoordScale): in registers for D <= 12 (DMAX 4, 8 or 12,
// zero-padded), in shared memory above. The block walks its share of the
// columns (grid.y splits them, so that the last wave of blocks is not half
// empty: 3-7% at D = 12 and 20; no entry is formed twice) in tiles of kMomCols: each tile's
// coordinates and V's rows are copied whole with 16-byte cp.async into a raw
// buffer two tiles ahead (zero-filled past N; V's elements one at a time
// where a launch takes only part of its columns, R > kMomMaxR), and are
// re-laid once they land into the layout the compute reads: coordinates
// folded and padded to mom_ystride, V split into hi and lo in B-fragment
// order. One barrier a tile. (4-byte copies straight into three layout
// buffers ran up to 7% slower on an H100: PERF.md.) Per 8-column step a
// warp forms W' = v (G V') of its 16 rows by the step's 8 columns in
// 3xTF32 (lo.hi, hi.lo, hi.hi; lo.lo dropped; R zero-padded to a multiple
// of 8; for R <= 16 the k-steps are fixed at compile time, KS), the next
// step's W' issued before this step's
// entries, so that the tensor cores run beside them (W in FFMA on the SIMT
// cores, as the register-tile kernel forms it, ran 1.3x slower at D = 12,
// R = 9 on an H100: PERF.md); each thread then takes the four entries its
// accumulator holds (rows g, g + 8 by columns 2t, 2t + 1; g = lane / 4,
// t = lane % 4), as the register-tile kernel does on the folded
// coordinates: q_e = (x'_e - y'_e)^2, r2' = sum q_e, one ex2.approx,
// moment_weights, s0 += wk and m_e += wn q_e. For D <= 12 each q_e is formed
// once and used by both r2' and the moments. Above, a thread's D sums do
// not fit in registers: r2' and the weights of a tile's 32 entries a thread
// come first (wn kept in registers), then the moments 8 dimensions at a
// time, each chunk forming its differences again (5D operations an entry
// where one pass takes 4D; W and the weights are formed once). Each thread
// sums a tile's entries in float32; after the tile a warp adds its lanes'
// sums in a fixed butterfly (flush8) and adds the result into float64 sums
// of the warp in shared memory; the block sums its warps in order into one
// partial row. A launch takes at most kMomMaxR columns of V, fewer where
// shared memory is short (D > 64 at R > 16); past that the moments, which
// are linear in W, are summed over several launches into the same rows.
// W' is 0 past N (V's rows there are zero) and on padded rows (G is zero
// there), so ragged edges need no mask; on the diagonal q_e = 0 exactly, so
// Exponential's finite 1/r' multiplies 0.
//
// Bound on an H100 SXM at N = 50,000, D = 12, R = 9: the all-SIMT count
// (gram_moments_bound: 2R + 6D + 5 = 95 an entry) is 3.55 ms; with W on the
// tensor cores (3 x 2R TF32 operations an entry at 495 TFLOP/s, 0.27 ms)
// the SIMT cores keep 4D + 7 an entry (difference, square, r2, moment; the
// weights), 2.05 ms (gram_moments_bounds).
constexpr int kMomRows = 128;            // rows a block: 8 warps x 16
constexpr int kMomWarps = kMomRows / 16;
constexpr int kMomCols = 64;             // columns a tile
constexpr int kMomSteps = kMomCols / 8;
constexpr int kMomBufs = 2;              // tile j computed, j + 1 re-laid (and 2 raw
                                         // buffers: j + 1 read, j + 2 landing)
constexpr int kMomMaxR = 64;             // columns of V (and G) a launch
constexpr int kMomMaxSplits = 4;         // column splits (grid.y)
constexpr int kMomSmemMax = 232448 - 1024;  // dynamic shared memory a block may use,
                                            // less room for block_sum's
static_assert(kMomWarps * 32 == kBlock, "block_sum sums kBlock threads");
static_assert(kMomCols * 4 == kBlock && kMomSteps == kMomWarps,
              "a tile's copies: four threads a column, a warp a step's fragments");

// Floats between two columns' (and rows') coordinates in shared memory:
// DMAX for one pass (8 -> 12), else D up to a multiple of 8; a multiple of
// 8 takes 4 more, so that the four columns a warp reads at once (2t + h)
// fall in four different quarters of the 32 banks.
__host__ __device__ constexpr int mom_ystride(int dmax, int d) {
  return (dmax > 0 ? dmax : (d + 7) / 8 * 8) + ((dmax > 0 ? dmax : 8) % 8 == 0 ? 4 : 0);
}

// Floats of a raw tile: its columns' d coordinates and up to 8 ks of V's
// columns.
__host__ __device__ constexpr int mom_raw_floats(int d, int ks) { return kMomCols * (d + ks * 8); }

// Bytes of the mma kernel's dynamic shared memory at D = d and ks 8-column
// steps of R: the warps' float64 sums, the rows' A fragments, the two-pass
// rows' coordinates, kMomBufs tiles of coordinates and B fragments, and two
// raw tiles.
__host__ __device__ constexpr int mom_smem_bytes(int dmax, int d, int ks) {
  return static_cast<int>(sizeof(float)) *
         (kMomWarps * kMomRow * 2 + kMomWarps * ks * 256 +
          (dmax > 0 ? 0 : kMomRows * mom_ystride(0, d)) +
          kMomBufs * (kMomCols * mom_ystride(dmax, d) + kMomSteps * ks * 128) +
          2 * mom_raw_floats(d, ks));
}

// Blocks per SM the register budget is set for: 3 at DMAX 4 (85 registers),
// else 2 (128).
constexpr int mom_min_blocks(int dmax) { return dmax == 4 ? 3 : 2; }

// v = p[0, 8), p 16-byte aligned (shared memory)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int FAM, int DMAX, int KS>
__global__ void __launch_bounds__(kBlock, mom_min_blocks(DMAX))
gram_moments_mma_kernel(const float* __restrict__ xs, const float* __restrict__ g,
                        const float* __restrict__ vmat, const float* __restrict__ var,
                        double* __restrict__ partial, int64_t n, int d, int r, int c0, int rc,
                        int add) {
  constexpr float scale = kCoordScale<FAM>;
  constexpr int kDX = DMAX > 0 ? DMAX : 1;
  constexpr int kMT = (kDX + 7) / 8 * 8;  // one pass: the moments' float32 sums, padded
  extern __shared__ __align__(16) float mom_smem[];
  const int ks_n = KS > 0 ? KS : (rc + 7) / 8;  // 8-column steps of R
  const int ys = mom_ystride(DMAX, d);
  const int xtile = kMomCols * ys;                 // floats of a tile's coordinates
  const int vtile = kMomSteps * ks_n * 128;        // floats of a tile's B fragments
  double* wmom = reinterpret_cast<double*>(mom_smem);  // [warp][kMomRow]: the warp's m_1, ..
  float* rowf = mom_smem + kMomWarps * kMomRow * 2;    // [m-block][ks][hi, lo][lane][4]
  float* xcol = rowf + kMomWarps * ks_n * 256;         // [buf][column][ys]
  float* vfr = xcol + kMomBufs * xtile;                // [buf][step][ks][lane][hi b0, b1, lo b0, b1]
  float* xrow = vfr + kMomBufs * vtile;                // two passes: [row][ys]
  float* raw = xrow + (DMAX > 0 ? 0 : kMomRows * ys);  // [2][column][d], then [2][column][rc]
  const int rawt = mom_raw_floats(d, ks_n);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int t = lane % 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kMomRows;
  const int64_t ra = row0 + warp * 16 + lane / 4;
  const int64_t rb = ra + 8;
  const float vv = var[0];

  for (int i = tid; i < kMomWarps * kMomRow; i += kBlock) wmom[i] = 0.0;
  // the block's rows of v G, once: A fragments (a0..a3: rows g, g + 8, g,
  // g + 8 by columns t, t, t + 4, t + 4 of each step), hi and lo
  for (int i = tid; i < kMomWarps * ks_n * 32; i += kBlock) {
    const int l = i % 32;
    const int ks = (i / 32) % ks_n;
    const int mb = i / (32 * ks_n);
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t row = row0 + mb * 16 + l / 4 + (q & 1) * 8;
      const int k = ks * 8 + l % 4 + (q & 2) * 2;
      a[q] = (row < n && k < rc) ? __fmul_rn(vv, g[row * r + c0 + k]) : 0.0f;
    }
    float4 hi, lo;
    split_tf32(a[0], hi.x, lo.x);
    split_tf32(a[1], hi.y, lo.y);
    split_tf32(a[2], hi.z, lo.z);
    split_tf32(a[3], hi.w, lo.w);
    float* dst = rowf + (mb * ks_n + ks) * 256 + l * 4;
    *reinterpret_cast<float4*>(dst) = hi;
    *reinterpret_cast<float4*>(dst + 128) = lo;
  }
  // the rows' folded coordinates: the thread's two rows in registers (one
  // pass), or the block's in shared memory (two passes)
  float xa[kDX], xb[kDX];
#pragma unroll
  for (int k = 0; k < kDX; ++k) {
    xa[k] = (DMAX > 0 && ra < n && k < d) ? __fmul_rn(scale, xs[ra * d + k]) : 0.0f;
    xb[k] = (DMAX > 0 && rb < n && k < d) ? __fmul_rn(scale, xs[rb * d + k]) : 0.0f;
  }
  if (DMAX == 0) {
    for (int i = tid; i < kMomRows * ys; i += kBlock) {
      const int rr = i / ys;
      const int k = i - rr * ys;
      const int64_t row = row0 + rr;
      xrow[i] = (row < n && k < d) ? __fmul_rn(scale, xs[row * d + k]) : 0.0f;
    }
  }

  // this split's column tiles
  const int64_t ntiles = (n + kMomCols - 1) / kMomCols;
  const int64_t t0 = ntiles * blockIdx.y / gridDim.y;
  const int nt = static_cast<int>(ntiles * (blockIdx.y + 1) / gridDim.y - t0);
  // `floats` contiguous floats from src into dst, 16 bytes a copy, zero
  // past the `left` floats that remain in the array
  auto copy_flat = [&](float* dst, const float* src, int floats, int64_t left) {
    for (int i = tid; i < floats / 4; i += kBlock) {
      const int64_t q = left - 4 * i;
      copy_async16(dst + 4 * i, q > 0 ? src + 4 * i : src,
                   q >= 4 ? 16 : (q > 0 ? 4 * static_cast<int>(q) : 0));
    }
  };
  auto issue = [&](int k) {  // tile t0 + k into raw buffer k % 2
    const int64_t col0 = (t0 + k) * kMomCols;
    float* rx = raw + (k % 2) * rawt;
    float* rv = rx + kMomCols * d;
    copy_flat(rx, xs + col0 * d, kMomCols * d, (n - col0) * d);
    if (rc == r) {  // the tile's rows of V are contiguous
      copy_flat(rv, vmat + col0 * r, kMomCols * r, (n - col0) * r);
    } else {
      for (int i = tid; i < kMomCols * rc; i += kBlock) {
        const int j = i / rc;
        const bool in = col0 + j < n;
        copy_async4(rv + i, in ? vmat + (col0 + j) * r + c0 + (i - j * rc) : vmat, in ? 4 : 0);
      }
    }
    copy_async_commit();
  };
  // a landed tile re-laid into layout buffer k % kMomBufs: coordinates
  // folded and zero-padded (four threads a column), V's fragments split
  // (warp w those of step w)
  const int cj = tid / 4;
  auto prepare = [&](int k) {
    const float* rx = raw + (k % 2) * rawt;
    float* dx = xcol + (k % kMomBufs) * xtile + cj * ys;
    for (int e = tid % 4; e < ys; e += 4) dx[e] = e < d ? __fmul_rn(scale, rx[cj * d + e]) : 0.0f;
    const float* rv = rx + kMomCols * d + (warp * 8 + lane / 4) * rc;
    float4* dv = reinterpret_cast<float4*>(vfr + (k % kMomBufs) * vtile) + warp * ks_n * 32 + lane;
#pragma unroll
    for (int kk = 0; kk < ks_n; ++kk) {
      const int c = kk * 8 + lane % 4;
      float4 o;
      split_tf32(c < rc ? rv[c] : 0.0f, o.x, o.z);
      split_tf32(c + 4 < rc ? rv[c + 4] : 0.0f, o.y, o.w);
      dv[kk * 32] = o;
    }
  };
  // W' of the warp's 16 rows by the 8 columns of step s: c[0], c[1] row g
  // by columns 2t, 2t + 1, c[2], c[3] row g + 8; hi.hi and the two lo
  // terms in two accumulators, so that two chains of mma.sync run at once
  const float* at = rowf + warp * ks_n * 256 + lane * 4;
  auto w_step = [&](const float* bt, int s, float (&c)[4]) {
    float cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ks_n; ++kk) {
      const float4 ah = *reinterpret_cast<const float4*>(at + kk * 256);
      const float4 al = *reinterpret_cast<const float4*>(at + kk * 256 + 128);
      const float4 b = *reinterpret_cast<const float4*>(bt + (s * ks_n + kk) * 128);
      mma_tf32(cl, al, b.x, b.y);
      mma_tf32(cl, ah, b.z, b.w);
      mma_tf32(c, ah, b.x, b.y);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] += cl[q];
  };
  // a warp's eight float32 sums into its float64 sums of dimensions k0 ..
  // k0 + 7: a butterfly over the lanes (each level halves the values a lane
  // keeps), in the same order on every launch; lane 4j then holds the sum
  // of dimension k0 + j
  auto flush8 = [&](const float (&v)[8], int k0) {
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    float u[4], w2[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = (b4 ? v[4 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[4 + i], 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      w2[i] = (b3 ? u[2 + i] : u[i]) + __shfl_xor_sync(0xffffffffu, b3 ? u[i] : u[2 + i], 8);
    float z = (b2 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, b2 ? w2[0] : w2[1], 4);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    if (t == 0) wmom[warp * kMomRow + k0 + lane / 4] += static_cast<double>(z);
  };

  double m0 = 0.0;  // s0 over the walk
  if (nt > 0) {
    issue(0);
    copy_async_wait();
    __syncthreads();
    prepare(0);
    if (nt > 1) issue(1);
  }
  for (int k = 0; k < nt; ++k) {
    // tile k + 1 has landed; every thread is done with tile k - 1's layout
    // buffer and tile k's raw one
    copy_async_wait();
    __syncthreads();
    if (k + 1 < nt) prepare(k + 1);
    if (k + 2 < nt) issue(k + 2);
    const float* xt = xcol + (k % kMomBufs) * xtile;
    const float* bt = vfr + (k % kMomBufs) * vtile + lane * 4;
    float s0 = 0.0f;
    float c[4], cn[4];
    w_step(bt, 0, c);
    if constexpr (DMAX > 0) {
      float mt[kMT];
#pragma unroll
      for (int e = 0; e < kMT; ++e) mt[e] = 0.0f;
#pragma unroll
      for (int s = 0; s < kMomSteps; ++s) {
        if (s + 1 < kMomSteps) w_step(bt, s + 1, cn);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // column 8 s + 2t + h
          const float4* yp = reinterpret_cast<const float4*>(xt + (s * 8 + 2 * t + h) * ys);
          float y[kDX];
#pragma unroll
          for (int k4 = 0; k4 < kDX / 4; ++k4) {
            const float4 p = yp[k4];
            y[4 * k4] = p.x; y[4 * k4 + 1] = p.y; y[4 * k4 + 2] = p.z; y[4 * k4 + 3] = p.w;
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {  // row g, then g + 8
            const float* x = q ? xb : xa;
            float dq[kDX];  // q_e: r2' and the moments both read them
            float r2 = 0.0f;
#pragma unroll
            for (int e = 0; e < kDX; ++e) {
              const float diff = x[e] - y[e];
              dq[e] = __fmul_rn(diff, diff);
              r2 = e == 0 ? dq[0] : __fadd_rn(r2, dq[e]);
            }
            float wk, wn;
            moment_weights<FAM>(r2, c[2 * q + h], wk, wn);
            s0 += wk;
#pragma unroll
            for (int e = 0; e < kDX; ++e) mt[e] = fmaf(wn, dq[e], mt[e]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) c[q] = cn[q];
      }
#pragma unroll
      for (int k0 = 0; k0 < kMT; k0 += 8) {
        float v8[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v8[i] = mt[k0 + i];
        flush8(v8, k0);
      }
    } else {
      const float* xra = xrow + (warp * 16 + lane / 4) * ys;
      const float* xrb = xra + 8 * ys;
      float wn[kMomSteps][4];  // the tile's weights, c's entries
#pragma unroll
      for (int s = 0; s < kMomSteps; ++s) {
        if (s + 1 < kMomSteps) w_step(bt, s + 1, cn);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* yp = reinterpret_cast<const float4*>(xt + (s * 8 + 2 * t + h) * ys);
          float r2a = 0.0f, r2b = 0.0f;
          for (int k4 = 0; k4 < (d + 3) / 4; ++k4) {
            const float4 y = yp[k4];
            const float4 a = reinterpret_cast<const float4*>(xra)[k4];
            const float4 b = reinterpret_cast<const float4*>(xrb)[k4];
            const float py[4] = {y.x, y.y, y.z, y.w}, pa[4] = {a.x, a.y, a.z, a.w},
                        pb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float da = pa[e] - py[e], db = pb[e] - py[e];
              r2a = __fadd_rn(r2a, __fmul_rn(da, da));
              r2b = __fadd_rn(r2b, __fmul_rn(db, db));
            }
          }
          float wk;
          moment_weights<FAM>(r2a, c[h], wk, wn[s][h]);
          s0 += wk;
          moment_weights<FAM>(r2b, c[2 + h], wk, wn[s][2 + h]);
          s0 += wk;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) c[q] = cn[q];
      }
      for (int k0 = 0; k0 < d; k0 += 8) {
        float pa[8], pb[8], mt[8];
        load8(xra + k0, pa);
        load8(xrb + k0, pb);
#pragma unroll
        for (int i = 0; i < 8; ++i) mt[i] = 0.0f;
#pragma unroll
        for (int s = 0; s < kMomSteps; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float y[8];
            load8(xt + (s * 8 + 2 * t + h) * ys + k0, y);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float da = pa[i] - y[i], db = pb[i] - y[i];
              mt[i] = fmaf(wn[s][h], __fmul_rn(da, da), mt[i]);
              mt[i] = fmaf(wn[s][2 + h], __fmul_rn(db, db), mt[i]);
            }
          }
        flush8(mt, k0);
      }
    }
    m0 += s0;
  }

  // s0 of the block, then its warps' moments in order, into the partial
  // row (added to it where `add`: a later launch's columns of V)
  double* row = partial + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kMomRow;
  double s0d[1] = {m0};
  block_sum(s0d, row, tid, add != 0);  // its barrier also orders the warps' last sums
  if (tid < d) {
    double s = 0.0;
    for (int w = 0; w < kMomWarps; ++w) s += wmom[w * kMomRow + tid];
    row[1 + tid] = add ? row[1 + tid] + s : s;
  }
}

template <int FAM, int DMAX>
int launch_wide(const float* xs, const float* x2s, const float* v, const float* vmat,
                float* out, int64_t n, int64_t m, int d, int r, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(gram_matvec_tc_kernel<FAM, DMAX>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kWideSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((n + kWideRows - 1) / kWideRows),
                  static_cast<unsigned>((r + kWideCols - 1) / kWideCols));
  gram_matvec_tc_kernel<FAM, DMAX><<<grid, kWideThreads, kWideSmem, stream>>>(
      xs, x2s, vmat, v, out, n, m, d, r);
  return static_cast<int>(cudaGetLastError());
}

template <int FAM, int RC, int DMAX>
int launch_tile(const float* xs, const float* x2s, const float* v, const float* vmat,
                float* out, int64_t n, int64_t m, int d, int r, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kTileRows - 1) / kTileRows));
  gram_matvec_tile_kernel<FAM, RC, DMAX><<<grid, kTileThreads, 0, stream>>>(
      xs, x2s, vmat, v, out, n, m, d, r);
  return static_cast<int>(cudaGetLastError());
}

// The register-tile kernel's R chunk: 1, 9 or 16, the smallest that holds R.
template <int FAM, int DMAX>
int matvec_tile(const float* xs, const float* x2s, const float* v, const float* vmat,
                float* out, int64_t n, int64_t m, int d, int r, cudaStream_t s) {
  if (r == 1) return launch_tile<FAM, 1, DMAX>(xs, x2s, v, vmat, out, n, m, d, r, s);
  if (r <= 9) return launch_tile<FAM, 9, DMAX>(xs, x2s, v, vmat, out, n, m, d, r, s);
  return launch_tile<FAM, 16, DMAX>(xs, x2s, v, vmat, out, n, m, d, r, s);
}

// Two m-blocks a warp where three such blocks fit in an SM's shared memory
// (at N = 50,000 on an H100: D <= 16, and D <= 24 at R <= 9), else one:
// two halve the shared-memory reads of V's rows and the B fragments an
// entry, but at a block of 4 warps, more shared memory than that leaves
// too few warps resident (PERF.md).
template <int FAM, int RC>
int launch_cross(const float* xs, const float* x2s, const float* v, const float* vmat,
                 float* out, int64_t n, int64_t m, int d, int r, int64_t diag,
                 cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(float)) * cross_smem_floats(d, RC, v_stride<RC>());
  const bool two = cross_min_blocks(RC, 2) * (bytes + 1024) <= 228 * 1024;  // 1 KB a block reserved
  const cudaError_t e = cudaFuncSetAttribute(
      two ? gram_matvec_cross_kernel<FAM, RC, 2> : gram_matvec_cross_kernel<FAM, RC, 1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((n + kCrossRows - 1) / kCrossRows));
  if (two)
    gram_matvec_cross_kernel<FAM, RC, 2><<<grid, kCrossThreads<2>, bytes, stream>>>(
        xs, x2s, vmat, v, out, n, m, d, r, diag);
  else
    gram_matvec_cross_kernel<FAM, RC, 1><<<grid, kCrossThreads<1>, bytes, stream>>>(
        xs, x2s, vmat, v, out, n, m, d, r, diag);
  return static_cast<int>(cudaGetLastError());
}

// The cross-term kernel's R chunk, as matvec_tile's.
template <int FAM>
int matvec_cross(const float* xs, const float* x2s, const float* v, const float* vmat,
                 float* out, int64_t n, int64_t m, int d, int r, int64_t diag, cudaStream_t s) {
  if (r == 1) return launch_cross<FAM, 1>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
  if (r <= 9) return launch_cross<FAM, 9>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
  return launch_cross<FAM, 16>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
}

// R <= 16: for D <= 8 the register-tile kernel, for D <= kCrossMaxD the
// cross-term kernel, each with its R chunk 1 for a vector, else the smaller
// of 9 and 16 that holds R. Nine is the CG width of the N = 50k
// configuration (1 target + 8 probes). R > 16 (a predict's n* columns), or
// D > kCrossMaxD: the tensor-core kernel, its rows' coordinates in shared
// memory for D <= 8. `diag` reaches the one kernel that needs it: the
// others form r2 by direct differences, exactly 0 between equal points.
template <int FAM>
int matvec_family(const float* xs, const float* x2s, const float* v, const float* vmat,
                  float* out, int64_t n, int64_t m, int d, int r, int64_t diag,
                  cudaStream_t s) {
  if (d <= 4 && r <= 16) return matvec_tile<FAM, 4>(xs, x2s, v, vmat, out, n, m, d, r, s);
  if (d <= 8 && r <= 16) return matvec_tile<FAM, 8>(xs, x2s, v, vmat, out, n, m, d, r, s);
  if (d <= kCrossMaxD && r <= 16) return matvec_cross<FAM>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
  if (d <= 4) return launch_wide<FAM, 4>(xs, x2s, v, vmat, out, n, m, d, r, s);
  if (d <= 8) return launch_wide<FAM, 8>(xs, x2s, v, vmat, out, n, m, d, r, s);
  return launch_wide<FAM, 0>(xs, x2s, v, vmat, out, n, m, d, r, s);
}

template <int FAM, int RC, int DMAX>
int launch_moments_tile(const float* xs, const float* g, const float* vmat, const float* v,
                        double* partial, double* out, int64_t n, int d, int r,
                        cudaStream_t s) {
  const int tiles = static_cast<int>((n + kTileRows - 1) / kTileRows);
  gram_moments_tile_kernel<FAM, RC, DMAX><<<tiles, kTileThreads, 0, s>>>(xs, g, vmat, v, partial,
                                                                          n, d, r);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  gram_moments_reduce<<<1, 128, 0, s>>>(partial, v, out, tiles, d, moments_scale<FAM>());
  return static_cast<int>(cudaGetLastError());
}

// The register-tile kernel's R chunk, as matvec_tile's.
template <int FAM, int DMAX>
int moments_tile(const float* xs, const float* g, const float* vmat, const float* v,
                 double* partial, double* out, int64_t n, int d, int r, cudaStream_t s) {
  if (r == 1) return launch_moments_tile<FAM, 1, DMAX>(xs, g, vmat, v, partial, out, n, d, r, s);
  if (r <= 9) return launch_moments_tile<FAM, 9, DMAX>(xs, g, vmat, v, partial, out, n, d, r, s);
  return launch_moments_tile<FAM, 16, DMAX>(xs, g, vmat, v, partial, out, n, d, r, s);
}

// The mma kernel at D = d, R = r, on its own dimension bound DMAX and KS
// k-steps of R (0: as many as the launch's columns need): launches of at
// most kMomMaxR columns of V (fewer where shared memory is short), each
// over ceil(n / 128) row blocks by `splits` column splits, the splits that
// give the fewest waves of resident blocks a split (up to kMomMaxSplits),
// then the reduce over the tiles x splits partial rows.
template <int FAM, int DMAX, int KS>
int launch_moments_mma(const float* xs, const float* g, const float* vmat, const float* v,
                       double* partial, double* out, int64_t n, int d, int r, cudaStream_t s) {
  const auto kernel = gram_moments_mma_kernel<FAM, DMAX, KS>;
  int rmax = kMomMaxR;
  while (rmax > 8 && mom_smem_bytes(DMAX, d, rmax / 8) > kMomSmemMax) rmax -= 8;
  const int bytes_max = mom_smem_bytes(DMAX, d, ((r < rmax ? r : rmax) + 7) / 8);
  if (bytes_max > kMomSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes_max);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kBlock, bytes_max)) !=
          cudaSuccess)
    return static_cast<int>(e);
  const int64_t tiles = (n + kMomRows - 1) / kMomRows;
  const int64_t slots = sms * per > 0 ? static_cast<int64_t>(sms) * per : 1;
  int splits = 1;
  for (int sp = 2; sp <= kMomMaxSplits; ++sp)  // waves a split: ceil(tiles sp / slots) / sp
    if ((tiles * sp + slots - 1) / slots * splits < (tiles * splits + slots - 1) / slots * sp)
      splits = sp;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits));
  for (int c0 = 0; c0 < r; c0 += rmax) {
    const int rc = r - c0 < rmax ? r - c0 : rmax;
    kernel<<<grid, kBlock, mom_smem_bytes(DMAX, d, (rc + 7) / 8), s>>>(xs, g, vmat, v, partial, n,
                                                                      d, r, c0, rc, c0 > 0);
    const int rc_err = static_cast<int>(cudaGetLastError());
    if (rc_err != 0) return rc_err;
  }
  gram_moments_reduce<<<1, 128, 0, s>>>(partial, v, out, static_cast<int>(tiles) * splits, d,
                                        moments_scale<FAM>());
  return static_cast<int>(cudaGetLastError());
}

// The mma kernel's k-steps for R <= 16 fixed (1 or 2: W's mma.sync
// unrolled, so the scheduler can run the next step's beside this one's
// entries; a runtime count ran 9-30% slower on an H100), else as many as
// each launch needs.
template <int FAM, int DMAX>
int moments_mma(const float* xs, const float* g, const float* vmat, const float* v,
                double* partial, double* out, int64_t n, int d, int r, cudaStream_t s) {
  if (r <= 8) return launch_moments_mma<FAM, DMAX, 1>(xs, g, vmat, v, partial, out, n, d, r, s);
  if (r <= 16) return launch_moments_mma<FAM, DMAX, 2>(xs, g, vmat, v, partial, out, n, d, r, s);
  return launch_moments_mma<FAM, DMAX, 0>(xs, g, vmat, v, partial, out, n, d, r, s);
}

// D <= 8 and R <= 16: the register-tile kernel; otherwise the mma kernel,
// its coordinates in registers up to D = 12 (DMAX 4, 8, 12; DMAX 12 at D = 8
// ran 13-22% slower), else in shared memory (two passes); at D <= 8 it
// takes R > 16 only.
template <int FAM>
int moments_family(const float* xs, const float* g, const float* vmat, const float* v,
                   double* partial, double* out, int64_t n, int d, int r, cudaStream_t s) {
  if (d <= 4 && r <= 16) return moments_tile<FAM, 4>(xs, g, vmat, v, partial, out, n, d, r, s);
  if (d <= 8 && r <= 16) return moments_tile<FAM, 8>(xs, g, vmat, v, partial, out, n, d, r, s);
  if (d <= 4) return launch_moments_mma<FAM, 4, 0>(xs, g, vmat, v, partial, out, n, d, r, s);
  if (d <= 8) return launch_moments_mma<FAM, 8, 0>(xs, g, vmat, v, partial, out, n, d, r, s);
  if (d <= 12) return moments_mma<FAM, 12>(xs, g, vmat, v, partial, out, n, d, r, s);
  return moments_mma<FAM, 0>(xs, g, vmat, v, partial, out, n, d, r, s);
}

}  // namespace

// C interface, loaded with ctypes. Each call enqueues its launches on
// `stream` and returns cudaGetLastError() (0 when the launches were
// accepted); an unknown family returns cudaErrorInvalidValue.
extern "C" {

// xs (n, d), x2s (m, d), vmat (m, r), out (n, r); all float32, row-major;
// x2s and vmat 16-byte aligned. diag >= 0: row i of xs is row i + diag of
// x2s (a square Gram: 0; a row slab of one: its first row), where r2 is 0
// exactly; -1: no such rows.
int gram_matvec_fused_f32(const float* xs, const float* x2s, const float* v,
                          const float* vmat, float* out, int64_t n, int64_t m, int d,
                          int r, int family, int64_t diag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return matvec_family<0>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
    case 1: return matvec_family<1>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
    case 2: return matvec_family<2>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
    case 3: return matvec_family<3>(xs, x2s, v, vmat, out, n, m, d, r, diag, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// xs (n, d), g and vmat (n, r) float32, xs and vmat 16-byte aligned; d <=
// 127; partial holds ceil(n / 128) * 4 * 128 doubles of scratch (128-double
// rows: the register-tile kernel uses ceil(n / 128) of them, the mma kernel
// ceil(n / 128) times its column splits, at most kMomMaxSplits = 4); out
// (d + 1,) float64.
int gram_moments_f32(const float* xs, const float* g, const float* vmat, const float* v,
                     double* partial, double* out, int64_t n, int d, int r, int family,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case 0: return moments_family<0>(xs, g, vmat, v, partial, out, n, d, r, s);
    case 1: return moments_family<1>(xs, g, vmat, v, partial, out, n, d, r, s);
    case 2: return moments_family<2>(xs, g, vmat, v, partial, out, n, d, r, s);
    case 3: return moments_family<3>(xs, g, vmat, v, partial, out, n, d, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gram_matvec_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
