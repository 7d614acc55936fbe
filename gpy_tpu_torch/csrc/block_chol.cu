// Batched Cholesky of 128x128 blocks for Hopper (sm_90a), float32 and
// float64, with an entry that also emits the factor's inverse.
//
//   block_chol:     L[c] = chol(A[c])                 for c < C
//   block_chol_inv: L[c] = chol(A[c]), Li[c] = L[c]^-1
//
// A, L and Li are (C, 128, 128), row-major and contiguous. The result
// depends on A's lower triangle alone; L is written lower-triangular (exact
// zeros above the diagonal). A block that is not positive definite comes
// out with NaN in its factor from the first bad pivot on: the pivot's
// square root is NaN (or its reciprocal infinite) and the updates carry it
// into every later column. That NaN is the signal of the jitter ladder
// (util/linalg.py), so nothing here clamps a pivot or skips work, and the
// file is built without fast math. Blocks never share data and nothing is
// accumulated atomically: one non-SPD block leaves every other block's
// factor bit-equal to a clean run, and two launches give equal bits.
//
// Replaces three TPU kernels of gpy_tpu/ops/pallas_chol.py:
//   _block_kernel_v2 (:123, via pallas_block_chol :249) and
//   _block_kernel_v2_multi (:175, call :265), one function under two TPU
//   schedules (8-wide panels; 8-element slabs interleaved for 8 < C <= 32),
//   become `block_chol`: on the card the blocks of a batch run on separate
//   SMs, so there is nothing to interleave;
//   _block_kernel (:64, via pallas_block_chol_inv :224) becomes
//   `block_chol_inv`, on the factor of `block_chol`. The TPU kernels
//   write L transposed (a Mosaic layout constraint); here L is written as
//   it is.
//
// block_chol: a blocked right-looking factor, one 512-thread block per
// matrix, the matrix in shared memory (rows padded by 16 bytes, so that
// 16-byte accesses along a row or down a column of rows are free of bank
// conflicts; 67.6 KB in float32, 133 KB in float64) and factored in eight
// panels of 16 columns. Per panel, three barriers:
//   (a) one warp factors the 16x16 diagonal block warp-synchronously: lane
//       i holds row i, the pivot and the columns are broadcast with
//       __shfl_sync. The chain from one pivot to the next is a shuffle,
//       rsqrt (one step, within 2 / 1 ulp of the twin's IEEE 1 / sqrt in
//       float32 / float64), a multiply and an FMA; the diagonal entries
//       are IEEE square roots taken off the chain, once per lane, so an
//       exactly zero pivot gives the twin's 0 and infinities;
//   (b) one thread per row below the block solves that row against it
//       (forward substitution, 16 dependent steps), writing the panel of L
//       back and a transposed copy for (c);
//   (c) the trailing lower triangle takes A22 -= L21 L21^T: each thread
//       owns one 4x4 micro-tile of it (at most 406 tiles, for the first
//       panel) and runs 16 dense steps of two 16-byte loads and 16 FMAs;
//       tiles above the diagonal are never issued.
// Every entry takes its updates in column order, as the twin does, with
// one FMA each where the twin multiplies and subtracts.
//
// Bound on an H100 SXM (3.35 TB/s, 67 / 34 TFLOP/s float32 / float64
// outside the tensor cores): at C = 8 float32 a launch moves 2 * 8 * 64 KB
// = 1 MB (0.31 us) and does 8 * 128^3 / 6 multiply-adds (0.08 us). With one
// block per matrix (C of 132 SMs busy) it is latency-bound far above both:
// the chain of 128 pivots, the load and store of the matrix through one
// SM, 24 barriers and, in float64, the trailing updates' shared-memory
// traffic set the time. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (profiler device time per launch, C = 2-16, PERF.md): 17.1-17.6 us in
// float32 and 33.8-34.7 us in float64, against 0.239 and 0.242 ms for the
// column loop this design replaced and 0.094-0.104 ms for batched
// torch.linalg.cholesky.
//
// block_chol_inv (B4) runs the same factor (`factor_tile`, one code for
// both kernels), stores L, and then builds X = L^-1 in the same tile:
// one padded tile per matrix holds L below the diagonal and X^T on and
// above it, with 1 / L[k][k] in a 128-vector. A second tile for X
// would not fit in float64 (2 x 133 KB against the 227 KB a block can
// have), and re-reading L's panels from global memory would put an L2
// round trip on each panel; packing keeps both in shared memory and is one
// design for both types (150.7 / 76.4 KB in float64 / float32). X starts as
// the identity and is completed by row panels of 16, two barriers each:
//   (a) one thread per column j < q0 + 16 runs the 16-step chain down the
//       panel's rows of its column, X[k, j] *= 1 / L[k, k] and X[i, j] -=
//       L[i, k] X[k, j] for the panel's rows i > k; columns are
//       independent, so no shuffles. Its 16 entries come and go as 16-byte
//       pieces of X^T's row j, and also go to a [16][128] buffer of the
//       panel's rows of X. The twin divides by L[k, k]; here each pivot's
//       IEEE reciprocal is taken once, off the chain, as the factor's panel
//       solve and the twin's factor take theirs (within 1 ulp of the
//       quotient). An IEEE division on the chain is a reciprocal, four
//       FMAs and a range check whose slow path, a call, is taken for zero
//       dividends: the zeros above X's diagonal in the panel's own
//       columns, and whole identity-padded blocks in the blocked routines.
//       Dividing, a float32 launch took 45.3 us, 30.6 with those zeros
//       replaced by ones, and 26.8 as here (PERF.md);
//   (b) the rows below the panel take X[i, j] -= sum_k L[i, q0+k]
//       X[q0+k, j] (i >= q0 + 16 > j), a rank-16 update in 4x4 register
//       tiles (at most 256) like the factor's (c), L's 4x4 blocks read as
//       16-byte rows and X's from the buffer.
// So every entry of X takes its updates in increasing k, one FMA each,
// and its scaling by 1 / L[k, k] last, in the twin's order. Li is
// written lower-triangular with exact zeros above the diagonal: a non-SPD
// block has NaN in the lower triangle of the rows from its first bad
// pivot on, in L and Li alike (an exactly zero pivot gives the twin's
// infinities: x * (1 / 0) is x / 0). Bound at C = 8 float32: 3 x 512 KB
// moved (0.47 us) and twice the factor's multiply-adds; like the factor
// it is latency-bound: the pivot chain, (a)'s eight 16-step chains, 40
// barriers and the matrix's passes through one SM. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (profiler device time per launch, C = 2-16,
// PERF.md): 26.8-26.9 us in float32 and 51.6-52.2 us in float64, against
// 0.353 and 0.529 ms for the column loop this design replaced and
// 0.17-0.38 / 0.19-0.52 ms for torch.linalg.cholesky + solve_triangular.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 128;                  // block edge
constexpr unsigned kFull = 0xffffffffu;  // all lanes of a warp

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
// 1/sqrt(x) in one step, within 2 ulp (float32) or 1 ulp (float64) of the
// plain twin's IEEE 1 / sqrt(x)
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// ---- block_chol (B2/B3): the blocked factor --------------------------------

constexpr int kNB = 16;                  // panel width
constexpr int kPanels = kN / kNB;        // 8
constexpr int kTile = 4;                 // trailing-update micro-tile edge
constexpr int kThreads = 512;            // 16 warps; >= the first panel's 406 tiles

// 16 bytes of T, and the row stride of the shared matrix: 16 bytes of
// padding per row shift successive rows by one 16-byte bank group
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };
template <typename T> constexpr int kVec = 16 / sizeof(T);
template <typename T> constexpr int kLd = kN + kVec<T>;

__device__ __forceinline__ void unpack(float* d, float4 v) { d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w; }
__device__ __forceinline__ void unpack(double* d, double2 v) { d[0] = v.x; d[1] = v.y; }
__device__ __forceinline__ float4 pack(const float* d) { return make_float4(d[0], d[1], d[2], d[3]); }
__device__ __forceinline__ double2 pack(const double* d) { return make_double2(d[0], d[1]); }

// N consecutive elements at a 16-byte-aligned address, in 16-byte accesses
template <int N, typename T>
__device__ __forceinline__ void load_n(T* d, const T* p) {
#pragma unroll
  for (int i = 0; i < N; i += kVec<T>) unpack(d + i, *reinterpret_cast<const typename Vec<T>::type*>(p + i));
}
template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, const T* d) {
#pragma unroll
  for (int i = 0; i < N; i += kVec<T>) *reinterpret_cast<typename Vec<T>::type*>(p + i) = pack(d + i);
}

// The 16-byte vector `v` of a matrix pass (load or store): a warp covers 4
// rows x 128 bytes, so each 8 lanes read or write one whole 128-byte line
// of A or L, and the 8 lanes of a quarter-warp hit 8 different bank groups
// of the padded shared rows.
template <typename T>
__device__ __forceinline__ void vec_coords(int v, int& row, int& col) {
  constexpr int segs = kN / kVec<T> / 8;  // 8-vector segments per row
  const int lane = v & 31, group = v >> 5;
  row = (group / segs) * 4 + (lane >> 3);
  col = ((group % segs) * 8 + (lane & 7)) * kVec<T>;
}

// The blocked factor of one matrix, shared by both kernels: A's lower
// triangle is loaded into the shared tile s and factored in place (the
// design above). On return, after a barrier, s's lower triangle holds L;
// the entries above the diagonal hold leftovers of the panels, which are
// never part of a result. pt and dinv are the factor's scratch.
template <typename T>
__device__ __forceinline__ void factor_tile(const T* __restrict__ a, T* s, T* pt, T* dinv) {
  constexpr int ld = kLd<T>;
  constexpr int nv = kVec<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // this thread's micro-tile (ti, tj), ti >= tj, numbered row by row, so the
  // first nt (nt + 1) / 2 numbers are the tiles of an nt x nt triangle
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
  const int tj = tid - ti * (ti + 1) / 2;

  // load: the lower triangle, zeros above the diagonal
  for (int v = tid; v < kN * kN / nv; v += kThreads) {
    int row, col;
    vec_coords<T>(v, row, col);
    T e[nv];
    if (col <= row) load_n<nv>(e, a + row * kN + col);
#pragma unroll
    for (int j = 0; j < nv; ++j)
      if (col + j > row) e[j] = T(0);
    store_n<nv>(s + row * ld + col, e);
  }
  __syncthreads();

  for (int p = 0; p < kPanels; ++p) {
    const int q0 = p * kNB;
    // (a) the diagonal block, by warp 0 (lanes 16-31 mirror lanes 0-15)
    if (tid < 32) {
      const int i = lane & (kNB - 1);
      T r[kNB];
      load_n<kNB>(r, s + (q0 + i) * ld + q0);
      T piv = __shfl_sync(kFull, r[0], 0);
      T mine = piv;  // lane i's own pivot, whose square root is L[i][i]
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        const T inv = rsqrt_t(piv);
        const T lik = r[k] * inv;
        r[k] = lik;  // lane k's r[k] is replaced by L[k][k] below
        if (i == k) mine = piv;
        if (k + 1 < kNB) {
          // lane k+1's next pivot from its own entry, off the shuffles below
          const T own = fma_t(-lik, lik, r[k + 1]);
#pragma unroll
          for (int j = k + 1; j < kNB; ++j)
            r[j] = fma_t(-lik, __shfl_sync(kFull, lik, j), r[j]);
          piv = __shfl_sync(kFull, own, k + 1);
        }
        if (lane == 0) dinv[k] = inv;
      }
      // row i's entries right of the diagonal are never read again; the
      // IEEE square roots of the pivots, off the chain, once per lane
      if (lane < kNB) {
        store_n<kNB>(s + (q0 + i) * ld + q0, r);
        s[(q0 + i) * ld + q0 + i] = sqrt_t(mine);
      }
    }
    __syncthreads();

    // (b) rows below the diagonal block against it
    const int m = kN - q0 - kNB;
    if (tid < m) {
      const int row = q0 + kNB + tid;
      T x[kNB];
      load_n<kNB>(x, s + row * ld + q0);
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        x[k] *= dinv[k];
#pragma unroll
        for (int j = k + 1; j < kNB; ++j)
          x[j] = fma_t(-x[k], s[(q0 + j) * ld + q0 + k], x[j]);
      }
      store_n<kNB>(s + row * ld + q0, x);
#pragma unroll
      for (int j = 0; j < kNB; ++j) pt[j * kN + row] = x[j];
    }
    __syncthreads();

    // (c) the trailing lower triangle, one 4x4 tile a thread
    const int nt = m / kTile;
    if (tid < nt * (nt + 1) / 2) {
      const int r0 = q0 + kNB + kTile * ti;
      const int c0 = q0 + kNB + kTile * tj;
      T acc[kTile][kTile];
#pragma unroll
      for (int u = 0; u < kTile; ++u) load_n<kTile>(acc[u], s + (r0 + u) * ld + c0);
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        T x[kTile], y[kTile];
        load_n<kTile>(x, pt + k * kN + r0);
        load_n<kTile>(y, pt + k * kN + c0);
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int w = 0; w < kTile; ++w) acc[u][w] = fma_t(-x[u], y[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < kTile; ++u) store_n<kTile>(s + (r0 + u) * ld + c0, acc[u]);
    }
    __syncthreads();
  }
}

// The shared memory of both kernels: the padded tile, the factor's panel
// (the inverse's panel rows of X after it) and 1 / L[k][k] of the diagonal
// block (the factor's, rsqrt). block_chol_inv appends 1 / L[k][k] of all
// 128 (IEEE) past dinv, in the kN entries kInvSmem adds.
template <typename T> struct Smem {
  T* s;
  T* pt;
  T* dinv;
  __device__ explicit Smem(unsigned char* raw)
      : s(reinterpret_cast<T*>(raw)), pt(s + kN * kLd<T>), dinv(pt + kNB * kN) {}
};
template <typename T>
constexpr size_t kFactorSmem = (kN * kLd<T> + kNB * kN + kNB) * sizeof(T);
template <typename T>
constexpr size_t kInvSmem = kFactorSmem<T> + kN * sizeof(T);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
block_chol_kernel(const T* __restrict__ a, T* __restrict__ l) {
  constexpr int ld = kLd<T>;
  constexpr int nv = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kN * kN;
  factor_tile(a + base, sm.s, sm.pt, sm.dinv);

  // store: L, zeros above the diagonal
  for (int v = threadIdx.x; v < kN * kN / nv; v += kThreads) {
    int row, col;
    vec_coords<T>(v, row, col);
    T e[nv];
    load_n<nv>(e, sm.s + row * ld + col);
#pragma unroll
    for (int j = 0; j < nv; ++j)
      if (col + j > row) e[j] = T(0);
    store_n<nv>(l + base + row * kN + col, e);
  }
}

template <typename T>
int launch_factor(const T* a, T* l, int c, void* stream) {
  // the attribute belongs to the kernel: set once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFactorSmem<T>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  block_chol_kernel<T><<<c, kThreads, kFactorSmem<T>, static_cast<cudaStream_t>(stream)>>>(a, l);
  return static_cast<int>(cudaGetLastError());
}

// ---- block_chol_inv (B4): the same factor, then X = L^-1 by row panels -----

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
block_chol_inv_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ li) {
  constexpr int ld = kLd<T>;
  constexpr int nv = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  T* const s = sm.s;     // L below the diagonal; X^T on and above it
  T* const pt = sm.pt;   // [kNB][kN]: the panel's rows of X, X[q0 + k][j] at k * kN + j
  T* const rdiag = sm.dinv + kNB;  // [kN], in kInvSmem only
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kN * kN;
  factor_tile(a + base, s, pt, sm.dinv);

  // store: L, zeros above the diagonal. In the tile, L's diagonal goes
  // (as its reciprocal) to rdiag and X^T starts as the identity on and
  // above the diagonal; each vector has one owner, so this needs no
  // barrier of its own
  for (int v = tid; v < kN * kN / nv; v += kThreads) {
    int row, col;
    vec_coords<T>(v, row, col);
    T e[nv];
    load_n<nv>(e, s + row * ld + col);
#pragma unroll
    for (int j = 0; j < nv; ++j) {
      if (col + j == row) rdiag[row] = T(1) / e[j];
      if (col + j > row) e[j] = T(0);
    }
    store_n<nv>(l + base + row * kN + col, e);
    if (col + nv > row) {
#pragma unroll
      for (int j = 0; j < nv; ++j)
        if (col + j == row) e[j] = T(1);
      store_n<nv>(s + row * ld + col, e);
    }
  }
  __syncthreads();

  for (int p = 0; p < kPanels; ++p) {
    const int q0 = p * kNB;
    const int w = q0 + kNB;  // X's columns that are non-zero in the panel's rows
    // (a) the panel's rows, one thread per column j < w: forward
    // substitution down the column's 16 entries, X[k, j] *= 1 / L[k, k],
    // then X[i, j] -= L[i, k] X[k, j] for the panel's rows i > k, in the
    // twin's order; the entries above X's diagonal are zeros (L lies there
    // in the tile), so are computed but never stored
    if (tid < w) {
      const int j = tid;
      T x[kNB];
      load_n<kNB>(x, s + j * ld + q0);
#pragma unroll
      for (int k = 0; k < kNB; ++k)
        if (q0 + k < j) x[k] = T(0);
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        x[k] *= rdiag[q0 + k];
#pragma unroll
        for (int i = k + 1; i < kNB; ++i)
          x[i] = fma_t(-s[(q0 + i) * ld + q0 + k], x[k], x[i]);
      }
#pragma unroll
      for (int k = 0; k < kNB; ++k) pt[k * kN + j] = q0 + k < j ? T(0) : x[k];
      if (j < q0) {
        store_n<kNB>(s + j * ld + q0, x);
      } else {
#pragma unroll
        for (int k = 0; k < kNB; ++k)
          if (q0 + k >= j) s[j * ld + q0 + k] = x[k];
      }
    }
    __syncthreads();

    // (b) the rows below the panel take its rank-16 update, X[i, j] -=
    // sum_k L[i, q0 + k] X[q0 + k, j] for i >= w > j, in increasing k: one
    // 4x4 tile a thread (at most 256 tiles, at q0 = 48), kept as
    // acc[v][u] = X[r0 + u][c0 + v] = X^T[c0 + v][r0 + u]; L's 4x4 blocks
    // come in 16-byte rows, X's panel rows from pt
    const int nc = w / kTile;
    const int nr = (kN - w) / kTile;
    if (tid < nr * nc) {
      const int r0 = w + kTile * (tid / nc);
      const int c0 = kTile * (tid % nc);
      T acc[kTile][kTile];
#pragma unroll
      for (int v = 0; v < kTile; ++v) load_n<kTile>(acc[v], s + (c0 + v) * ld + r0);
#pragma unroll
      for (int kk = 0; kk < kNB; kk += kTile) {
        T lb[kTile][kTile];  // lb[u][t] = L[r0 + u][q0 + kk + t]
#pragma unroll
        for (int u = 0; u < kTile; ++u) load_n<kTile>(lb[u], s + (r0 + u) * ld + q0 + kk);
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          T y[kTile];
          load_n<kTile>(y, pt + (kk + t) * kN + c0);
#pragma unroll
          for (int v = 0; v < kTile; ++v)
#pragma unroll
            for (int u = 0; u < kTile; ++u) acc[v][u] = fma_t(-lb[u][t], y[v], acc[v][u]);
        }
      }
#pragma unroll
      for (int v = 0; v < kTile; ++v) store_n<kTile>(s + (c0 + v) * ld + r0, acc[v]);
    }
    __syncthreads();
  }

  // store: L^-1 = X from X^T, zeros above the diagonal. A warp's lanes take
  // 32 consecutive columns j, each reading 16 bytes of X^T's row j and
  // writing them down column j, so every row of Li is written in whole
  // 128-byte lines
  for (int v = tid; v < kN * kN / nv; v += kThreads) {
    const int j = v & (kN - 1);
    const int i0 = v / kN * nv;
    T e[nv];
    load_n<nv>(e, s + j * ld + i0);
#pragma unroll
    for (int u = 0; u < nv; ++u) li[base + (i0 + u) * kN + j] = i0 + u >= j ? e[u] : T(0);
  }
}

template <typename T>
int launch_inv(const T* a, T* l, T* li, int c, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_chol_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kInvSmem<T>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  block_chol_inv_kernel<T><<<c, kThreads, kInvSmem<T>, static_cast<cudaStream_t>(stream)>>>(
      a, l, li);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Each call enqueues one launch of C blocks
// on `stream` and returns the CUDA error code (0 when the launch was
// accepted).
extern "C" {

int block_chol_f32(const float* a, float* l, int c, void* stream) {
  return launch_factor<float>(a, l, c, stream);
}

int block_chol_f64(const double* a, double* l, int c, void* stream) {
  return launch_factor<double>(a, l, c, stream);
}

int block_chol_inv_f32(const float* a, float* l, float* li, int c, void* stream) {
  return launch_inv<float>(a, l, li, c, stream);
}

int block_chol_inv_f64(const double* a, double* l, double* li, int c, void* stream) {
  return launch_inv<double>(a, l, li, c, stream);
}

const char* block_chol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
