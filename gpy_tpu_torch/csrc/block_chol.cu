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
//   `block_chol_inv`. The TPU kernels write L transposed (a Mosaic layout
//   constraint); here L is written as it is.
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
// block_chol_inv (B4) still runs that column loop, until its own redesign:
// one 512-thread block per matrix, thread (tx, ty) of a 32 x 16 layout
// holding the 8 x 4 entries (ty + 16a, tx + 32b) in registers; at step k
// the holders of column k publish it to a double-buffered shared column,
// every thread applies the rank-1 update to its lower-triangle entries
// (one __syncthreads a step). The inverse is forward substitution in the
// same form, X = L^-1 with X[k, :] = B[k, :] / L[k, k] and B[i, :] -=
// L[i, k] X[k, :] for i > k, X in registers; its columns of L come from a
// shared copy of L^T that the factor loop fills as it goes (64 KB in
// float32, 128 KB in float64, since two float64 tiles exceed the 227 KB a
// block can have).

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
block_chol_kernel(const T* __restrict__ a, T* __restrict__ l) {
  constexpr int ld = kLd<T>;
  constexpr int nv = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [kN][ld]: the matrix, factored in place
  T* pt = s + kN * ld;                    // [kNB][kN]: the panel below the diagonal, transposed
  T* dinv = pt + kNB * kN;                // [kNB]: 1 / L[k][k] of the diagonal block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kN * kN;

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
    if (col <= row) load_n<nv>(e, a + base + row * kN + col);
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

  // store: L, zeros above the diagonal
  for (int v = tid; v < kN * kN / nv; v += kThreads) {
    int row, col;
    vec_coords<T>(v, row, col);
    T e[nv];
    load_n<nv>(e, s + row * ld + col);
#pragma unroll
    for (int j = 0; j < nv; ++j)
      if (col + j > row) e[j] = T(0);
    store_n<nv>(l + base + row * kN + col, e);
  }
}

template <typename T>
constexpr size_t kFactorSmem = (kN * kLd<T> + kNB * kN + kNB) * sizeof(T);

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

// ---- block_chol_inv (B4): the column loop, until B4's redesign --------------

constexpr int kTX = 32;                  // threads along a row (a warp)
constexpr int kTY = 16;                  // warps
constexpr int kRows = kN / kTY;          // rows held by a thread (8)
constexpr int kCols = kN / kTX;          // columns held by a thread (4)

template <typename T>
__global__ void __launch_bounds__(kTX * kTY, 1)
block_chol_inv_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ li) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* colbuf = reinterpret_cast<T*>(smem_raw);  // [2][kN]: the column (or row) in flight
  T* lt = colbuf + 2 * kN;                      // [kN][kN]: L^T

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kN * kN;

  T r[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      r[i][j] = a[base + (ty + kTY * i) * kN + tx + kTX * j];

  for (int k = 0; k < kN; ++k) {
    T* c = colbuf + (k & 1) * kN;
    if (tx == (k & (kTX - 1))) {  // this warp's holder of column k
      const int jk = k / kTX;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j == jk) c[ty + kTY * i] = r[i][j];
    }
    __syncthreads();
    const T piv = sqrt_t(c[k]);
    const T inv = T(1) / piv;
    T lr[kRows], lc[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) lr[i] = c[ty + kTY * i] * inv;
#pragma unroll
    for (int j = 0; j < kCols; ++j) lc[j] = c[tx + kTX * j] * inv;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kTX * j;
        if (col == k) {
          if (row == k) r[i][j] = piv;
          else if (row > k) r[i][j] = lr[i];
        } else if (col > k && row >= col) {
          r[i][j] = fma_t(-lr[i], lc[j], r[i][j]);
        }
      }
    }
    if (tx == 0) {  // column k of L, kept as row k of L^T
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = ty + kTY * i;
        lt[k * kN + row] = row > k ? lr[i] : (row == k ? piv : T(0));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int row = ty + kTY * i;
      const int col = tx + kTX * j;
      l[base + row * kN + col] = col <= row ? r[i][j] : T(0);
    }

  // forward substitution; X starts as the identity and ends as L^-1
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      r[i][j] = (ty + kTY * i == tx + kTX * j) ? T(1) : T(0);
  __syncthreads();  // lt is complete
  for (int k = 0; k < kN; ++k) {
    T* rowbuf = colbuf + (k & 1) * kN;
    if (ty == (k & (kTY - 1))) {  // the warp holding row k finishes it
      const int ik = k / kTY;
      const T dk = lt[k * kN + k];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i == ik) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            r[i][j] = r[i][j] / dk;
            rowbuf[tx + kTX * j] = r[i][j];
          }
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kTY * i;
      if (row > k) {
        const T lik = lt[k * kN + row];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          r[i][j] = fma_t(-lik, rowbuf[tx + kTX * j], r[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      li[base + (ty + kTY * i) * kN + tx + kTX * j] = r[i][j];
}

template <typename T>
int launch_inv(const T* a, T* l, T* li, int c, void* stream) {
  constexpr size_t smem = (2 * kN + kN * kN) * sizeof(T);
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_chol_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  block_chol_inv_kernel<T><<<c, dim3(kTX, kTY), smem, static_cast<cudaStream_t>(stream)>>>(
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
