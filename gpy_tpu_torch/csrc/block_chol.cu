// Batched Cholesky of 128x128 blocks for Hopper (sm_90a), float32 and
// float64, with an entry that also emits the factor's inverse.
//
//   block_chol:     L[c] = chol(A[c])                 for c < C
//   block_chol_inv: L[c] = chol(A[c]), Li[c] = L[c]^-1
//
// A, L and Li are (C, 128, 128), row-major and contiguous. Only the lower
// triangle of A is read; L is written lower-triangular (zeros above the
// diagonal). A block that is not positive definite comes out with NaN in
// its factor from the first bad pivot on: the pivot's square root is NaN
// (or its reciprocal infinite) and the rank-1 updates carry it into every
// later column. That NaN is the signal of the jitter ladder
// (util/linalg.py), so nothing here clamps a pivot or skips work, and the
// file is built without fast math. Blocks never share data: one non-SPD
// block leaves every other block's factor bit-equal to a clean run.
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
// Design: one 512-thread block per matrix (grid = C). Thread (tx, ty) of a
// 32 x 16 layout holds the 8 x 4 entries (ty + 16a, tx + 32b) in registers,
// so a warp loads and stores 32 consecutive entries of a row. The factor is
// the right-looking column algorithm: at step k the threads holding column
// k publish it to a shared buffer, every thread reads the pivot and the
// entries its rows and columns need, and applies the rank-1 update to its
// lower-triangle entries. The column buffer is double-buffered, so one
// __syncthreads separates the steps. The inverse is forward substitution
// in the same right-looking form, X = L^-1 with X[k, :] = B[k, :] / L[k, k]
// and B[i, :] -= L[i, k] X[k, :] for i > k, X in registers. Its columns of
// L come from a shared copy of L^T that the factor loop fills as it goes
// (64 KB in float32, 128 KB in float64): the inverse is built in place of
// the factor's registers, and only one 128x128 tile sits in shared memory,
// since two float64 tiles (256 KB) exceed the 227 KB a block can have.
//
// Bound on an H100 SXM (3.35 TB/s, 67 / 34 TFLOP/s float32 / float64
// outside the tensor cores): at C = 8 float32 a launch moves 2 * 8 * 64 KB
// = 1 MB (0.31 us) and does 8 * 128^3 / 6 multiply-adds (0.08 us). With at
// most 64 blocks on 132 SMs and 128 dependent steps per block, each a
// barrier and a few shared-memory round trips, it is latency-bound far
// above both; the time per launch is roughly 128 steps of one block. A
// later design would factor 8- or 16-wide panels per barrier and put the
// trailing update on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 128;                  // block edge
constexpr int kTX = 32;                  // threads along a row (a warp)
constexpr int kTY = 16;                  // warps
constexpr int kRows = kN / kTY;          // rows held by a thread (8)
constexpr int kCols = kN / kTX;          // columns held by a thread (4)
constexpr int kThreads = kTX * kTY;      // 512

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
block_chol_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ li) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* colbuf = reinterpret_cast<T*>(smem_raw);  // [2][kN]: the column (or row) in flight
  T* lt = colbuf + 2 * kN;                      // [kN][kN]: L^T, inverse entry only

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
    if (kInverse && tx == 0) {  // column k of L, kept as row k of L^T
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
  if (!kInverse) return;

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

template <typename T, bool kInverse>
int launch(const T* a, T* l, T* li, int c, void* stream) {
  const size_t smem = (2 * kN + (kInverse ? kN * kN : 0)) * sizeof(T);
  auto kernel = block_chol_kernel<T, kInverse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c, dim3(kTX, kTY), smem, static_cast<cudaStream_t>(stream)>>>(a, l, li);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Each call enqueues one launch of C blocks
// on `stream` and returns the CUDA error code (0 when the launch was
// accepted).
extern "C" {

int block_chol_f32(const float* a, float* l, int c, void* stream) {
  return launch<float, false>(a, l, nullptr, c, stream);
}

int block_chol_f64(const double* a, double* l, int c, void* stream) {
  return launch<double, false>(a, l, nullptr, c, stream);
}

int block_chol_inv_f32(const float* a, float* l, float* li, int c, void* stream) {
  return launch<float, true>(a, l, li, c, stream);
}

int block_chol_inv_f64(const double* a, double* l, double* li, int c, void* stream) {
  return launch<double, true>(a, l, li, c, stream);
}

const char* block_chol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
