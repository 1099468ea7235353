// Kernel B6: the DIA SpMM, Y = A X for k dense columns, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dia_spmm_kernel` in
// saddle_point_petsc_tpu/ops/pallas/spmm.py (entry dia_spmm_pallas). For
// row-indexed bands data (ndiag, n), offsets off_d and X (n, k),
//
//   Y[i, c] = sum_d data[d, i] * X[i + off_d, c],   X taken as 0 outside [0, n),
//
// summed in offset order with each product and each sum rounded one by one
// (no fused multiply-add), as kernel B3 (csrc/dia_spmv.cu) and the plain
// version (dia_spmm_plain, ops/cuda/dia_spmm.py) sum: column c of B6 gives
// the bits of B3 on X[:, c].
//
// X and Y are addressed through a row stride and a column stride, so both
// the (n, k) row-major layout the TPU kernel takes and the transposed view
// of a (k, n) batch (the Krylov solver's layout, column stride n) run
// without a copy.
//
// What bounds it: bytes. Per row it reads ndiag band values once for all k
// columns, about ndiag * k values of X (mostly from cache: neighbouring
// rows share them) and writes k outputs: (ndiag + 2k) * sizeof(T) bytes
// for 2 ndiag k flops, in place of k * (ndiag + 2) for k calls of B3.
//
// What the design does about it: one thread per row i, rows on consecutive
// threads, so every band read is one coalesced run per warp, and, for the
// transposed batch, so is every read of a column of X and every write of a
// column of Y. Each thread loads data[d, i] once per band and applies it to
// up to kCols columns held in registers; a wider batch takes more blocks
// along grid.y, each reading the bands again. The TPU kernel's padded copy
// of X (maxoff rows above and below) is replaced by a bounds check; offsets
// sit in a small int32 device array read by all threads of a warp at the
// same address. Indices are 64-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;  // columns per thread

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const T* __restrict__ data, const T* __restrict__ X,
                T* __restrict__ Y, const int* __restrict__ offsets, int ndiag,
                int64_t n, int k, int64_t xs_row, int64_t xs_col,
                int64_t ys_row, int64_t ys_col) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, k - c0);
  const T* x = X + (int64_t)c0 * xs_col;
  T acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + offsets[d];
    if (j < 0 || j >= n) continue;
    const T a = data[(int64_t)d * n + i];
    const T* xj = x + j * xs_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < kc) acc[c] = add_rn(acc[c], mul_rn(a, xj[c * xs_col]));
    }
  }
  T* y = Y + i * ys_row + (int64_t)c0 * ys_col;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < kc) y[c * ys_col] = acc[c];
  }
}

template <typename T>
int launch(const T* data, const T* X, T* Y, const int* offsets, int ndiag,
           int64_t n, int k, int64_t xs_row, int64_t xs_col, int64_t ys_row,
           int64_t ys_col, void* stream) {
  if (n < 1 || k < 1 || ndiag < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int chunks = (k + kCols - 1) / kCols;
  if (blocks > INT_MAX || chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  dia_spmm_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      data, X, Y, offsets, ndiag, n, k, xs_row, xs_col, ys_row, ys_col);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dia_spmm_f32(const float* data, const float* X, float* Y,
                            const int* offsets, int ndiag, long long n, int k,
                            long long xs_row, long long xs_col,
                            long long ys_row, long long ys_col, void* stream) {
  return launch<float>(data, X, Y, offsets, ndiag, n, k, xs_row, xs_col,
                       ys_row, ys_col, stream);
}

extern "C" int dia_spmm_f64(const double* data, const double* X, double* Y,
                            const int* offsets, int ndiag, long long n, int k,
                            long long xs_row, long long xs_col,
                            long long ys_row, long long ys_col, void* stream) {
  return launch<double>(data, X, Y, offsets, ndiag, n, k, xs_row, xs_col,
                        ys_row, ys_col, stream);
}

extern "C" const char* dia_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
