// Kernels B3 and B3': the DIA SpMV, y = A x, for Hopper (sm_90a).
//
// Replaces two TPU kernels of saddle_point_petsc_tpu/ops/pallas/spmv.py
// that compute the same thing: `_dia2d_kernel` (entry dia_spmv_pallas_2d,
// the production kernel of DIA operators and gamg levels) and its 1D
// predecessor `_dia_kernel` (entry dia_spmv_pallas). For row-indexed bands
// data (ndiag, n) and offsets off_k,
//
//   y[i] = sum_k data[k, i] * x[i + off_k],   x taken as 0 outside [0, n),
//
// summed in offset order, as the plain version (the XLA chain of
// saddle_point_petsc_tpu/ops/sparse.py dia_matvec) sums. Products and sums
// are rounded one by one (no fused multiply-add), so the kernel gives the
// plain version's bits.
//
// What bounds it: bytes. Per row it reads ndiag band values, ndiag x
// values (mostly from cache: neighbouring rows share them) and writes one
// y: about (ndiag + 2) * sizeof(T) bytes for 2 * ndiag flops.
//
// What the design does about it: one thread per row, rows on consecutive
// threads, so each band read of a warp is one coalesced run and each
// shifted x read is a coalesced run at an offset. The offsets (up to the
// 512 gamg allows, any count is taken) sit in a small device array that
// every thread of a warp reads at the same address. The zero boundary is a
// bounds check, not a padded copy of x. The TPU kernel's (R, 128) lane
// view, lane rotates, double-buffered DMA windows and its collapse to one
// block on ragged sizes have no counterpart here. Indices are 64-bit:
// k * n + i passes 2^31 for 512 bands at 4.2M rows.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, const int* __restrict__ offsets, int ndiag,
                int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int k = 0; k < ndiag; ++k) {
    const int64_t j = i + offsets[k];
    if (j >= 0 && j < n) acc = add_rn(acc, mul_rn(data[(int64_t)k * n + i], x[j]));
  }
  y[i] = acc;
}

template <typename T>
int launch(const T* data, const T* x, T* y, const int* offsets, int ndiag,
           int64_t n, void* stream) {
  if (n < 1 || ndiag < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  dia_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, x, y, offsets, ndiag, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dia_spmv_f32(const float* data, const float* x, float* y,
                            const int* offsets, int ndiag, long long n,
                            void* stream) {
  return launch<float>(data, x, y, offsets, ndiag, n, stream);
}

extern "C" int dia_spmv_f64(const double* data, const double* x, double* y,
                            const int* offsets, int ndiag, long long n,
                            void* stream) {
  return launch<double>(data, x, y, offsets, ndiag, n, stream);
}

extern "C" const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
