// Kernel B5: the ELL SpMV, y = A x, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ell_kernel` in
// saddle_point_petsc_tpu/ops/pallas/spmv.py (entry ell_spmv_pallas). For the
// transposed ELL arrays cols_t (K, m) int32 and vals_t (K, m), slot-major as
// the TPU kernel takes them (ell_transpose), it computes
//
//   y[i] = sum_{s = 0..K-1, cols_t[s, i] >= 0} vals_t[s, i] * x[cols_t[s, i]],
//
// summed in slot order. A padding slot (cols_t < 0) contributes nothing and
// x is never read at a negative index. Products and sums are rounded one by
// one (no fused multiply-add), so the kernel gives the bits of its plain
// version, ell_spmv_plain (ops/cuda/ell.py), a sequential loop over slots.
//
// What bounds it: bytes and the gather. Per row it reads K column indices
// (4 bytes each), K values and K gathered x values, and writes one y: about
// K * (4 + 2 * sizeof(T)) bytes for 2K flops. The gathered x reads are the
// irregular part; on the gamg levels they hit L2 mostly, since neighbouring
// rows couple to neighbouring columns.
//
// What the design does about it: one thread per row, rows on consecutive
// threads, so each slot's index and value reads of a warp are one coalesced
// run of the slot-major arrays: the layout the TPU kernel wanted for its
// lane-parallel gather suits this card's warps as well. The TPU kernel's
// broadcast of x across the K slots (Mosaic's gather needs index shape ==
// operand shape, and lowers only within one vector register) has no
// counterpart: Hopper gathers from device memory natively. Indices into the
// (K, m) arrays are 64-bit: s * m + i passes 2^31 at large K * m.

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
ell_spmv_kernel(const int* __restrict__ cols_t, const T* __restrict__ vals_t,
                const T* __restrict__ x, T* __restrict__ y, int nslots,
                int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  T acc = T(0);
  for (int s = 0; s < nslots; ++s) {
    const int64_t e = (int64_t)s * m + i;
    const int c = cols_t[e];
    if (c >= 0) acc = add_rn(acc, mul_rn(vals_t[e], x[c]));
  }
  y[i] = acc;
}

template <typename T>
int launch(const int* cols_t, const T* vals_t, const T* x, T* y, int nslots,
           int64_t m, void* stream) {
  if (m < 1 || nslots < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  ell_spmv_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cols_t, vals_t, x, y, nslots, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_spmv_f32(const int* cols_t, const float* vals_t,
                            const float* x, float* y, int nslots, long long m,
                            void* stream) {
  return launch<float>(cols_t, vals_t, x, y, nslots, m, stream);
}

extern "C" int ell_spmv_f64(const int* cols_t, const double* vals_t,
                            const double* x, double* y, int nslots,
                            long long m, void* stream) {
  return launch<double>(cols_t, vals_t, x, y, nslots, m, stream);
}

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
