// Kernel B4: the block-DIA SpMV on a dof-major vector, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bdia2d_kernel` in
// saddle_point_petsc_tpu/ops/pallas/spmv.py (entry bdia_spmv_pallas_2d).
// For block bands data (ndiag, b, b, mb), block offsets off_k and the
// active (k, c, d) triples (the bands that hold nonzeros),
//
//   y[c, i] = sum over active (k, c, d) of data[k, c, d, i] * xb[d, i + off_k],
//
// with xb (b, mb) taken as 0 outside [0, mb). Each y[c, i] sums its
// triples in the order of `active`, as the plain version (the XLA chain of
// saddle_point_petsc_tpu/ops/sparse.py bdia_matvec_dofmajor) does, not in
// the TPU kernel's order grouped by lane remainder. Products and sums are
// rounded one by one (no fused multiply-add), so the kernel gives the plain
// version's bits.
//
// What bounds it: bytes. Per block row it reads one value per active
// triple, b x values per offset (mostly from cache) and writes b outputs.
//
// What the design does about it: one thread per output (c, i), with i on
// consecutive threads (coalesced band and shifted x reads) and c on
// blockIdx.y. The triples come from a small int32 table built once per
// operator by the wrapper, grouped by c in `active` order:
//   starts[b + 1] | off[t] | plane[t] = (k * b + c) * b + d | dof[t] = d.
// A thread walks only its own c's triples, so any block size b works with
// no register array sized at compile time. The TPU kernel's (R, 128) lane
// views, shared rolled windows, double-buffered DMA and its collapse to
// one block on ragged sizes have no counterpart here. Indices are 64-bit.

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
bdia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ xb,
                 T* __restrict__ y, const int* __restrict__ table, int b,
                 int ntrip, int64_t mb) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (i >= mb) return;
  const int* starts = table;
  const int* off = table + b + 1;
  const int* plane = off + ntrip;
  const int* dof = plane + ntrip;
  T acc = T(0);
  for (int t = starts[c]; t < starts[c + 1]; ++t) {
    const int64_t j = i + off[t];
    if (j >= 0 && j < mb) {
      acc = add_rn(acc, mul_rn(data[(int64_t)plane[t] * mb + i],
                               xb[(int64_t)dof[t] * mb + j]));
    }
  }
  y[(int64_t)c * mb + i] = acc;
}

template <typename T>
int launch(const T* data, const T* xb, T* y, const int* table, int b,
           int ntrip, int64_t mb, void* stream) {
  if (mb < 1 || b < 1 || ntrip < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (mb + kThreads - 1) / kThreads;
  if (blocks > INT_MAX || b > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)b);
  bdia_spmv_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      data, xb, y, table, b, ntrip, mb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bdia_spmv_f32(const float* data, const float* xb, float* y,
                             const int* table, int b, int ntrip, long long mb,
                             void* stream) {
  return launch<float>(data, xb, y, table, b, ntrip, mb, stream);
}

extern "C" int bdia_spmv_f64(const double* data, const double* xb, double* y,
                             const int* table, int b, int ntrip, long long mb,
                             void* stream) {
  return launch<double>(data, xb, y, table, b, ntrip, mb, stream);
}

extern "C" const char* bdia_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
