// Kernel B2: the planes-layout stencil SpMM, Y[k] = A X[k] for a batch of
// fields, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stencil_spmm_kernel` in
// saddle_point_petsc_tpu/ops/pallas/spmm.py (entry stencil_spmm_pallas). For
// planes (4, 3, 3, ny, nx) and a batch X (nk, 2, ny, nx) it computes, for
// every field k,
//
//   Y[k, c, j, i] = sum_{dj, di in 0..2} sum_{d in 0,1}
//                   planes[2c+d, dj, di, j, i] * X[k, d, j+dj-1, i+di-1],
//
// with out-of-grid neighbours taken as 0 by a bounds check (no padded copy
// of the batch is made; the TPU kernel pads it). Each output is summed in
// the order and with the expression of kernel B1 (csrc/stencil_spmv.cu) and
// of the plain version, planes_matvec_padded: dj, then di, then d. So field
// k of B2 is meant to give B1's bits on X[k].
//
// What bounds it: bytes. A loop of B1 reads the 36 plane values of a node
// once per field; B2 reads them once for the whole batch. Per node it moves
// 36 plane values plus 4 * nk field values (X in, Y out), about
// (36 + 4 nk) * sizeof(T) bytes for 72 nk flops: at nk = 8 and 1025^2 nodes
// in f32, 285 MB in place of a B1 loop's 1.48 GB.
//
// What the design does about it: one thread per node, i on threadIdx.x, so
// every plane read of a warp is one coalesced run. Each thread loads its
// node's 36 coefficients into registers once, then walks the fields: the
// block stages field k with a one-node halo in a shared tile, syncs, and
// every thread makes its 36 products from registers and the tile and writes
// both dofs of Y[k]. The TPU kernel's VMEM-resident whole-field block (which
// limits it to about 786k padded nodes) has no counterpart here: the tile is
// the block's nodes plus a halo, at any grid size. Double-buffering the
// tile with cp.async, TMA and a persistent schedule are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTileX = kBlockX + 2;
constexpr int kTileY = kBlockY + 2;

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
stencil_spmm_kernel(const T* __restrict__ planes, const T* __restrict__ X,
                    T* __restrict__ Y, int nk, int ny, int nx) {
  __shared__ T tile[2][kTileY][kTileX];

  const int i0 = blockIdx.x * kBlockX;
  const int j0 = blockIdx.y * kBlockY;
  const int i = i0 + threadIdx.x;
  const int j = j0 + threadIdx.y;
  const bool live = i < nx && j < ny;
  const int64_t stride = (int64_t)ny * nx;  // one (dj, di) plane, one dof of a field
  const int64_t node = (int64_t)j * nx + i;

  // the node's 36 coefficients, loaded once for the whole batch; plane
  // (c, d) at (dj, di) sits at index (2c + d) * 9 + dj * 3 + di
  T p[36];
  if (live) {
#pragma unroll
    for (int q = 0; q < 36; ++q) p[q] = planes[q * stride + node];
  }

  for (int k = 0; k < nk; ++k) {
    const T* x = X + (int64_t)k * 2 * stride;
    // tile[d][tj][ti] holds grid node (j0 + tj - 1, i0 + ti - 1) of field k
    for (int t = threadIdx.y * kBlockX + threadIdx.x; t < kTileY * kTileX;
         t += kBlockX * kBlockY) {
      const int tj = t / kTileX;
      const int ti = t - tj * kTileX;
      const int rj = j0 + tj - 1;
      const int ri = i0 + ti - 1;
      const bool inside = rj >= 0 && rj < ny && ri >= 0 && ri < nx;
      const int64_t off = (int64_t)rj * nx + ri;
      tile[0][tj][ti] = inside ? x[off] : T(0);
      tile[1][tj][ti] = inside ? x[stride + off] : T(0);
    }
    __syncthreads();

    if (live) {
      T y0 = T(0);
      T y1 = T(0);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int q = dj * 3 + di;
          const T w0 = tile[0][threadIdx.y + dj][threadIdx.x + di];
          const T w1 = tile[1][threadIdx.y + dj][threadIdx.x + di];
          y0 = y0 + p[0 * 9 + q] * w0 + p[1 * 9 + q] * w1;
          y1 = y1 + p[2 * 9 + q] * w0 + p[3 * 9 + q] * w1;
        }
      }
      T* y = Y + (int64_t)k * 2 * stride;
      y[node] = y0;
      y[stride + node] = y1;
    }
    __syncthreads();  // the tile is rewritten for the next field
  }
}

template <typename T>
int launch(const T* planes, const T* X, T* Y, int nk, int ny, int nx,
           void* stream) {
  if (nk < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  stencil_spmm_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      planes, X, Y, nk, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil_spmm_f32(const float* planes, const float* X, float* Y,
                                int nk, int ny, int nx, void* stream) {
  return launch<float>(planes, X, Y, nk, ny, nx, stream);
}

extern "C" int stencil_spmm_f64(const double* planes, const double* X,
                                double* Y, int nk, int ny, int nx,
                                void* stream) {
  return launch<double>(planes, X, Y, nk, ny, nx, stream);
}

extern "C" const char* stencil_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
