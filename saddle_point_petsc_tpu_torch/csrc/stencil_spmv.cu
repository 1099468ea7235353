// Kernel B1: the planes-layout stencil SpMV, y = A x, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stencil_kernel` in
// saddle_point_petsc_tpu/ops/pallas/spmv.py (entry points
// stencil_spmv_pallas and stencil_spmv_pallas_padded). It computes what
// that kernel computes,
//
//   y[c, j, i] = sum_{dj, di in 0..2} sum_{d in 0,1}
//                planes[2c+d, dj, di, j, i] * xp[d, j+dj, i+di],
//
// with planes (4, 3, 3, ny, nx), y (2, ny, nx) and xp the field with a
// one-node halo: either given padded, (2, ny+2, nx+2) (the `padded` entry,
// for the halo exchange of the distributed operator), or read from an
// unpadded (2, ny, nx) field with out-of-grid neighbours taken as 0 by a
// bounds check (no padded copy is made). Sums run in the order of the TPU
// kernel and of its plain version, planes_matvec_padded: dj, then di, then d.
//
// What bounds it: bytes. Per node it reads the 36 plane values once, reads
// x about once and writes 2 outputs: about 40 * sizeof(T) bytes for 72
// flops, far below the card's flop/byte balance.
//
// What the design does about it: one thread per output node, with i on
// threadIdx.x, so each of the 36 plane reads of a warp is one coalesced run
// of 32 consecutive values, and both output dofs come from the same thread,
// so each x value a thread loads serves 4 products. The x neighbours come
// from a shared-memory tile of the block's nodes plus a one-node halo, so
// the 9-point reuse of x costs no extra device-memory traffic. The TPU
// kernel's double-buffered DMA windows, sublane-alignment slack and lane
// padding have no counterpart here. Wider loads, TMA and a persistent
// schedule are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTileX = kBlockX + 2;
constexpr int kTileY = kBlockY + 2;

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
stencil_spmv_kernel(const T* __restrict__ planes, const T* __restrict__ x,
                    T* __restrict__ y, int ny, int nx, int padded) {
  __shared__ T tile[2][kTileY][kTileX];

  const int i0 = blockIdx.x * kBlockX;
  const int j0 = blockIdx.y * kBlockY;

  // tile[d][tj][ti] holds halo-padded coordinate (j0 + tj, i0 + ti), that is
  // grid node (j0 + tj - 1, i0 + ti - 1).
  const int64_t xpitch = padded ? (int64_t)nx + 2 : (int64_t)nx;
  const int64_t xplane = padded ? ((int64_t)ny + 2) * xpitch : (int64_t)ny * nx;
  for (int t = threadIdx.y * kBlockX + threadIdx.x; t < kTileY * kTileX;
       t += kBlockX * kBlockY) {
    const int tj = t / kTileX;
    const int ti = t - tj * kTileX;
    int rj = j0 + tj;  // row / column in x's own indexing
    int ri = i0 + ti;
    bool inside;
    if (padded) {
      inside = rj < ny + 2 && ri < nx + 2;
    } else {
      rj -= 1;
      ri -= 1;
      inside = rj >= 0 && rj < ny && ri >= 0 && ri < nx;
    }
    const int64_t off = (int64_t)rj * xpitch + ri;
    tile[0][tj][ti] = inside ? x[off] : T(0);
    tile[1][tj][ti] = inside ? x[xplane + off] : T(0);
  }
  __syncthreads();

  const int i = i0 + threadIdx.x;
  const int j = j0 + threadIdx.y;
  if (i >= nx || j >= ny) return;

  const int64_t stride = (int64_t)ny * nx;  // one (dj, di) plane
  const T* p = planes + (int64_t)j * nx + i;
  T y0 = T(0);
  T y1 = T(0);
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int k = dj * 3 + di;
      const T w0 = tile[0][threadIdx.y + dj][threadIdx.x + di];
      const T w1 = tile[1][threadIdx.y + dj][threadIdx.x + di];
      // plane (c, d) at (dj, di) sits at index (2c + d) * 9 + k
      y0 = y0 + p[(0 * 9 + k) * stride] * w0 + p[(1 * 9 + k) * stride] * w1;
      y1 = y1 + p[(2 * 9 + k) * stride] * w0 + p[(3 * 9 + k) * stride] * w1;
    }
  }
  const int64_t node = (int64_t)j * nx + i;
  y[node] = y0;
  y[stride + node] = y1;
}

template <typename T>
int launch(const T* planes, const T* x, T* y, int ny, int nx, int padded,
           void* stream) {
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  stencil_spmv_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      planes, x, y, ny, nx, padded);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil_spmv_f32(const float* planes, const float* x, float* y,
                                int ny, int nx, int padded, void* stream) {
  return launch<float>(planes, x, y, ny, nx, padded, stream);
}

extern "C" int stencil_spmv_f64(const double* planes, const double* x,
                                double* y, int ny, int nx, int padded,
                                void* stream) {
  return launch<double>(planes, x, y, ny, nx, padded, stream);
}

extern "C" const char* stencil_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
