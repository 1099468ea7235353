// Kernel FE: one rank's Q1 assembly on the -dist route, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package assembles with XLA einsums
// (saddle_point_petsc_tpu/parallel/dist.py, assemble_poisson_dist and
// assemble_constraints_dist). Its plain version, _accumulators_plain in
// parallel/dist.py, batches the element integrals of models/fem.py over
// the elements as tiny matrix products (2x4 @ 4x2, (8x12) @ (12x8),
// 4x4 @ 4x2 over 5M elements at 2241^2), which cuBLAS runs in 64x32 tiles,
// and then sums them onto the nodes. This kernel computes the same padded
// accumulators of the rank's patch in one pass:
//
//   planes (4, 3, 3, my+2, mx+2): planes[2c+d, bj-aj+1, bi-ai+1, node(a)]
//       += Ke[2a+c, 2b+d] of every element, Ke the vector-Laplace stiffness
//       sum_p B_p^T diag(2, 2, 1) detJ_p B_p of fem.element_stiffness;
//   load (2, my+2, mx+2): += Fe[2a+c] = sum_p N_a detJ_p f_c(x_p), the
//       named body force ("constant" (1, 2), "trig" (sin(pi x) cos(pi y), 2));
//   rows (4, 2, my+2, mx+2): the four default constraint functionals of
//       models/saddle.py, (1, 0), (0, 1), (x, 0), (0, y), integrated as Fe;
//
// where node(a) is corner a of the element whose lower-left node is (j, i),
// at padded position (1 + j + aj, 1 + i + ai). The rank owns the elements
// whose lower-left node it owns, ej x ei of them (ej <= my, ei <= mx; fewer
// at the grid's far edge, none on a patch of padding), with node
// coordinates xs (ei + 1 values) and ys (ej + 1) sliced from the same
// linspace as the serial assembly. Entries no element touches are 0, as in
// the plain accumulators; a null output is skipped.
//
// Arithmetic: the 2x2 Gauss rule with the same literal as models/fem.py,
// the same shape functions, Jacobian and determinant; the inverse Jacobian
// as one reciprocal of det times the adjugate (the plain version divides
// each entry). Each element matrix is summed over its Gauss points first,
// then onto the node, element by element in corner order a = 0..3 (the
// order in which the plain version's loop adds them). So the result agrees
// with the plain version to rounding, not bit for bit.
//
// What bounds it: bytes written. It reads 2 (ei + ej + 2) coordinates and
// writes 46 values a padded node (36 plane entries, 2 loads, 8 row entries):
// 1.85 GB at 2241^2 in f64, 0.55 ms at 3.35 TB/s. It recomputes each
// element for each of its 4 corners, about 2.4 kFLOP a node (12 GFLOP at
// 2241^2, ~0.35 ms at 34 TFLOP/s in f64): under the store bound, but not by
// much.
//
// What the design does about it: a gather, one thread per padded node, with
// i on threadIdx.x. The thread forms in registers the rows of node a of the
// <= 4 elements that touch it and stores each output once: every store of a
// warp is one coalesced run of 32 consecutive values, there are no atomics
// (the result is the same every run) and no element-matrix or coordinate
// tensor ever reaches device memory. Sharing an element's geometry between
// its four corners through shared memory is the next step if the flops
// ever show.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
// 1/sqrt(3) to 11 digits, the literal of models/fem.py
constexpr double kGP = 0.57735026919;
// math.pi
constexpr double kPi = 3.141592653589793;

enum Force { kNone = 0, kConstant = 1, kTrig = 2 };

// Corner a of an element, CCW from the lower left (models/fem.py):
// (row, column) offsets (0,0), (1,0), (1,1), (0,1). The Gauss points follow
// the same pattern: point p sits at (xi, eta) = (sx(p) g, sy(p) g).
__host__ __device__ constexpr int corner_j(int a) { return (a == 1 || a == 2) ? 1 : 0; }
__host__ __device__ constexpr int corner_i(int a) { return a >> 1; }

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
q1_assembly_kernel(const T* __restrict__ xs, const T* __restrict__ ys,
                   int ej, int ei, int my, int mx, int force,
                   T* __restrict__ planes, T* __restrict__ load,
                   T* __restrict__ rows) {
  const int pi = blockIdx.x * kBlockX + threadIdx.x;  // padded column
  const int pj = blockIdx.y * kBlockY + threadIdx.y;  // padded row
  if (pi >= mx + 2 || pj >= my + 2) return;
  const int nj = pj - 1;  // the rank's node (nj, ni); -1 = the low ghost
  const int ni = pi - 1;

  const T g = T(kGP);
  // acc[2c+d][dj][di], fe[c], be[r][c]: the node's sums over its elements
  T acc[4][3][3];
  T fe[2];
  T be[4];  // the nonzero row entries: (0, c=0), (1, c=1), (2, c=0), (3, c=1)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
      for (int di = 0; di < 3; ++di) acc[k][dj][di] = T(0);
    }
    be[k] = T(0);
  }
  fe[0] = T(0);
  fe[1] = T(0);

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int aj = corner_j(a);
    const int ai = corner_i(a);
    const int ej_ = nj - aj;  // the element of which this node is corner a
    const int ei_ = ni - ai;
    if (ej_ < 0 || ej_ >= ej || ei_ < 0 || ei_ >= ei) continue;
    const T x0 = xs[ei_], x1 = xs[ei_ + 1];
    const T y0 = ys[ej_], y1 = ys[ej_ + 1];

    // the element's sums over its Gauss points: node a's rows of Ke
    // (ke[b][2c+d]), of Fe and of the constraint rows
    T ke[4][4];
    T fa[2] = {T(0), T(0)};
    T ba[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ke[b][k] = T(0);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const T xi = corner_i(p) ? g : -g;
      const T eta = corner_j(p) ? g : -g;
      T n[4], gx[4], ge[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // models/fem.py: shape_q1 and grad_shape_q1, corner i's signs
        const T sx = corner_i(i) ? T(1) : T(-1);
        const T sy = corner_j(i) ? T(1) : T(-1);
        n[i] = T(0.25) * (T(1) + sx * xi) * (T(1) + sy * eta);
        gx[i] = sx * (T(0.25) * (T(1) + sy * eta));
        ge[i] = sy * (T(0.25) * (T(1) + sx * xi));
      }
      // Jacobian jac[c][d] = sum_i gni[c][i] coords[i][d]
      T j00 = T(0), j01 = T(0), j10 = T(0), j11 = T(0), xp = T(0), yp = T(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T X = corner_i(i) ? x1 : x0;
        const T Y = corner_j(i) ? y1 : y0;
        j00 = j00 + gx[i] * X;
        j01 = j01 + gx[i] * Y;
        j10 = j10 + ge[i] * X;
        j11 = j11 + ge[i] * Y;
        xp = xp + n[i] * X;
        yp = yp + n[i] * Y;
      }
      const T det = j00 * j11 - j01 * j10;
      const T r = T(1) / det;
      const T i00 = j11 * r, i01 = -j01 * r, i10 = -j10 * r, i11 = j00 * r;
      T dx[4], dy[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dx[i] = i00 * gx[i] + i01 * ge[i];
        dy[i] = i10 * gx[i] + i11 * ge[i];
      }
      // B^T diag(2, 2, 1) detJ B, strain rows (dx, 0), (0, dy), (dy, dx)
      const T d2 = T(2) * det;
      const T ax2 = dx[a] * d2, ay2 = dy[a] * d2, ax1 = dx[a] * det, ay1 = dy[a] * det;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ke[b][0] = ke[b][0] + ax2 * dx[b] + ay1 * dy[b];
        ke[b][1] = ke[b][1] + ay1 * dx[b];
        ke[b][2] = ke[b][2] + ax1 * dy[b];
        ke[b][3] = ke[b][3] + ay2 * dy[b] + ax1 * dx[b];
      }
      if (force != kNone) {
        T f0 = T(1);
        if (force == kTrig) f0 = sin(T(kPi) * xp) * cos(T(kPi) * yp);
        fa[0] = fa[0] + n[a] * (det * f0);
        fa[1] = fa[1] + n[a] * (det * T(2));
      }
      ba[0] = ba[0] + n[a] * det;
      ba[1] = ba[1] + n[a] * det;
      ba[2] = ba[2] + n[a] * (det * xp);
      ba[3] = ba[3] + n[a] * (det * yp);
    }

#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int dj = corner_j(b) - aj + 1;
      const int di = corner_i(b) - ai + 1;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k][dj][di] = acc[k][dj][di] + ke[b][k];
    }
    fe[0] = fe[0] + fa[0];
    fe[1] = fe[1] + fa[1];
#pragma unroll
    for (int k = 0; k < 4; ++k) be[k] = be[k] + ba[k];
  }

  const int64_t plane = (int64_t)(my + 2) * (mx + 2);
  const int64_t node = (int64_t)pj * (mx + 2) + pi;
  if (planes != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
        for (int di = 0; di < 3; ++di) planes[((k * 3 + dj) * 3 + di) * plane + node] = acc[k][dj][di];
      }
    }
  }
  if (load != nullptr) {
    load[node] = fe[0];
    load[plane + node] = fe[1];
  }
  if (rows != nullptr) {
    // rows[r][c]: row r's component c
    rows[0 * plane + node] = be[0];
    rows[1 * plane + node] = T(0);
    rows[2 * plane + node] = T(0);
    rows[3 * plane + node] = be[1];
    rows[4 * plane + node] = be[2];
    rows[5 * plane + node] = T(0);
    rows[6 * plane + node] = T(0);
    rows[7 * plane + node] = be[3];
  }
}

template <typename T>
int launch(const T* xs, const T* ys, int ej, int ei, int my, int mx, int force,
           T* planes, T* load, T* rows, void* stream) {
  if (my < 1 || mx < 1 || ej < 0 || ej > my || ei < 0 || ei > mx) return (int)cudaErrorInvalidValue;
  if (force < kNone || force > kTrig || (load != nullptr && force == kNone)) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((mx + 2 + kBlockX - 1) / kBlockX, (my + 2 + kBlockY - 1) / kBlockY);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  q1_assembly_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(xs, ys, ej, ei, my, mx, force, planes,
                                                                   load, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int q1_assembly_f32(const float* xs, const float* ys, int ej, int ei, int my, int mx,
                               int force, float* planes, float* load, float* rows, void* stream) {
  return launch<float>(xs, ys, ej, ei, my, mx, force, planes, load, rows, stream);
}

extern "C" int q1_assembly_f64(const double* xs, const double* ys, int ej, int ei, int my, int mx,
                               int force, double* planes, double* load, double* rows, void* stream) {
  return launch<double>(xs, ys, ej, ei, my, mx, force, planes, load, rows, stream);
}

extern "C" const char* q1_assembly_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
