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
// the bits of B3 on X[:, c]. Terms with i + off_d outside [0, n) are
// skipped by predicate, never multiplied, so a non-finite value in a
// padding entry of `data` changes nothing.
//
// What bounds it: bytes. Device memory must see each band value once, each
// X value once and each Y value once: (ndiag + 2k) * n * sizeof(T), 311 MB
// in f32 for the 1025^2-node operator (21 bands, n = 2,101,250) at k = 8,
// 92.8 us at 3.35 TB/s. A thread per row that reads X[i + off_d, c] for
// every band asks L1/L2 for ndiag * k values of X a row, 21x what memory
// must supply, and on a row-major X each warp-wide load of one column
// touches 32 sectors for 128 useful bytes.
//
// Three paths, one sum; the wrapper (ops/cuda/dia_spmm.py) picks one at
// launch from the dtype, the strides and the offsets' plan, by what
// measured fastest on the card (PERF.md):
//
// - Blocked (dia_spmm_blocked): column-contiguous X and Y (the Krylov
//   solver's transposed (k, n) batch) and offsets that form at most
//   kMaxRuns runs of consecutive offsets (lo, lo + 1, ..., at most
//   kMaxBands a run; dia_spmm.plan_runs), passed by value in the kernel's
//   parameters. On the natural-order 1025^2 operator the 21 offsets form
//   three runs of seven. A thread sums R consecutive rows (4 in f32, 2 in
//   f64) of up to kCols columns; for each run and column it loads the
//   R + count - 1 values of X its rows meet once into registers, with
//   aligned 8-byte (f32) or 16-byte (f64) loads, and applies the run's
//   bands from there: 3 loads of X a row and run in f32 (R = 4) where a
//   thread per row needs 7, each a whole aligned piece where the thread
//   per row's cross a cache line. Band values and Y move R rows at a
//   time. The wrapper takes it for f32; in f64 (R = 2: 5 loads a row and
//   run) it measured no faster than the strided path.
// - Rows (dia_spmm_rows): row-major X and Y whose rows are 16-byte-aligned
//   runs of kCols values. A thread holds 32 bytes of row i (all kCols
//   columns in f32, half of them in f64) and moves them with 16-byte loads
//   and stores, so a warp touches whole sectors.
// - Strided (dia_spmm_strided), any strides and offsets: one thread per
//   row holds kCols columns of Y[i] in registers and reads X[i + off_d, c]
//   column by column, from L1 for neighbouring offsets. For the transposed
//   (k, n) batch each such read is one coalesced run of rows per warp.
// Staging X in shared memory instead, one window per run copied with
// cp.async into a ring of buffers, measured slower than all three on an
// H100 (CHANGES.md, the B6 redesign): its copy pipeline alone took longer
// than the strided path's whole sum. Y is written with the
// streaming hint (__stcs), and the strided and rows paths read band values
// with it (__ldcs): neither is read again, so L1 keeps X. The strided and
// rows paths take their offsets from a small int32 device array read by
// all threads of a warp at the same address. Indices are 64-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

constexpr int kMaxBands = 8;  // bands in one run of the blocked path
constexpr int kMaxRuns = 16;  // runs in one plan of the blocked path

// The blocked path's runs (the ctypes _Plan of ops/cuda/dia_spmm.py): run r
// holds the bands of offsets lo, lo + 1, ..., lo + count - 1, in that order.
struct Plan {
  int nruns;
  int run[kMaxRuns][3];            // lo, first band, band count
  int band[kMaxRuns * kMaxBands];  // row of data of each band
};

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 8;       // columns per block (more columns: more blocks along grid.y)

// the rows path: columns one thread holds (32 bytes), bands loaded together
template <typename T> struct Rows;
template <> struct Rows<float> { static constexpr int cols = 8, group = 2; };
template <> struct Rows<double> { static constexpr int cols = 4, group = 1; };

// the blocked path: R consecutive rows per thread (16 bytes); X loaded V
// aligned values (8 or 16 bytes) at a time, NV values a thread per column
// and run
template <typename T> struct Blk;
template <> struct Blk<float> { static constexpr int R = 4, V = 2, NV = 12; };
template <> struct Blk<double> { static constexpr int R = 2, V = 2, NV = 10; };

template <typename T>
constexpr bool blk_fits() {
  using B = Blk<T>;
  return B::NV >= B::V - 1 + B::R + kMaxBands - 1 && B::NV % B::V == 0 &&
         (B::V * sizeof(T) == 8 || B::V * sizeof(T) == 16) && B::R * sizeof(T) == 16 &&
         kMaxBands * B::R <= 32;
}
static_assert(blk_fits<float>() && blk_fits<double>(), "blocked path shapes");

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

struct Args {
  int64_t n;
  int k;
  int64_t xs_row, xs_col, ys_row, ys_col;
};

template <typename T, int C>
__device__ __forceinline__ void load16(T (&v)[C], const T* p) {
#pragma unroll
  for (int h = 0; h < (int)(C * sizeof(T) / 16); ++h) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p) + h);
    memcpy(&v[h * 16 / sizeof(T)], &w, 16);
  }
}

// ---- the blocked path ----------------------------------------------------------

// R band values of consecutive rows at p into v: 16-byte, 8-byte or
// 4-byte loads as p's alignment allows (the same for every lane: p moves
// by R values, 16 bytes, from lane to lane).
template <typename T, int R>
__device__ __forceinline__ void load_rows(T (&v)[R], const T* p) {
  if ((uintptr_t)p % 16 == 0) {
    load16(v, p);
  } else if (sizeof(T) == 4 && (uintptr_t)p % 8 == 0) {
#pragma unroll
    for (int h = 0; h < R; h += 2) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(p + h));
      memcpy(&v[h], &w, 8);
    }
  } else {
#pragma unroll
    for (int h = 0; h < R; ++h) v[h] = __ldg(p + h);
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_rows(T* p, const T (&v)[R]) {
  if ((uintptr_t)p % 16 == 0) {
    int4 w;
    memcpy(&w, v, 16);
    __stcs(reinterpret_cast<int4*>(p), w);
  } else {
#pragma unroll
    for (int h = 0; h < R; ++h) __stcs(p + h, v[h]);
  }
}

// A run's window of one column of X for this thread's rows: NV values from
// x0 - S, x0 = &X[i + lo, c], in V-element loads (x0 - S is aligned to
// them); an edge stage loads only the rows inside [0, n), one by one.
template <typename T, int S, bool Edge>
__device__ __forceinline__ void blocked_apply(T (&acc)[Blk<T>::R], const T* x0, int64_t j0,
                                              const T (&av)[kMaxBands][Blk<T>::R], int cnt,
                                              uint32_t live, int64_t n) {
  constexpr int R = Blk<T>::R, NV = Blk<T>::NV, V = Blk<T>::V;
  T v[NV];
  if (Edge) {
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int64_t j = j0 - S + m;
      v[m] = j >= 0 && j < n ? x0[m - S] : T(0);
    }
  } else {
#pragma unroll
    for (int m = 0; m < NV; m += V) {
      if constexpr (V * sizeof(T) == 8) {
        const float2 w = *reinterpret_cast<const float2*>(x0 - S + m);
        memcpy(&v[m], &w, 8);
      } else {
        const int4 w = *reinterpret_cast<const int4*>(x0 - S + m);
        memcpy(&v[m], &w, 16);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxBands; ++e) {
    if (e >= cnt) break;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (!Edge || ((live >> (e * R + r)) & 1u)) acc[r] = add_rn(acc[r], mul_rn(av[e][r], v[S + r + e]));
  }
}

// blocked_apply with S = sh, the shift of x0 from its aligned load
template <typename T, bool Edge, int S = 0>
__device__ __forceinline__ void blocked_column(int sh, T (&acc)[Blk<T>::R], const T* x0, int64_t j0,
                                               const T (&av)[kMaxBands][Blk<T>::R], int cnt,
                                               uint32_t live, int64_t n) {
  if constexpr (S + 1 < Blk<T>::V) {
    if (sh != S) {
      blocked_column<T, Edge, S + 1>(sh, acc, x0, j0, av, cnt, live, n);
      return;
    }
  }
  blocked_apply<T, S, Edge>(acc, x0, j0, av, cnt, live, n);
}

// Column-contiguous X and Y (the (k, n) batch): thread t of a block sums R
// consecutive rows i = i0 + R t ... for up to kCols columns, a run of
// consecutive offsets at a time. For each run and column it loads the NV
// values of X its rows need (R + count - 1 of them, rounded out to aligned
// 8- or 16-byte loads) once into registers and applies every band of the
// run from there: about (R + 7) / (7 R) of the strided path's loads of X,
// all of them aligned. The plan travels by value in the kernel's
// parameters.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmm_blocked(const T* __restrict__ data, const T* __restrict__ X, T* __restrict__ Y,
                 const __grid_constant__ Plan p, const Args g) {
  constexpr int R = Blk<T>::R, NV = Blk<T>::NV, TILE = kThreads * R;
  const int64_t i0 = (int64_t)blockIdx.x * TILE;
  const int64_t i = i0 + R * threadIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, g.k - c0);
  const T* x = X + (int64_t)c0 * g.xs_col;
  T acc[kCols][R];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int h = 0; h < R; ++h) acc[c][h] = T(0);
  for (int r = 0; r < p.nruns; ++r) {
    const int lo = p.run[r][0], first = p.run[r][1], cnt = p.run[r][2];
    // an edge stage reaches outside [0, n): rows past n, or X rows (of the
    // NV a thread loads) outside it
    const bool edge = i0 + lo - (Blk<T>::V - 1) < 0 || i0 + TILE > g.n || i0 + TILE - R + lo + NV > g.n;
    uint32_t live = 0;
    T av[kMaxBands][R];
#pragma unroll
    for (int e = 0; e < kMaxBands; ++e) {
      if (e >= cnt) break;
      const T* band = data + (int64_t)p.band[first + e] * g.n + i;
      if (edge) {
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int64_t j = i + h + lo + e;
          const bool ok = i + h < g.n && j >= 0 && j < g.n;
          av[e][h] = ok ? band[h] : T(0);
          live |= (uint32_t)ok << (e * R + h);
        }
      } else {
        load_rows(av[e], band);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= kc) break;
      const int64_t j0 = i + lo;
      const T* x0 = x + c * g.xs_col + j0;
      const int sh = (int)(((uintptr_t)x0 / sizeof(T)) % Blk<T>::V);
      if (edge) blocked_column<T, true>(sh, acc[c], x0, j0, av, cnt, live, g.n);
      else blocked_column<T, false>(sh, acc[c], x0, j0, av, cnt, live, g.n);
    }
  }
  T* y = Y + (int64_t)c0 * g.ys_col + i;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c >= kc) break;
    if (i + R <= g.n) {
      store_rows(y + c * g.ys_col, acc[c]);
    } else {
#pragma unroll
      for (int h = 0; h < R; ++h)
        if (i + h < g.n) __stcs(y + c * g.ys_col + h, acc[c][h]);
    }
  }
}

// ---- the strided path ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmm_strided(const T* __restrict__ data, const T* __restrict__ X, T* __restrict__ Y,
                 const int* __restrict__ offsets, int ndiag, const Args g) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, g.k - c0);
  const T* x = X + (int64_t)c0 * g.xs_col;
  T acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + offsets[d];
    if (j < 0 || j >= g.n) continue;
    const T a = __ldcs(data + (int64_t)d * g.n + i);
    const T* xj = x + j * g.xs_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < kc) acc[c] = add_rn(acc[c], mul_rn(a, xj[c * g.xs_col]));
    }
  }
  T* y = Y + i * g.ys_row + (int64_t)c0 * g.ys_col;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < kc) __stcs(y + c * g.ys_col, acc[c]);
  }
}

// ---- the rows path ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmm_rows(const T* __restrict__ data, const T* __restrict__ X, T* __restrict__ Y,
              const int* __restrict__ offsets, int ndiag, const Args g) {
  constexpr int C = Rows<T>::cols, G = Rows<T>::group, kPerRow = kCols / C;
  const int64_t i = (int64_t)blockIdx.x * (kThreads / kPerRow) + threadIdx.x / kPerRow;
  if (i >= g.n) return;
  const int c0 = blockIdx.y * kCols + (int)(threadIdx.x % kPerRow) * C;
  T acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = T(0);
  for (int d0 = 0; d0 < ndiag; d0 += G) {
    T a[G], xv[G][C];
    bool live[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int d = d0 + e;
      const int64_t j = i + (d < ndiag ? offsets[d] : 0);
      live[e] = d < ndiag && j >= 0 && j < g.n;
      if (live[e]) {
        a[e] = __ldcs(data + (int64_t)d * g.n + i);
        load16(xv[e], X + j * g.xs_row + c0);
      }
    }
#pragma unroll
    for (int e = 0; e < G; ++e) {
      if (!live[e]) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = add_rn(acc[c], mul_rn(a[e], xv[e][c]));
    }
  }
  int4* y = reinterpret_cast<int4*>(Y + i * g.ys_row + c0);
#pragma unroll
  for (int h = 0; h < (int)(C * sizeof(T) / 16); ++h) {
    int4 w;
    memcpy(&w, &acc[h * 16 / sizeof(T)], 16);
    __stcs(y + h, w);
  }
}

// ---- launches ----------------------------------------------------------------

// grid.y: one chunk of kCols columns per block row
int column_chunks(int k) { return (k + kCols - 1) / kCols; }
template <typename T>
int launch_rowwise(bool rows, const T* data, const T* X, T* Y, const int* offsets, int ndiag,
                   const Args& g, void* stream) {
  if (g.n < 1 || g.k < 1 || ndiag < 0) return (int)cudaErrorInvalidValue;
  if (rows && !(g.xs_col == 1 && g.ys_col == 1 && g.k % kCols == 0 &&
                (g.xs_row * sizeof(T)) % 16 == 0 && (g.ys_row * sizeof(T)) % 16 == 0 &&
                (uintptr_t)X % 16 == 0 && (uintptr_t)Y % 16 == 0))
    return (int)cudaErrorInvalidValue;
  const int chunks = column_chunks(g.k);
  const int64_t per_block = rows ? kThreads / (kCols / Rows<T>::cols) : kThreads;
  const int64_t blocks = (g.n + per_block - 1) / per_block;
  if (blocks > INT_MAX || chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  if (rows)
    dia_spmm_rows<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(data, X, Y, offsets, ndiag, g);
  else
    dia_spmm_strided<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(data, X, Y, offsets, ndiag, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blocked(const T* data, const T* X, T* Y, const Plan* plan, const Args& g, void* stream) {
  if (g.n < 1 || g.k < 1 || plan->nruns < 1 || plan->nruns > kMaxRuns || g.xs_row != 1 ||
      g.ys_row != 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = column_chunks(g.k);
  const int64_t tile = kThreads * Blk<T>::R;
  const int64_t blocks = (g.n + tile - 1) / tile;
  if (blocks > INT_MAX || chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  dia_spmm_blocked<T><<<dim3((unsigned)blocks, (unsigned)chunks), kThreads, 0,
                        (cudaStream_t)stream>>>(data, X, Y, *plan, g);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(int path, const T* data, const T* X, T* Y, const int* offsets, int ndiag,
          const Plan* plan, const Args& g, void* stream) {
  if (path == 2) return launch_blocked<T>(data, X, Y, plan, g, stream);
  if (path == 0 || path == 1)
    return launch_rowwise<T>(path == 1, data, X, Y, offsets, ndiag, g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// path: 0 strided, 1 rows (row-major aligned X and Y, k a multiple of 8),
// both reading `offsets` (ndiag int32 on the card); 2 blocked
// (column-contiguous X and Y), reading `plan` (host memory, copied into
// the launch). A path that does not apply returns cudaErrorInvalidValue.
extern "C" int dia_spmm_f32(int path, const float* data, const float* X, float* Y,
                            const int* offsets, int ndiag, const Plan* plan, long long n, int k,
                            long long xs_row, long long xs_col, long long ys_row,
                            long long ys_col, void* stream) {
  return entry<float>(path, data, X, Y, offsets, ndiag, plan,
                      Args{n, k, xs_row, xs_col, ys_row, ys_col}, stream);
}

extern "C" int dia_spmm_f64(int path, const double* data, const double* X, double* Y,
                            const int* offsets, int ndiag, const Plan* plan, long long n, int k,
                            long long xs_row, long long xs_col, long long ys_row,
                            long long ys_col, void* stream) {
  return entry<double>(path, data, X, Y, offsets, ndiag, plan,
                       Args{n, k, xs_row, xs_col, ys_row, ys_col}, stream);
}

// The blocked path's limits, which dia_spmm.py's planner must respect: the
// most bands in one run and the most runs in a plan.
extern "C" void dia_spmm_limits(int* max_bands, int* max_runs) {
  *max_bands = kMaxBands;
  *max_runs = kMaxRuns;
}

extern "C" const char* dia_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
