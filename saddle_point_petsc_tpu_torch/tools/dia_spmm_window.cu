// Kernel B6 with X staged in shared memory: a design that measured slower
// on an H100 than the paths of csrc/dia_spmm.cu, kept so that
// tools/b6_variants.py can build it and time it beside them (PERF.md).
// Not part of the port: nothing in the package loads it.
//
// It computes what csrc/dia_spmm.cu computes, with the same bits: Y[i, c] =
// sum_d data[d, i] * X[i + off_d, c], in offset order, each product and
// sum rounded one by one, terms with i + off_d outside [0, n) skipped. It
// takes the same plan (runs of consecutive offsets, ops/cuda/dia_spmm.py
// plan_runs) and exports the same entry points, so the wrapper binds it
// as it binds that library; every call runs the window kernel.
//
// The design: a block of kWThreads threads owns a tile of kTile rows (R
// consecutive rows a thread, 4 in f32, 2 in f64) and up to kCols columns,
// on a persistent grid. For each run it copies the window of X rows [i0 +
// lo, i0 + kTile + count - 1) and the run's band values once into shared
// memory with cp.async (8- or 16-byte copies of a column-contiguous X, the
// window shifted to keep them aligned; element copies of any other X),
// into a ring of kStages buffers: the next run's copy is in flight while
// the current run's bands are applied from 16-byte shared-memory loads.
// X then crosses L2 once per run (3 times a row on the 1025^2 operator),
// not once per band. Y goes out through the slot of the tile's last run,
// a warp writing whole lines.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

constexpr int kMaxBands = 8;  // bands in one run
constexpr int kMaxRuns = 16;  // runs in one plan

// The window path's runs (the ctypes _Plan of ops/cuda/dia_spmm.py): run r
// holds the bands of offsets lo, lo + 1, ..., lo + count - 1, in that order.
struct Plan {
  int nruns;
  int run[kMaxRuns][3];            // lo, first band, band count
  int band[kMaxRuns * kMaxBands];  // row of data of each band
};

namespace {

constexpr int kCols = 8;        // columns per block (more columns: more blocks along grid.y)
constexpr int kWThreads = 128;  // window path: threads per block
constexpr int kStages = 2;      // window path: ring of (tile, run) stages in shared memory
constexpr int kChunk = 2;       // window path: elements per copy of a column-contiguous X

// the window path: R consecutive rows per thread; P the pitch of a window
// column in shared memory (4 mod 32 words: the transposing copy of a
// row-major X does not conflict); NV the window values a thread loads per
// column and run, 16 bytes at a time
template <typename T> struct Win;
template <> struct Win<float> { static constexpr int R = 4, P = 548, NV = 12; };
template <> struct Win<double> { static constexpr int R = 2, P = 274, NV = 10; };
template <typename T> constexpr int kTile = kWThreads * Win<T>::R;  // rows per tile
// one stage: the X window (kCols columns of pitch P), then the run's band
// values of the tile's rows (kMaxBands rows of kTile)
template <typename T> constexpr int kStageLen = kCols * Win<T>::P + kMaxBands * kTile<T>;
template <typename T> constexpr size_t kSmemBytes = (size_t)kStages * kStageLen<T> * sizeof(T);
// the Y tile, column by column, in the slot of the tile's last run
template <typename T> constexpr int kYPitch = kTile<T> + 4;

template <typename T>
constexpr bool win_fits() {
  using W = Win<T>;
  return W::NV >= kChunk - 1 + W::R + kMaxBands - 1 && W::NV * sizeof(T) % 16 == 0 &&
         W::R * sizeof(T) == 16 && W::P >= W::R * (kWThreads - 1) + W::NV &&
         W::P >= kChunk - 1 + kTile<T> + kMaxBands - 1 && W::P * sizeof(T) % 16 == 0 &&
         kCols * kYPitch<T> <= kStageLen<T> && kYPitch<T> * sizeof(T) % 16 == 0 &&
         kMaxBands * W::R <= 32;
}
static_assert(win_fits<float>() && win_fits<double>(), "window path shapes");
static_assert(kStages >= 2, "a ring of at least two stages");

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
    const int4 w = *(reinterpret_cast<const int4*>(p) + h);
    memcpy(&v[h * 16 / sizeof(T)], &w, 16);
  }
}

// ---- the window path ---------------------------------------------------------

// Where X row w0 of column xc sits in its kChunk-element chunk: a
// column-contiguous X is copied a chunk at a time (8 or 16 bytes), so the
// window of a column starts `shift` elements into shared memory; any other
// X is copied element by element, unshifted.
template <typename T>
__device__ __forceinline__ int window_shift(const T* xc, int64_t w0, const Args& g) {
  if (g.xs_row != 1) return 0;
  return (int)(((int64_t)((uintptr_t)xc / sizeof(T)) + w0) & (kChunk - 1));
}

// Start the copies of one stage into xw: run r of the block's q-th tile
// (tile blockIdx.x + q * gridDim.x, rows [i0, i0 + kTile)). X rows [w0, w0
// + kTile + count - 1) ∩ [0, n), w0 = i0 + lo, go to xw[c * P + shift + row
// - w0]: a column-contiguous X in aligned chunks, consecutive threads on
// consecutive chunks; otherwise thread t copies column tc of rows tw, tw +
// rpp, ... (tc = t % kc, tw = t / kc), so a warp reads whole lines of a
// row-major X. Band e's values of the tile's rows go to dw[e * kTile +
// row - i0], where the term is live. Always commits one group, empty past
// the block's last tile.
template <typename T>
__device__ __forceinline__ void issue(T* xw, int64_t q, int r, int64_t tiles, const Plan& p,
                                      const T* __restrict__ data, const T* __restrict__ x,
                                      const Args& g, int kc, int tc, int tw, int rpp) {
  constexpr int P = Win<T>::P, TILE = kTile<T>;
  if (q < tiles) {
    const int t = threadIdx.x;
    const int64_t i0 = (blockIdx.x + q * gridDim.x) * (int64_t)TILE;
    const int lo = p.run[r][0], first = p.run[r][1], cnt = p.run[r][2];
    const int64_t w0 = i0 + lo;
    const int64_t a = w0 > 0 ? w0 : 0;
    const int64_t b = w0 + TILE + cnt - 1 < g.n ? w0 + TILE + cnt - 1 : g.n;
    if (a < b) {
      if (g.xs_row == 1) {
        for (int c = 0; c < kc; ++c) {
          const T* xc = x + c * g.xs_col;
          const int64_t base = (int64_t)((uintptr_t)xc / sizeof(T));  // element address of X[0, c]
          T* dc = xw + c * P + window_shift(xc, w0, g);
          for (int64_t ch = (base + a) / kChunk + t; ch <= (base + b - 1) / kChunk; ch += kWThreads) {
            const int64_t j0 = ch * kChunk - base;  // first X row of the chunk
            if (j0 >= a && j0 + kChunk <= b) {
              __pipeline_memcpy_async(dc + (j0 - w0), xc + j0, kChunk * sizeof(T));
            } else {
#pragma unroll
              for (int m = 0; m < kChunk; ++m)
                if (j0 + m >= a && j0 + m < b)
                  __pipeline_memcpy_async(dc + (j0 + m - w0), xc + j0 + m, sizeof(T));
            }
          }
        }
      } else if (t < rpp * kc) {
        for (int64_t w = a + tw; w < b; w += rpp)
          __pipeline_memcpy_async(xw + tc * P + (w - w0), x + w * g.xs_row + tc * g.xs_col, sizeof(T));
      }
    }
    T* dw = xw + kCols * P;
    for (int e = 0; e < cnt; ++e) {
      const T* band = data + (int64_t)p.band[first + e] * g.n;
      for (int w = t; w < TILE; w += kWThreads) {
        const int64_t i = i0 + w, j = i + lo + e;
        if (i < g.n && j >= 0 && j < g.n) __pipeline_memcpy_async(dw + e * TILE + w, band + i, sizeof(T));
      }
    }
  }
  __pipeline_commit();
}

// Apply a run's bands to one column of this thread's R rows: xs is the
// thread's first window row of the column (16-byte aligned), S the
// column's shift; under Edge only the live terms (bit e * R + r).
template <typename T, int S, bool Edge>
__device__ __forceinline__ void apply(T (&acc)[Win<T>::R], const T* xs,
                                      const T (&av)[kMaxBands][Win<T>::R], int cnt, uint32_t live) {
  constexpr int R = Win<T>::R;
  T v[Win<T>::NV];
  load16(v, xs);
#pragma unroll
  for (int e = 0; e < kMaxBands; ++e) {
    if (e >= cnt) break;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (!Edge || ((live >> (e * R + r)) & 1u)) acc[r] = add_rn(acc[r], mul_rn(av[e][r], v[S + r + e]));
  }
}

// A persistent grid: block b takes tiles b, b + gridDim.x, ... and walks
// their runs as one sequence of stages, kStages - 1 of them in flight
// while it applies the current one, across tile boundaries. Thread t sums
// rows i0 + R t ... i0 + R t + R - 1 of every column. The plan has at
// least one run.
template <typename T>
__global__ void __launch_bounds__(kWThreads)
dia_spmm_window(const T* __restrict__ data, const T* __restrict__ X, T* __restrict__ Y,
                const __grid_constant__ Plan p, const Args g) {
  constexpr int P = Win<T>::P, R = Win<T>::R, TILE = kTile<T>, YP = kYPitch<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, g.k - c0);
  const T* x = X + (int64_t)c0 * g.xs_col;
  T* y = Y + (int64_t)c0 * g.ys_col;
  const int rpp = kWThreads / kc;  // rows per pass of a strided copy
  const int tc = t % kc, tw = t / kc;
  const int64_t ntiles = (g.n + TILE - 1) / TILE;
  const int64_t tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // stages in order: run r of the block's q-th tile, in ring slot `slot`
  const auto next = [&](int64_t& q, int& r, int& slot) {
    if (++r == p.nruns) {
      r = 0;
      ++q;
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  };
  int64_t iq = 0;  // the next stage to issue
  int ir = 0, islot = 0;
  for (int s = 0; s < kStages - 1; ++s) {
    issue(ring + islot * kStageLen<T>, iq, ir, tiles, p, data, x, g, kc, tc, tw, rpp);
    next(iq, ir, islot);
  }
  T acc[kCols][R];
  int64_t q = 0;  // the stage to apply
  int r = 0, slot = 0;
  while (q < tiles) {
    const int64_t i0 = (blockIdx.x + q * gridDim.x) * (int64_t)TILE;
    const int64_t i = i0 + R * t;  // this thread's first row
    if (r == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int h = 0; h < R; ++h) acc[c][h] = T(0);
    }
    __pipeline_wait_prior(kStages - 2);  // this stage has landed (this thread's copies)
    __syncthreads();  // ... every thread's; and every thread is done with the slot issued next
    issue(ring + islot * kStageLen<T>, iq, ir, tiles, p, data, x, g, kc, tc, tw, rpp);
    next(iq, ir, islot);
    T* xw = ring + slot * kStageLen<T>;
    const T* dw = xw + kCols * P;
    const int lo = p.run[r][0], cnt = p.run[r][2];
    const int64_t w0 = i0 + lo;
    T av[kMaxBands][R];
#pragma unroll
    for (int e = 0; e < kMaxBands; ++e) {
      if (e >= cnt) break;
      load16(av[e], dw + e * TILE + R * t);
    }
    // an edge stage has terms outside [0, n): rows past n or X rows outside it
    const bool edge = w0 < 0 || i0 + TILE > g.n || i0 + TILE + lo + cnt - 2 >= g.n;
    uint32_t live = 0;
    if (edge) {
#pragma unroll
      for (int e = 0; e < kMaxBands; ++e)
#pragma unroll
        for (int h = 0; h < R; ++h) {
          const int64_t j = i + h + lo + e;
          if (e < cnt && i + h < g.n && j >= 0 && j < g.n) live |= 1u << (e * R + h);
        }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= kc) break;
      const T* xs = xw + c * P + R * t;
      const int sh = window_shift(x + c * g.xs_col, w0, g);
      if (edge) {
        if (sh) apply<T, 1, true>(acc[c], xs, av, cnt, live);
        else apply<T, 0, true>(acc[c], xs, av, cnt, live);
      } else {
        if (sh) apply<T, 1, false>(acc[c], xs, av, cnt, live);
        else apply<T, 0, false>(acc[c], xs, av, cnt, live);
      }
    }
    if (r == p.nruns - 1) {  // the tile's sums, through this slot
      __syncthreads();  // every thread is done reading the slot
      T* ys = xw;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c >= kc) break;
        int4 w;
        memcpy(&w, acc[c], 16);
        *reinterpret_cast<int4*>(ys + c * YP + R * t) = w;
      }
      __syncthreads();
      const int rows = (int)(g.n - i0 < TILE ? g.n - i0 : TILE);
      if (g.ys_row == 1) {
        for (int c = 0; c < kc; ++c)
          for (int w = t; w < rows; w += kWThreads) __stcs(y + c * g.ys_col + i0 + w, ys[c * YP + w]);
      } else if (t < rpp * kc) {
        for (int w = tw; w < rows; w += rpp) __stcs(y + (i0 + w) * g.ys_row + tc * g.ys_col, ys[tc * YP + w]);
      }
    }
    next(q, r, slot);
  }
}

// ---- launches ----------------------------------------------------------------

// grid.y: one chunk of kCols columns per block row
int column_chunks(int k) { return (k + kCols - 1) / kCols; }

template <typename T>
int launch_window(const T* data, const T* X, T* Y, const Plan* plan, const Args& g, void* stream) {
  if (g.n < 1 || g.k < 1 || plan->nruns < 1 || plan->nruns > kMaxRuns)
    return (int)cudaErrorInvalidValue;
  const int chunks = column_chunks(g.k);
  if (chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  // the grid: as many blocks as fit on the card at once, at most one per tile
  static int fitted[64] = {};  // blocks per card, by device ordinal (0: not yet known)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (fitted[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(dia_spmm_window<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes<T>);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dia_spmm_window<T>, kWThreads,
                                                          kSmemBytes<T>);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    fitted[dev] = sms * per_sm;
  }
  const int64_t ntiles = (g.n + kTile<T> - 1) / kTile<T>;
  const int64_t blocks = ntiles < fitted[dev] ? ntiles : fitted[dev];
  dia_spmm_window<T><<<dim3((unsigned)blocks, (unsigned)chunks), kWThreads, kSmemBytes<T>,
                       (cudaStream_t)stream>>>(data, X, Y, *plan, g);
  return (int)cudaGetLastError();
}

}  // namespace

// path: 0 strided, 1 rows (row-major aligned X and Y, k a multiple of 8;
// else cudaErrorInvalidValue), both reading `offsets` (ndiag int32 on the
// card); 2 window, reading `plan` (host memory, copied into the launch).
extern "C" int dia_spmm_f32(int path, const float* data, const float* X, float* Y,
                            const int* offsets, int ndiag, const Plan* plan, long long n, int k,
                            long long xs_row, long long xs_col, long long ys_row,
                            long long ys_col, void* stream) {
  return launch_window<float>(data, X, Y, plan, Args{n, k, xs_row, xs_col, ys_row, ys_col}, stream);
}

extern "C" int dia_spmm_f64(int path, const double* data, const double* X, double* Y,
                            const int* offsets, int ndiag, const Plan* plan, long long n, int k,
                            long long xs_row, long long xs_col, long long ys_row,
                            long long ys_col, void* stream) {
  return launch_window<double>(data, X, Y, plan, Args{n, k, xs_row, xs_col, ys_row, ys_col}, stream);
}

// The plan's limits, which dia_spmm.py's planner must respect: the
// most bands in one run and the most runs in a plan.
extern "C" void dia_spmm_limits(int* max_bands, int* max_runs) {
  *max_bands = kMaxBands;
  *max_runs = kMaxRuns;
}

extern "C" const char* dia_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
