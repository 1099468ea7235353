// Kernel RN: counter-based standard-normal draws (Philox4x32-10 and
// Box-Muller), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws estimate_lmax's start
// vector with jax.random.normal (Threefry, counter-based, inside XLA). The
// port draws it with this kernel on the card and with its plain twin
// (ops/cuda/rng.py, numpy uint64 arithmetic) on the CPU, so that both
// builds start the power iteration from the same vector.
//
// The draw: element k of a leaf, in flat C order, is one half of the
// Philox4x32-10 block (Salmon et al., SC'11; Random123) of
//
//     counter (p mod 2^32, p div 2^32, seed div 2^32, 0),  p = k div 2,
//     key     (seed mod 2^32, leaf),
//
// whose four words x0..x3 give two 53-bit uniforms
//
//     u1 = ((x0 >> 5) * 2^26 + (x1 >> 6) + 1) * 2^-53   in (0, 1],
//     u2 = ((x2 >> 5) * 2^26 + (x3 >> 6)) * 2^-53       in [0, 1),
//
// and Box-Muller, in f64: r = sqrt(-2 log u1), t = 2 pi u2, element 2p is
// r cos t and element 2p + 1 is r sin t. A float32 output is the f64 value
// rounded. So element k depends only on (seed, leaf, k): not on the device,
// the rank count or the launch configuration. The integer part is exact on
// both sides, so the words and uniforms are bit-equal to the twin's; log,
// sin and cos are the card's (CUDA's stated bounds: 1, 2 and 2 ulp), so the
// normals agree with the twin's to a few ulp.
//
// What bounds it: bytes written, 8 (f64) or 4 (f32) a value and nothing
// read: 107 MB, 32 us at 3.35 TB/s, for the 13.4M values of config 5's
// six Chebyshev levels in f64. The arithmetic, ten rounds of two 32-bit
// multiplies and one log, sqrt, sin and cos in f64 a pair, is of the same
// order on the card's f64 units.
//
// What the design does about it: one thread a pair in a grid-stride loop,
// pairs on consecutive threads, so each warp stores one contiguous run of
// 64 values, as one 16-byte (f64) or 8-byte (f32) vector store a thread.
// Nothing but the output touches device memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr double kTwoPi = 6.283185307179586476925286766559;  // 2 pi, rounded to f64
constexpr double kTwoToMinus53 = 1.1102230246251565404236316680908203125e-16;

// Philox4x32-10 of counter c under key (k0, k1), in place.
__device__ __forceinline__ void philox10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c[0]), lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]), lo1 = kM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ void block_of(long long p, uint32_t k0, uint32_t k1, uint32_t c2, uint32_t c[4]) {
  c[0] = (uint32_t)p;
  c[1] = (uint32_t)((unsigned long long)p >> 32);
  c[2] = c2;
  c[3] = 0u;
  philox10(c, k0, k1);
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    normal_draw_kernel(T* __restrict__ out, long long n, uint32_t k0, uint32_t k1, uint32_t c2) {
  const long long pairs = (n + 1) / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs; p += stride) {
    uint32_t c[4];
    block_of(p, k0, k1, c2, c);
    const unsigned long long a = ((unsigned long long)(c[0] >> 5) << 26) | (c[1] >> 6);
    const unsigned long long b = ((unsigned long long)(c[2] >> 5) << 26) | (c[3] >> 6);
    const double u1 = ((double)a + 1.0) * kTwoToMinus53;
    const double u2 = (double)b * kTwoToMinus53;
    const double r = sqrt(-2.0 * log(u1));
    const double t = kTwoPi * u2;
    const double z0 = r * cos(t), z1 = r * sin(t);
    if (2 * p + 1 < n) {
      typename Pair<T>::type v;
      v.x = (T)z0;
      v.y = (T)z1;
      reinterpret_cast<typename Pair<T>::type*>(out)[p] = v;
    } else {
      out[2 * p] = (T)z0;
    }
  }
}

// The four Philox words of pairs 0 .. pairs - 1, for the tests.
__global__ void __launch_bounds__(kThreads)
    philox_words_kernel(uint32_t* __restrict__ out, long long pairs, uint32_t k0, uint32_t k1, uint32_t c2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs; p += stride) {
    uint32_t c[4];
    block_of(p, k0, k1, c2, c);
    reinterpret_cast<uint4*>(out)[p] = make_uint4(c[0], c[1], c[2], c[3]);
  }
}

int blocks_for(long long pairs) {
  const long long b = (pairs + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
int launch(T* out, long long n, uint32_t k0, uint32_t k1, uint32_t c2, void* stream) {
  if (n <= 0) return 0;
  normal_draw_kernel<T><<<blocks_for((n + 1) / 2), kThreads, 0, (cudaStream_t)stream>>>(out, n, k0, k1, c2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int normal_draw_f32(float* out, long long n, uint32_t k0, uint32_t k1, uint32_t c2, void* stream) {
  return launch<float>(out, n, k0, k1, c2, stream);
}

extern "C" int normal_draw_f64(double* out, long long n, uint32_t k0, uint32_t k1, uint32_t c2, void* stream) {
  return launch<double>(out, n, k0, k1, c2, stream);
}

extern "C" int normal_draw_words(uint32_t* out, long long pairs, uint32_t k0, uint32_t k1, uint32_t c2,
                                 void* stream) {
  if (pairs <= 0) return 0;
  philox_words_kernel<<<blocks_for(pairs), kThreads, 0, (cudaStream_t)stream>>>(out, pairs, k0, k1, c2);
  return (int)cudaGetLastError();
}

extern "C" const char* normal_draw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
