// The wavefront scheduler's uniform draws: jax.random.uniform's threefry
// bits, one launch a draw.
//
// Replaces no TPU kernel: the JAX package draws with jax.random.uniform,
// which XLA compiles.  The port's plain version, core/rng.py uniform01,
// computes the same threefry-2x32 as ~180 int64 torch ops masked to 32
// bits, each reading and writing 8-byte words of the whole draw; this
// kernel gives the same bits.  Element i (flat index) is the counter pair
// (i >> 32, i & 0xFFFFFFFF) hashed under the key (k0, k1) in the form JAX
// uses with jax_threefry_partitionable on: 20 rounds of add, rotate and
// xor with the rotations (13, 15, 26, 6) / (17, 29, 16, 24), a key
// injection ks[(g+1)%3], ks[(g+2)%3] + g + 1 after each group g of four,
// then the two output words xored and kept as a float's 23 mantissa bits
// in [1, 2), less 1.0f (an exact subtraction, as in the torch version).
//
// What bounds it on an H100: integer operations, about 75 an element (60
// for the rounds, 12 for the injections, 3 for the output bits); the
// bytes are 4 an element, the stored f32.  Design: a thread keeps both
// words in registers and writes nothing but the result: four consecutive
// elements a thread, stored as one 16-byte float4 where the output is
// aligned, element by element at the ragged tail.  No shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDrawBlock = 256;
constexpr int kPerThread = 4;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Four rounds of one rotation table, then the key injection of group g.
__device__ __forceinline__ void group(uint32_t& x0, uint32_t& x1, int r0,
                                      int r1, int r2, int r3, uint32_t a,
                                      uint32_t b) {
  mix(x0, x1, r0);
  mix(x0, x1, r1);
  mix(x0, x1, r2);
  mix(x0, x1, r3);
  x0 += a;
  x1 += b;
}

__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t k2, long long i) {
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32) + k0;
  uint32_t x1 = (uint32_t)i + k1;
  group(x0, x1, 13, 15, 26, 6, k1, k2 + 1u);
  group(x0, x1, 17, 29, 16, 24, k2, k0 + 2u);
  group(x0, x1, 13, 15, 26, 6, k0, k1 + 3u);
  group(x0, x1, 17, 29, 16, 24, k1, k2 + 4u);
  group(x0, x1, 13, 15, 26, 6, k2, k0 + 5u);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace

__global__ void __launch_bounds__(kDrawBlock)
threefry_uniform_kernel(uint32_t k0, uint32_t k1, long long n, float* out) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  const long long i =
      ((long long)blockIdx.x * kDrawBlock + threadIdx.x) * kPerThread;
  if (i + kPerThread <= n && ((uintptr_t)out & 15) == 0) {
    float4 v;
    v.x = uniform_at(k0, k1, k2, i);
    v.y = uniform_at(k0, k1, k2, i + 1);
    v.z = uniform_at(k0, k1, k2, i + 2);
    v.w = uniform_at(k0, k1, k2, i + 3);
    *reinterpret_cast<float4*>(out + i) = v;
    return;
  }
  for (int j = 0; j < kPerThread && i + j < n; ++j)
    out[i + j] = uniform_at(k0, k1, k2, i + j);
}

// n draws under the key (k0, k1) into out [n] f32, on the given stream.
extern "C" int wrt_threefry_uniform(uint32_t k0, uint32_t k1, long long n,
                                    float* out, void* stream) {
  if (n <= 0) return 0;
  const long long per_block = (long long)kDrawBlock * kPerThread;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  threefry_uniform_kernel<<<(unsigned)blocks, kDrawBlock, 0,
                            (cudaStream_t)stream>>>(k0, k1, n, out);
  return (int)cudaGetLastError();
}
