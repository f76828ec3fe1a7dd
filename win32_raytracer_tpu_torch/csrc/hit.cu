// Kernel A: nearest sphere hit for a batch of rays, rows layout.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/hit_pallas_v6.py
// (_hit_kernel_v6), the persistent scheduler's below-floor hit.  The TPU
// kernel builds the quadratic as split-bf16 matrix products on the MXU; this
// one computes ops/hit.py's exact f32 pair test, so it agrees with the plain
// sweep and not with v6's ~2e-4 winner flips.
//
// What bounds it on an H100: the S pair tests per ray (26 f32 multiplies,
// adds and subtractions and a compare each, five more where the ray meets
// the sphere; 488 active spheres for the final scene), not memory (28 bytes
// in and 57 out per ray).  Design (csrc/common.cuh hit_spheres_body, shared
// with kernel G): one thread per ray; the block stages the sphere table
// through shared memory in tiles of kTile spheres, so each attribute is read
// from device memory once per block and broadcast from shared memory to all
// of its threads; the winner's attributes are fetched by index once.
#include "common.cuh"

using namespace wrt;

__global__ void __launch_bounds__(kBlock) hit_kernel(const HitArgs a) {
  __shared__ SphereTile sh;
  hit_spheres_body<Layout::ROWS>(a, sh);
}

extern "C" int wrt_hit_spheres(const HitArgs* a) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  hit_kernel<<<grid, kBlock, 0, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
