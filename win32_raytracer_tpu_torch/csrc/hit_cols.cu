// Kernel G: nearest front-face sphere hit for a batch of rays, column
// layout (the wavefront scheduler's hit).
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/hit_pallas_v3.py
// (_hit_kernel_v3).  The TPU kernel takes the rays as [8, N] rows (rays in
// lanes), gates spheres by r != 0 and fetches the winner's attributes with
// a one-hot matrix product, which returns sphere 0's row on a miss.  This
// one reads the wavefront's [N, 3] rays where they lie, gates by the
// scene's active mask, picks the winner by index and writes zeros on a
// miss, as the plain ops/hit.py hit_spheres does; it agrees with that
// plain sweep bit for bit (--fmad=false, IEEE sqrtf and division).
//
// What bounds it on an H100: the S pair tests per ray (26 f32 multiplies,
// adds and subtractions and a compare each; 488 active spheres for the
// final scene), not memory (28 bytes in and 57 out per ray).  Design: kernel
// A's body (csrc/common.cuh hit_spheres_body) with the COLS ray load and
// record store: one thread per ray, the sphere table staged through shared
// memory in tiles of kTile spheres and broadcast to the block's threads,
// the winner's attributes read by index once, the record written as one
// row of 12 floats and one of 2 ints per ray.
#include "common.cuh"

using namespace wrt;

__global__ void __launch_bounds__(kBlock) hit_cols_kernel(const HitArgs a) {
  __shared__ SphereTile sh;
  hit_spheres_body<Layout::COLS>(a, sh);
}

extern "C" int wrt_hit_spheres_cols(const HitArgs* a) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  hit_cols_kernel<<<grid, kBlock, 0, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}
