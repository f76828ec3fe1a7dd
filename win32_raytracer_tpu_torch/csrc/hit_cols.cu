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
// What bounds it on an H100: the S pair tests per ray (23 f32 multiplies,
// adds and subtractions and a compare each; 488 active spheres for the
// final scene), not memory (28 bytes in and 57 out per ray): 0.671 ms at
// the wavefront's 3,840,000 rays over 67 TFLOP/s, twice that under
// --fmad=false.  Design: kernel A's body (csrc/common.cuh sphere_hit_body)
// with the COLS ray load and record store: the block stages the active
// spheres packed (sweep_packed: a branch-free disc >= 0 mask pass per 32
// spheres, then the roots of the set bits), a thread sweeps two rays on a
// batch that gives every SM a block of 512, else one
// (kernels/hit.rays_per_thread); the winner's attributes are read by index
// once and the record written as one row of 12 floats and one of 2 ints
// per ray.
#include "common.cuh"

using namespace wrt;

template <int R>
__global__ void __launch_bounds__(kBlock) hit_cols_kernel(const HitArgs a) {
  __shared__ PackedTile sh;
  sphere_hit_body<Layout::COLS, R>(a, sh);
}

// rays: 1 or 2 rays per thread (kernels/hit.py rays_per_thread).
extern "C" int wrt_hit_spheres_cols(const HitArgs* a, int rays) {
  return launch_rays(a, rays, hit_cols_kernel<1>, hit_cols_kernel<2>);
}
