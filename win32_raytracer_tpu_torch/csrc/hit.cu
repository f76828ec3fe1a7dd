// Kernel A: nearest sphere hit for a batch of rays, rows layout.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/hit_pallas_v6.py
// (_hit_kernel_v6), the persistent scheduler's below-floor hit.  The TPU
// kernel builds the quadratic as split-bf16 matrix products on the MXU; this
// one computes ops/hit.py's exact f32 pair test, so it agrees with the plain
// sweep and not with v6's ~2e-4 winner flips.
//
// What bounds it on an H100: instruction issue in the S pair tests per ray
// (488 active spheres for the final scene), not memory (28 bytes in and 57
// out per ray).  Each pair test is 23 f32 multiplies, adds and
// subtractions and a compare where the tile shares one lerp (every tile of
// the built-in scenes), 25 and a compare where it does not: 0.0917 ms at
// 524,288 rays over 67 TFLOP/s.  --fmad=false keeps them unfused, so they
// retire at half that rate: a floor of 0.183 ms.  The sweep it replaced
// issued 46 instructions per pair test, ten of them shared loads; this one
// issues 27-28 (chip_smoke.py phase 1 counts them in the SASS), and takes
// 0.26 ms at 524,288 rays where the old one took 0.44 (PERF.md section 6
// has the measured times).
//
// Design (csrc/common.cuh sphere_hit_body, shared with kernel G, and
// sweep_packed): each block stages the table's
// active rows, ascending, packed for 16-byte shared loads and with their
// original rows, so a pair test issues two LDS.128 and no active test; the
// lerp is formed once per ray and tile where the tile's (t1, invdt) agree;
// a first pass over 32 spheres keeps only the bits disc >= 0, so the hot
// loop has no branch, and a second forms the roots of the set bits.  A
// thread sweeps two rays, so one load serves two pair tests, where the
// batch still gives every SM a block of 512 rays; a smaller batch (the
// persistent tail compacts down to 4,096 rays) takes one ray per thread,
// so that twice as many SMs get a block.  The winner's attributes are
// fetched by index once.
#include "common.cuh"

using namespace wrt;

template <int R>
__global__ void __launch_bounds__(kBlock) hit_kernel(const HitArgs a) {
  __shared__ PackedTile sh;
  sphere_hit_body<Layout::ROWS, R>(a, sh);
}

// rays: 1 or 2 rays per thread (kernels/hit.py rays_per_thread).
extern "C" int wrt_hit_spheres(const HitArgs* a, int rays) {
  return launch_rays(a, rays, hit_kernel<1>, hit_kernel<2>);
}

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
