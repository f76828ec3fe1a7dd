// Kernel C: nearest two-sided triangle hit for a batch of rays, brute
// force over every active triangle, rows layout.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/tri_pallas_mxu.py
// (_tri_kernel_mxu), the triangle sweep of meshes below the grid threshold
// and of every mesh under accel="off".  The TPU kernel expands the four
// Moller-Trumbore triple products into split-bf16 matrix products on the
// MXU and flips winners near edges and ties; this one computes
// ops/hit_tri.py's exact f32 pair test in the same operation order, so it
// agrees with the plain sweep bit for bit.
//
// What bounds it on an H100: instruction issue in the T pair tests per ray
// (T = 332 active triangles for the mesh scene), not memory (24 bytes in
// and 57 out per ray).  The exact pair test is 46 f32 operations, one of
// them an IEEE division, and 6 compares; almost every pair misses.
// Design (csrc/common.cuh tri_hit_body and tri_sweep_stage, shared with
// kernel H): each block stages the table's active rows, ascending, as three
// float4s with their original rows, so a pair test reads no active flag;
// a first pass over 8 triangles forms det and the numerators of u, v and
// t by the exact test's operations and keeps a bit where the pair may
// pass, with no division and no branch (about 57 instructions per pair
// test against the parent sweep's 87); a second runs the exact test on the
// set bits, ascending, strict <.  A thread sweeps two rays, so one staged
// triangle's loads serve two pair tests, where the batch still gives every
// SM a block of 512 rays; a smaller batch takes one ray per thread
// (kernels/hit.rays_per_thread, as kernel A).  The mask pass is unrolled,
// and at two rays a chunk of 32 triangles outgrew the instruction cache:
// hence chunks of 8 (csrc/common.cuh kTriChunk).  The winner's 16
// attributes are read by index once, and the normal is computed in the
// plain version's epilogue.
#include "common.cuh"

using namespace wrt;

template <int R>
__global__ void __launch_bounds__(kBlock) tri_kernel(const TriArgs a) {
  __shared__ TriStage sh;
  tri_hit_body<Layout::ROWS, R>(a, sh);
}

// rays: 1 or 2 rays per thread (kernels/hit.py rays_per_thread).
extern "C" int wrt_hit_triangles(const TriArgs* a, int rays) {
  return launch_rays(a, rays, tri_kernel<1>, tri_kernel<2>);
}
