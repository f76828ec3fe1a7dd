// Kernel H: nearest two-sided triangle hit for a batch of rays, brute
// force over every active triangle, column layout (the wavefront
// scheduler's triangle sweep).
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/tri_pallas.py
// (_tri_kernel).  The TPU kernel takes the rays as [8, N] rows, rejects
// padding rows by det ~ 0 and fetches the winner's attributes with a
// one-hot matrix product (triangle 0's row on a miss).  This one reads the
// wavefront's [N, 3] rays where they lie, gates by the active mask, picks
// the winner by index and writes zeros on a miss, as the plain
// ops/hit_tri.py hit_triangles does; it agrees with that plain sweep bit
// for bit (--fmad=false, IEEE division).
//
// What bounds it on an H100: instruction issue in the T pair tests per ray
// (332 active triangles for the mesh scene, 20,492 for mesh20k), not
// memory (24 bytes in and 57 out per ray).  Design: kernel C's body
// (csrc/common.cuh tri_hit_body) with the COLS ray load and record store:
// the active rows staged packed with their original rows, kBlock candidate
// rows a stage; per chunk of 8 a division-free mask pass, then the exact
// test on the set bits, ascending, strict <; two rays per thread on a
// batch that fills the card, one on a smaller batch; the winner's 16
// attributes read by index once and the unit normal e1 x e2 computed in the
// plain version's epilogue.
#include "common.cuh"

using namespace wrt;

template <int R>
__global__ void __launch_bounds__(kBlock) tri_cols_kernel(const TriArgs a) {
  __shared__ TriStage sh;
  tri_hit_body<Layout::COLS, R>(a, sh);
}

// rays: 1 or 2 rays per thread (kernels/hit.py rays_per_thread).
extern "C" int wrt_hit_triangles_cols(const TriArgs* a, int rays) {
  return launch_rays(a, rays, tri_cols_kernel<1>, tri_cols_kernel<2>);
}
