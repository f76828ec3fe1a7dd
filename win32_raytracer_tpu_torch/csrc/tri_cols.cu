// Kernel H: nearest two-sided triangle hit for a batch of rays, brute
// force over every triangle, column layout (the wavefront scheduler's
// triangle sweep).
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
// What bounds it on an H100: the T pair tests per ray (46 f32 multiplies,
// adds and a division, plus 6 compares; 332 active triangles for the mesh
// scene), not memory (24 bytes in and 57 out per ray).  Design: kernel C's
// body (csrc/common.cuh hit_triangles_body, its tri_pair_t pair test) with
// the COLS ray load and record store: one thread per ray, the triangle
// table staged through shared memory in tiles of kTriTile rows, strict <
// so the first index keeps ties, the winner's 16 attributes read by index
// once and the unit normal e1 x e2 computed in the plain version's
// epilogue.
#include "common.cuh"

using namespace wrt;

__global__ void __launch_bounds__(kBlock) tri_cols_kernel(const TriArgs a) {
  __shared__ TriTile sh;
  __shared__ int act[kTriTile];
  hit_triangles_body<Layout::COLS>(a, sh, act);
}

extern "C" int wrt_hit_triangles_cols(const TriArgs* a) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  tri_cols_kernel<<<grid, kBlock, 0, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}
