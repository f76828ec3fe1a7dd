// Kernel C: nearest two-sided triangle hit for a batch of rays, brute
// force over every triangle, rows layout.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/tri_pallas_mxu.py
// (_tri_kernel_mxu), the triangle sweep of meshes below the grid threshold
// and of every mesh under accel="off".  The TPU kernel expands the four
// Moller-Trumbore triple products into split-bf16 matrix products on the
// MXU and flips winners near edges and ties; this one computes
// ops/hit_tri.py's exact f32 pair test in the same operation order, so it
// agrees with the plain sweep.
//
// What bounds it on an H100: the T pair tests per ray (46 f32 multiplies,
// adds and a division, plus 6 compares; T = 332 active triangles for the
// mesh scene), not memory (24 bytes in and 57 out per ray).  Design
// (csrc/common.cuh hit_triangles_body, shared with kernel H): one thread
// per ray; the block stages the triangle table through shared
// memory in tiles of kTriTile rows (9 geometry columns,
// 4.5 KB), so each attribute is read from device memory once per block and
// broadcast to its threads; strict < keeps the first index on ties; the
// winner's 16 attributes are read by index once, and the normal is computed
// in the same epilogue as the plain version's.
#include "common.cuh"

using namespace wrt;

__global__ void __launch_bounds__(kBlock) tri_kernel(const TriArgs a) {
  __shared__ TriTile sh;
  __shared__ int act[kTriTile];
  hit_triangles_body<Layout::ROWS>(a, sh, act);
}

extern "C" int wrt_hit_triangles(const TriArgs* a) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  tri_kernel<<<grid, kBlock, 0, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}
