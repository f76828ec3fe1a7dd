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
// mesh scene), not memory (24 bytes in and 57 out per ray).  Design: one
// thread per ray; the block stages the triangle table through shared
// memory in tiles of kTriTile rows (9 geometry columns,
// 4.5 KB), so each attribute is read from device memory once per block and
// broadcast to its threads; strict < keeps the first index on ties; the
// winner's 16 attributes are read by index once, and the normal is computed
// in the same epilogue as the plain version's.
#include "common.cuh"

using namespace wrt;

struct TriArgs {
  const float* origin;     // [3, n]
  const float* direction;  // [3, n]
  const float* attrs;      // [n_tris, TRI_ATTR_COLS]
  const uint8_t* active;   // [n_tris]
  float* out_f;            // [12, n]
  int32_t* out_i;          // [2, n]
  uint8_t* out_hit;        // [n]
  long long n;
  int n_tris;
  float min_t;
  void* stream;
};

__global__ void __launch_bounds__(kBlock) tri_kernel(const TriArgs a) {
  __shared__ TriTile sh;
  __shared__ int act[kTriTile];
  const long long n = a.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n;
  const long long k = on ? i : 0;  // idle threads still help stage tiles
  const float ox = a.origin[k], oy = a.origin[n + k], oz = a.origin[2 * n + k];
  const float dx = a.direction[k], dy = a.direction[n + k],
              dz = a.direction[2 * n + k];

  float best_t = kNoHit;
  int best_i = -1;
  for (int base = 0; base < a.n_tris; base += kTriTile) {
    const int cnt = min(kTriTile, a.n_tris - base);
    __syncthreads();  // the previous tile is consumed
    stage_tris(a.attrs, TRI_ATTR_COLS, base, cnt, sh);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x)
      act[j] = a.active[base + j];
    __syncthreads();
    if (!on) continue;
    for (int j = 0; j < cnt; ++j) {
      if (!act[j]) continue;
      const float t = tri_pair_t(sh, j, ox, oy, oz, dx, dy, dz, a.min_t);
      if (t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  if (!on) return;
  const HitRec h = tri_winner_record(a.attrs, TRI_ATTR_COLS, best_t, best_i,
                                     ox, oy, oz, dx, dy, dz);
  write_record(h, i, n, a.out_f, a.out_i, a.out_hit);
}

extern "C" int wrt_hit_triangles(const TriArgs* a) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  tri_kernel<<<grid, kBlock, 0, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}
