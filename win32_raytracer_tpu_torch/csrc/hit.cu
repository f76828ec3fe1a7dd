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
// the sphere; 488 active spheres for the final scene), not memory (28 bytes in and 57
// out per ray).  Design: one thread per ray; the block stages the sphere table
// through shared memory in tiles of kTile spheres, so each attribute is read
// from device memory once per block and broadcast from shared memory to all
// of its threads; the winner's attributes are fetched by index once.
#include "common.cuh"

using namespace wrt;

struct HitArgs {
  const float* origin;     // [3, n]
  const float* direction;  // [3, n]
  const float* time;       // [1, n]
  const float* attrs;      // [n_spheres, ATTR_COLS]
  const uint8_t* active;   // [n_spheres]
  float* out_f;            // [12, n]: t, point, normal, albedo, fuzz, ior
  int32_t* out_i;          // [2, n]: idx, mat
  uint8_t* out_hit;        // [n]
  long long n;
  int n_spheres;
  float min_t;
  void* stream;
};

__global__ void __launch_bounds__(kBlock) hit_kernel(const HitArgs a) {
  __shared__ SphereTile sh;
  const long long n = a.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n;
  const long long k = on ? i : 0;  // idle threads still help stage tiles
  const float ox = a.origin[k], oy = a.origin[n + k], oz = a.origin[2 * n + k];
  const float dx = a.direction[k], dy = a.direction[n + k],
              dz = a.direction[2 * n + k];
  const float tm = a.time[k];
  const float aa = dx * dx + dy * dy + dz * dz;

  float best_t;
  int best_i;
  sweep_spheres(a.attrs, a.active, a.n_spheres, sh, on, ox, oy, oz, dx, dy,
                dz, tm, aa, a.min_t, best_t, best_i);
  if (!on) return;

  const HitRec h = winner_record(a.attrs, best_t, best_i, ox, oy, oz, dx, dy,
                                 dz, tm);
  write_record(h, i, n, a.out_f, a.out_i, a.out_hit);
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
