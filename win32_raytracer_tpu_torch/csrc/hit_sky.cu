// Kernel E: the hit + sky half of the split bounce, rows layout.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/hit_pallas_v7.py
// (_hit_sky_kernel, reached through p_hit_sky_step): the sphere sweep, the
// winner's record (point, normal, material rows) and the miss-to-sky
// radiance and alive update, in one program.  It computes
// persistent.p_hit_step of this package with the plain sweep: ops/hit.py's
// exact f32 pair test (not v7's split-bf16 quadratic and its winner flips),
// then persistent._hit_core's sky term.  Followed by kernel F (scatter.cu)
// it gives, bit for bit, what kernel B (bounce.cu) gives on the same state.
//
// What bounds it on an H100: the S pair tests per lane (27 f32 operations
// each, as in hit.cu), against 53 bytes read and 70 written per lane.
// Design: hit.cu's sweep (one thread per lane, sphere tiles staged through
// shared memory), then the record is written in the layout kernel A writes
// (csrc/common.cuh write_record) and the sky term is added in registers.
// Every lane is swept, dead ones too, so the record matches the plain
// sweep's everywhere; a dead lane's radiance and alive flag pass unchanged.
#include "common.cuh"

using namespace wrt;

struct HitSkyArgs {
  const float* origin;      // [3, n]
  const float* direction;   // [3, n]
  const float* time;        // [1, n]
  const float* throughput;  // [3, n]
  const float* radiance;    // [3, n]
  const uint8_t* alive;     // [n]
  const float* attrs;       // [n_spheres, ATTR_COLS]
  const uint8_t* active;    // [n_spheres]
  float* out_f;             // [12, n]: t, point, normal, albedo, fuzz, ior
  int32_t* out_i;           // [2, n]: idx, mat
  uint8_t* out_hit;         // [n]
  float* out_rad;           // [3, n]
  uint8_t* out_alive;       // [n]
  long long n;
  int n_spheres;
  float min_t;
  void* stream;
};

__global__ void __launch_bounds__(kBlock) hit_sky_kernel(const HitSkyArgs a) {
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

  float thr[3], rad[3];
  for (int c = 0; c < 3; ++c) {
    thr[c] = a.throughput[c * n + i];
    rad[c] = a.radiance[c * n + i];
  }
  bool alive = a.alive[i] != 0;
  hit_sky(h.hit, dx, dy, dz, thr, rad, alive);
  for (int c = 0; c < 3; ++c) a.out_rad[c * n + i] = rad[c];
  a.out_alive[i] = alive ? 1 : 0;
}

extern "C" int wrt_hit_sky(const HitSkyArgs* a) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  hit_sky_kernel<<<grid, kBlock, 0, (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}
