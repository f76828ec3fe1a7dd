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
// What bounds it on an H100: the S pair tests per lane (23 f32 multiplies,
// adds and subtractions and a compare each, as in hit.cu: 0.687 ms at the
// headline's 3,932,160 lanes over 67 TFLOP/s, twice that under
// --fmad=false), against 53 bytes read and 70 written per lane.
// Design: kernel A's packed sweep (csrc/common.cuh sweep_packed: the block
// stages the active spheres packed, a branch-free disc >= 0 mask pass per
// 32 spheres, then the roots of the set bits), two lanes a thread on a
// batch that gives every SM a block of 512, else one
// (kernels/hit.rays_per_thread); then the record is written in the layout
// kernel A writes (csrc/common.cuh write_record) and the sky term is added
// in registers.  Every lane is swept, dead ones too, so the record matches
// the plain sweep's everywhere; a dead lane's radiance and alive flag pass
// unchanged.
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

// R lanes per thread, lanes blockIdx.x * kBlock * R + r * kBlock +
// threadIdx.x (r < R).
template <int R>
__global__ void __launch_bounds__(kBlock) hit_sky_kernel(const HitSkyArgs a) {
  __shared__ PackedTile sh;
  const long long n = a.n;
  const long long i0 = (long long)blockIdx.x * (kBlock * R) + threadIdx.x;
  Rays<R> ry;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + (long long)r * kBlock;
    load_ray<Layout::ROWS, R>(a.origin, a.direction, a.time, i < n ? i : 0, n,
                              r, ry);
  }
  float best_t[R];
  int best_i[R];
  sweep_packed<R>(a.attrs, a.active, a.n_spheres, sh, i0 < n, ry, a.min_t,
                  best_t, best_i);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + (long long)r * kBlock;
    if (i >= n) break;
    const HitRec h = winner_record(a.attrs, best_t[r], best_i[r], ry.ox[r],
                                   ry.oy[r], ry.oz[r], ry.dx[r], ry.dy[r],
                                   ry.dz[r], ry.tm[r]);
    write_record(h, i, n, a.out_f, a.out_i, a.out_hit);

    float thr[3], rad[3];
    for (int c = 0; c < 3; ++c) {
      thr[c] = a.throughput[c * n + i];
      rad[c] = a.radiance[c * n + i];
    }
    bool alive = a.alive[i] != 0;
    hit_sky(h.hit, ry.dx[r], ry.dy[r], ry.dz[r], thr, rad, alive);
    for (int c = 0; c < 3; ++c) a.out_rad[c * n + i] = rad[c];
    a.out_alive[i] = alive ? 1 : 0;
  }
}

// rays: 1 or 2 lanes per thread (kernels/hit.py rays_per_thread).
extern "C" int wrt_hit_sky(const HitSkyArgs* a, int rays) {
  return launch_rays(a, rays, hit_sky_kernel<1>, hit_sky_kernel<2>);
}
