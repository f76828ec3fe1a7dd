// Kernel B: one whole bounce of the persistent scheduler (hit + sky +
// scatter + respawn) for a batch of lanes.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/bounce_pallas.py
// (_bounce_kernel, reached through p_bounce_fused), which chains
// hit_pallas_v7.hit_sky_values and scatter_pallas.scatter_respawn_values.
// It computes persistent.p_bounce_step of this package: the exact f32
// sphere sweep of ops/hit.py, then ops/rows.py's scatter with every
// reference quirk, Russian roulette and the respawn of a new camera sample,
// with the ten per-lane draws of core/rng.py hash_uniform01 bit for bit.
//
// What bounds it on an H100: the sphere sweep, S pair tests per live lane
// (27 f32 operations each, as in hit.cu), against 73 bytes of state read and 61 written
// per lane.  Design: one thread per lane; each lane's state is read
// once and its 8 output rows written once, and the hit record stays in
// registers; sphere tiles are staged through shared memory as in hit.cu;
// dead lanes skip the sweep (they only help stage tiles) since their hit
// record is never read.
#include "common.cuh"

using namespace wrt;

struct BounceArgs {
  // state in, rows layout
  const float* origin;      // [3, n]
  const float* direction;   // [3, n]
  const float* time;        // [1, n]
  const float* throughput;  // [3, n]
  const float* radiance;    // [3, n]
  const int32_t* depth;     // [1, n]
  const int32_t* sample;    // [1, n]
  const int32_t* pixel;     // [1, n]
  const uint8_t* alive;     // [1, n]
  const int32_t* s_base;    // [1, n]
  const int32_t* s_quota;   // [1, n]
  // scene and camera
  const float* attrs;       // [n_spheres, ATTR_COLS]
  const uint8_t* active;    // [n_spheres]
  const float* cam;         // [CAM_ROWS]
  // state out
  float* out_f;             // [13, n]: origin, direction, time, throughput, radiance
  int32_t* out_i;           // [2, n]: depth, sample
  uint8_t* out_alive;       // [n]
  long long n;
  int n_spheres;
  uint32_t salt;
  int32_t step;
  float min_t;
  StepParams p;
  void* stream;
};

template <bool LEAN>
__global__ void __launch_bounds__(kBlock) bounce_kernel(const BounceArgs a) {
  __shared__ SphereTile sh;
  const long long n = a.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n;
  const long long k = on ? i : 0;  // idle threads still help stage tiles

  Lane st;
  for (int c = 0; c < 3; ++c) {
    st.o[c] = a.origin[c * n + k];
    st.d[c] = a.direction[c * n + k];
    st.thr[c] = a.throughput[c * n + k];
    st.rad[c] = a.radiance[c * n + k];
  }
  st.tm = a.time[k];
  st.depth = a.depth[k];
  st.sample = a.sample[k];
  st.pixel = a.pixel[k];
  st.alive = a.alive[k] != 0;
  st.s_base = a.s_base[k];
  st.s_quota = a.s_quota[k];

  const float aa = st.d[0] * st.d[0] + st.d[1] * st.d[1] + st.d[2] * st.d[2];
  float best_t;
  int best_i;
  sweep_spheres(a.attrs, a.active, a.n_spheres, sh, on && st.alive, st.o[0],
                st.o[1], st.o[2], st.d[0], st.d[1], st.d[2], st.tm, aa,
                a.min_t, best_t, best_i);
  if (!on) return;

  const HitRec h = winner_record(a.attrs, best_t, best_i, st.o[0], st.o[1],
                                 st.o[2], st.d[0], st.d[1], st.d[2], st.tm);
  hit_sky(h.hit, st.d[0], st.d[1], st.d[2], st.thr, st.rad, st.alive);

  float u[10];
  draws(a.salt, a.step, (uint32_t)i, u);
  scatter_respawn<LEAN>(a.p, a.cam, h, u, st);

  for (int c = 0; c < 3; ++c) {
    a.out_f[c * n + i] = st.o[c];
    a.out_f[(3 + c) * n + i] = st.d[c];
    a.out_f[(7 + c) * n + i] = st.thr[c];
    a.out_f[(10 + c) * n + i] = st.rad[c];
  }
  a.out_f[6 * n + i] = st.tm;
  a.out_i[i] = st.depth;
  a.out_i[n + i] = st.sample;
  a.out_alive[i] = st.alive ? 1 : 0;
}

extern "C" int wrt_bounce(const BounceArgs* a, int lean) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  cudaStream_t stream = (cudaStream_t)a->stream;
  if (lean)
    bounce_kernel<true><<<grid, kBlock, 0, stream>>>(*a);
  else
    bounce_kernel<false><<<grid, kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
