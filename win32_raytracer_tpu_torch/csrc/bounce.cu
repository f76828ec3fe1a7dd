// Kernel B: one whole bounce of the persistent scheduler (hit + sky +
// scatter + respawn) for a batch of lanes, and its k-bounce variant.
//
// bounce_kernel replaces the TPU kernel
// win32_raytracer_tpu/kernels/bounce_pallas.py (_bounce_kernel, reached
// through p_bounce_fused), which chains hit_pallas_v7.hit_sky_values and
// scatter_pallas.scatter_respawn_values.  It computes persistent.p_bounce_step
// of this package: the exact f32 sphere sweep of ops/hit.py, then
// ops/rows.py's scatter with every reference quirk, Russian roulette and the
// respawn of a new camera sample, with the ten per-lane draws of core/rng.py
// hash_uniform01 bit for bit.  The camera is [n_frames, CAM_ROWS]: a
// multi-frame batch picks each lane's camera from its pixel row.
//
// bounce_multi_kernel replaces p_bounce_multi_fused (bounce_pallas.py:186),
// which unrolls k fused bounces into one program: here one launch runs the
// k bounces at steps step..step+k-1 with each lane's state in registers, and
// writes it once.  That is exact: with no compaction between them a lane's
// draws key on (salt, step, lane index) as in k launches of bounce_kernel,
// and no lane reads another's state.
//
// What bounds them on an H100: instruction issue in the sphere sweep, S
// pair tests per live lane and bounce (as in hit.cu), against 73 bytes of
// state read and 61 written per lane (once per launch, whatever k is).  At
// the headline's 3,932,160 lanes (3,840,000 live) the bound is 0.671 ms
// (23 multiplies and adds and a compare per pair test over 67 TFLOP/s),
// the --fmad=false floor of the unfused operations 1.343 ms; kernel B
// takes 2.03 ms, where the sweep it replaced (46 instructions per pair
// test against 28 now) took 3.09 (PERF.md section 6).
// Design: one thread per lane and the packed sweep of hit.cu
// (csrc/common.cuh sweep_packed); the hit record stays in registers; dead
// lanes skip the sweep (they only help stage tiles) since their hit record
// is never read.  (Two lanes per thread read slower on the headline's
// second bounce.)
//
// Counts: launched with a `stats` buffer (the port passes one only while a
// render records), each bounce adds its lanes whose path is alive when the
// bounce starts to stats[0] and the paths the roulette ends to stats[1],
// one atomic a warp each (csrc/common.cuh warp_count).  The counting
// instantiation is a template of its own (STATS), so the one launched
// without a buffer compiles to the kernel with no counts.
#include "common.cuh"

using namespace wrt;

struct BounceArgs {
  StateRows in;             // state in, rows layout
  // scene and camera
  const float* attrs;       // [n_spheres, ATTR_COLS]
  const uint8_t* active;    // [n_spheres]
  const float* cam;         // [n_frames, CAM_ROWS]
  // state out
  float* out_f;             // [13, n]: origin, direction, time, throughput, radiance
  int32_t* out_i;           // [2, n]: depth, sample
  uint8_t* out_alive;       // [n]
  long long n;
  int n_spheres;
  uint32_t salt;
  int32_t step;             // the (first) bounce's step index
  float min_t;
  StepParams p;
  unsigned long long* stats;  // [2]: live lanes swept, roulette kills; or null
  void* stream;
};

// One bounce of lane i (every thread of the block calls it: the sweep
// stages tiles behind __syncthreads).
template <bool LEAN, bool STATS>
__device__ __forceinline__ void bounce_lane(const BounceArgs& a, PackedTile& sh,
                                            bool on, long long i, int32_t step,
                                            Lane& st) {
  Rays<1> ry;
  ry.ox[0] = st.o[0];
  ry.oy[0] = st.o[1];
  ry.oz[0] = st.o[2];
  ry.dx[0] = st.d[0];
  ry.dy[0] = st.d[1];
  ry.dz[0] = st.d[2];
  ry.tm[0] = st.tm;
  ry.a[0] = st.d[0] * st.d[0] + st.d[1] * st.d[1] + st.d[2] * st.d[2];
  float best_t[1];
  int best_i[1];
  sweep_packed<1>(a.attrs, a.active, a.n_spheres, sh, on && st.alive, ry,
                  a.min_t, best_t, best_i);
  if (STATS) warp_count(a.stats, on && st.alive);
  if (!on) return;

  const HitRec h = winner_record(a.attrs, best_t[0], best_i[0], st.o[0],
                                 st.o[1], st.o[2], st.d[0], st.d[1], st.d[2],
                                 st.tm);
  hit_sky(h.hit, st.d[0], st.d[1], st.d[2], st.thr, st.rad, st.alive);

  float u[10];
  draws(a.salt, step, (uint32_t)i, u);
  const bool rr_kill = scatter_respawn<LEAN>(a.p, a.cam, h, u, st);
  if (STATS) warp_count(a.stats + 1, rr_kill);
}

template <bool LEAN, bool STATS>
__global__ void __launch_bounds__(kBlock) bounce_kernel(const BounceArgs a) {
  __shared__ PackedTile sh;
  const long long n = a.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n;
  Lane st = load_lane(a.in, on ? i : 0, n);  // idle threads help stage tiles
  bounce_lane<LEAN, STATS>(a, sh, on, i, a.step, st);
  if (on) store_lane(st, i, n, true, a.out_f, a.out_i, a.out_alive);
}

template <bool LEAN, bool STATS>
__global__ void __launch_bounds__(kBlock) bounce_multi_kernel(const BounceArgs a,
                                                              int k) {
  __shared__ PackedTile sh;
  const long long n = a.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n;
  Lane st = load_lane(a.in, on ? i : 0, n);
  for (int b = 0; b < k; ++b)
    bounce_lane<LEAN, STATS>(a, sh, on, i, a.step + b, st);
  if (on) store_lane(st, i, n, true, a.out_f, a.out_i, a.out_alive);
}

template <bool STATS>
static void launch_bounce(const BounceArgs* a, bool lean, unsigned grid,
                          cudaStream_t stream) {
  if (lean)
    bounce_kernel<true, STATS><<<grid, kBlock, 0, stream>>>(*a);
  else
    bounce_kernel<false, STATS><<<grid, kBlock, 0, stream>>>(*a);
}

template <bool STATS>
static void launch_bounce_multi(const BounceArgs* a, bool lean, int k,
                                unsigned grid, cudaStream_t stream) {
  if (lean)
    bounce_multi_kernel<true, STATS><<<grid, kBlock, 0, stream>>>(*a, k);
  else
    bounce_multi_kernel<false, STATS><<<grid, kBlock, 0, stream>>>(*a, k);
}

extern "C" int wrt_bounce(const BounceArgs* a, int lean) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  cudaStream_t stream = (cudaStream_t)a->stream;
  if (a->stats != nullptr)
    launch_bounce<true>(a, lean != 0, grid, stream);
  else
    launch_bounce<false>(a, lean != 0, grid, stream);
  return (int)cudaGetLastError();
}

extern "C" int wrt_bounce_multi(const BounceArgs* a, int lean, int k) {
  if (a->n <= 0 || k <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  cudaStream_t stream = (cudaStream_t)a->stream;
  if (a->stats != nullptr)
    launch_bounce_multi<true>(a, lean != 0, k, grid, stream);
  else
    launch_bounce_multi<false>(a, lean != 0, k, grid, stream);
  return (int)cudaGetLastError();
}
