// Kernel F: the scatter + respawn half of the split bounce, rows layout.
//
// Replaces the TPU kernel win32_raytracer_tpu/kernels/scatter_pallas.py
// (_scatter_respawn_kernel, reached through scatter_respawn_pallas): the
// material scatter with every reference quirk, the depth and Russian-
// roulette update and the camera respawn, with the ten hash_uniform01 draws
// made in the kernel.  It computes persistent.p_scatter_respawn_step of
// this package after a hit step, with its true divisions (the TPU kernel
// multiplies by reciprocals, scatter_pallas.py:13-22).  The camera is
// [n_frames, CAM_ROWS]; a multi-frame batch picks each lane's camera from
// its pixel row.
//
// What bounds it on an H100: memory.  Per lane it reads 61 bytes of state
// (radiance is not touched) and, where the lane is alive, 48 bytes of hit
// record, and writes 49; the arithmetic is a few hundred f32 operations,
// most of them only on lanes that scatter or respawn.  Design: one thread per
// lane, coalesced row reads, the record read only where the lane is alive;
// the per-lane code is common.cuh's draws and scatter_respawn, the very
// code kernel B runs after its hit.
#include "common.cuh"

using namespace wrt;

struct ScatterArgs {
  StateRows in;             // state in (radiance null: not touched)
  // hit record rows (ops/rows.HitRecordRows)
  const float* point;       // [3, n]
  const float* normal;      // [3, n]
  const int32_t* mat;       // [n]
  const float* albedo;      // [3, n]
  const float* fuzz;        // [n]
  const float* ior;         // [n]
  const float* cam;         // [n_frames, CAM_ROWS]
  // state out
  float* out_f;             // [10, n]: origin, direction, time, throughput
  int32_t* out_i;           // [2, n]: depth, sample
  uint8_t* out_alive;       // [n]
  long long n;
  uint32_t salt;
  int32_t step;
  StepParams p;
  void* stream;
};

template <bool LEAN>
__global__ void __launch_bounds__(kBlock) scatter_respawn_kernel(const ScatterArgs a) {
  const long long n = a.n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Lane st = load_lane(a.in, i, n);

  HitRec h = {};
  if (st.alive) {  // a dead lane's record is never read
    h.hit = true;
    h.px = a.point[i];
    h.py = a.point[n + i];
    h.pz = a.point[2 * n + i];
    h.nx = a.normal[i];
    h.ny = a.normal[n + i];
    h.nz = a.normal[2 * n + i];
    h.alr = a.albedo[i];
    h.alg = a.albedo[n + i];
    h.alb = a.albedo[2 * n + i];
    h.fuzz = a.fuzz[i];
    h.ior = a.ior[i];
    h.mat = a.mat[i];
  }

  float u[10];
  draws(a.salt, a.step, (uint32_t)i, u);
  scatter_respawn<LEAN>(a.p, a.cam, h, u, st);
  store_lane(st, i, n, false, a.out_f, a.out_i, a.out_alive);
}

extern "C" int wrt_scatter_respawn(const ScatterArgs* a, int lean) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)((a->n + kBlock - 1) / kBlock);
  cudaStream_t stream = (cudaStream_t)a->stream;
  if (lean)
    scatter_respawn_kernel<true><<<grid, kBlock, 0, stream>>>(*a);
  else
    scatter_respawn_kernel<false><<<grid, kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
