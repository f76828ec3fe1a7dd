// Kernel D: nearest two-sided triangle hit through the Morton-tile grid,
// rows layout.
//
// Replaces the TPU kernels win32_raytracer_tpu/kernels/tri_grid_rows.py
// (_tri_grid_kernel_mxu, the default, and _tri_grid_kernel, the exact
// variant), the triangle pass of meshes of >= 512 triangles (BASELINE
// config 4, mesh20k).  Both compute one function; this kernel computes it in
// exact f32 (ops/hit_tri.py's pair test), so it is held to the exact
// variant and the plain sweep, not to the MXU variant's split-bf16 flips.
//
// Semantics kept from the reference: each ray block of `ray_block` lanes
// sweeps only the tiles its schedule row lists (tri_accel's conservative
// block mask), front to back by the tile entry bound; the sweep stops early
// once no lane's min(best t, segment end) reaches the next tile's bound
// (_sweep_scheduled); a tile no lane's capped segment touches is skipped
// (the any-touch slab gate against the quantised, expanded tile box, with
// the reference's slop: _any_touch); strict < across tiles and the lowest
// row within a tile; the winner is carried as (t, row) and its attributes
// are read once after the sweep.
//
// What bounds it on an H100: the pair tests the schedule leaves (46 f32
// multiplies, adds and a division plus 6 compares each), a data-dependent
// count that chip_smoke.py reads back through `stats`.
// Design: the reference keeps the whole tile table in VMEM and walks the
// blocks in order; here a CTA of up to kThreads threads takes one slice of
// a block's lanes (no state carries between CTAs), stages each scheduled
// tile through shared memory kTriTile rows at a time, decides the any-touch
// skip for the CTA (__syncthreads_or: skip the staging) and again per warp
// (__any_sync: skip the arithmetic), and takes the early exit per CTA.  A
// per-CTA decision is stricter than the reference's per-block one and still
// exact: a skipped tile cannot hold a hit nearer than a lane's
// min(best t, segment end).  Schedules of any length and tiles of any
// height run, so no shared-memory budget has to split the batch.
#include "common.cuh"

using namespace wrt;

constexpr int kThreads = 256;                  // lanes per CTA (at most)
constexpr int kGridCols = TRI_ATTR_COLS + 1;   // tri_accel.TRI_GRID_COLS
constexpr float kEpsDir = 1e-12f;              // tri_grid_rows._EPS_DIR
constexpr float kSlopRel = 1e-4f;              // tri_grid_rows._SKIP_SLOP_REL
constexpr float kSlopAbs = 1e-5f;              // tri_grid_rows._SKIP_SLOP_ABS

struct TriGridArgs {
  const float* rays;      // [7, n]: origin, direction, segment end (cap)
  const float* attrs;     // [n_tiles * st, kGridCols], tile-major
  const int32_t* sched;   // [n / ray_block, 1 + n_tiles]: count, tile ids
  const float* tlo;       // [n / ray_block, n_tiles + 1]: entry bounds
  const float* boxes;     // [n_tiles, 6]: x0, x1, y0, y1, z0, z1
  float* out_f;           // [12, n]
  int32_t* out_i;         // [2, n]
  uint8_t* out_hit;       // [n]
  unsigned long long* stats;  // [2]: tiles staged, pair tests; or null
  long long n;            // lanes, a multiple of ray_block
  int n_tiles;
  int st;                 // rows per tile
  int ray_block;
  float min_t;
  void* stream;
};

// 1/d with +-eps for near-zero components (tri_grid_rows._safe_inv).
__device__ __forceinline__ float safe_inv(float d) {
  const float dn = fabsf(d) < kEpsDir ? (d < 0.0f ? -kEpsDir : kEpsDir) : d;
  return 1.0f / dn;
}

// Does the segment [t_lo, t_hi] slab-intersect the box
// (tri_grid_rows._any_touch, one lane)?
__device__ __forceinline__ bool any_touch(const float* __restrict__ box,
                                          const float o[3], const float inv[3],
                                          float t_lo, float t_hi) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float ta = (box[2 * ax] - o[ax]) * inv[ax];
    const float tb = (box[2 * ax + 1] - o[ax]) * inv[ax];
    t_lo = fmaxf(t_lo, fminf(ta, tb));
    t_hi = fminf(t_hi, fmaxf(ta, tb));
  }
  return t_lo <= t_hi * (1.0f + kSlopRel) + kSlopAbs;
}

template <bool EARLY_EXIT, bool ANY_SKIP>
__global__ void __launch_bounds__(kThreads) tri_grid_kernel(const TriGridArgs a) {
  __shared__ TriTile sh;
  const int per_block = (a.ray_block + blockDim.x - 1) / blockDim.x;
  const long long blk = blockIdx.x / per_block;           // ray block
  const int off = (blockIdx.x % per_block) * blockDim.x + threadIdx.x;
  const bool on = off < a.ray_block;
  const long long n = a.n;
  const long long i = blk * a.ray_block + (on ? off : 0);
  const float o[3] = {a.rays[i], a.rays[n + i], a.rays[2 * n + i]};
  const float d[3] = {a.rays[3 * n + i], a.rays[4 * n + i], a.rays[5 * n + i]};
  const float cap = a.rays[6 * n + i];
  const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};

  const int32_t* sched = a.sched + blk * (a.n_tiles + 1);
  const float* tlo = a.tlo + blk * (a.n_tiles + 1);
  const int count = sched[0];
  float best_t = kNoHit;
  long long best_row = -1;
  unsigned long long tiles = 0, pairs = 0;

  for (int j = 0; j < count; ++j) {
    const int tile = sched[1 + j];
    bool touch = on;
    if (ANY_SKIP)
      touch = on && any_touch(a.boxes + 6 * tile, o, inv, a.min_t,
                              fminf(cap, best_t));
    // Uniform over the CTA: every thread reaches each barrier below.
    if (!ANY_SKIP || __syncthreads_or(touch)) {
      const bool warp_on = __any_sync(0xffffffffu, touch);
      const long long row0 = (long long)tile * a.st;
      for (int r0 = 0; r0 < a.st; r0 += kTriTile) {
        const int cnt = min(kTriTile, a.st - r0);
        __syncthreads();  // the previous rows are consumed
        stage_tris(a.attrs, kGridCols, row0 + r0, cnt, sh);
        __syncthreads();
        if (!(warp_on && on)) continue;
        for (int r = 0; r < cnt; ++r) {
          const float t = tri_pair_t(sh, r, o[0], o[1], o[2], d[0], d[1],
                                     d[2], a.min_t);
          if (t < best_t) {
            best_t = t;
            best_row = row0 + r0 + r;
          }
        }
      }
      tiles += 1;
      if (warp_on && on) pairs += a.st;
    }
    if (EARLY_EXIT) {
      const bool reach = on && fminf(best_t, cap) >= tlo[j + 1];
      if (!__syncthreads_or(reach)) break;
    }
  }

  if (a.stats != nullptr) {
    for (int s = 16; s > 0; s >>= 1)
      pairs += __shfl_down_sync(0xffffffffu, pairs, s);
    if ((threadIdx.x & 31) == 0) atomicAdd(a.stats + 1, pairs);
    if (threadIdx.x == 0) atomicAdd(a.stats, tiles);
  }
  if (!on) return;
  const HitRec h = tri_winner_record(a.attrs, kGridCols, best_t, best_row,
                                     o[0], o[1], o[2], d[0], d[1], d[2]);
  write_record(h, i, n, a.out_f, a.out_i, a.out_hit);
}

extern "C" int wrt_hit_tri_grid(const TriGridArgs* a, int early_exit,
                                int any_skip) {
  if (a->n <= 0) return 0;
  const int threads = a->ray_block < kThreads ? ((a->ray_block + 31) / 32) * 32
                                              : kThreads;
  const long long per_block = (a->ray_block + threads - 1) / threads;
  const unsigned grid = (unsigned)((a->n / a->ray_block) * per_block);
  cudaStream_t s = (cudaStream_t)a->stream;
  if (early_exit && any_skip)
    tri_grid_kernel<true, true><<<grid, threads, 0, s>>>(*a);
  else if (early_exit)
    tri_grid_kernel<true, false><<<grid, threads, 0, s>>>(*a);
  else if (any_skip)
    tri_grid_kernel<false, true><<<grid, threads, 0, s>>>(*a);
  else
    tri_grid_kernel<false, false><<<grid, threads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
