// Kernel I: the sphere grid, in the rows layout (persistent scheduler) and
// the column layout, as two launches: the schedule kernel (pass A over the
// globals, the footprint mask and the block schedule) and the sweep kernel
// (pass B over the scheduled tiles and its merge into pass A's record).
//
// Replaces the TPU kernels win32_raytracer_tpu/kernels/hit_grid_rows.py:98
// (_grid_kernel_rows, the rows instance; accel="grid" on a plain sphere
// scene) and win32_raytracer_tpu/kernels/experimental/hit_grid.py:50
// (_grid_kernel, the column instance), and the XLA prelude around them
// (hit_grid_rows.py:166-203 and :215, experimental/hit_grid.py:119-148 and
// :160: pass A, footprint_block_mask, the argsort schedule).  Both compute
// one function: for each lane, the nearest root with t > min_t and r != 0
// among the rows of the tiles its ray block's schedule lists, tiles in
// ascending id with strict < across tiles and the lowest row within one,
// merged with pass A on (t, original index), the reference's merge_best.
// The TPU kernels fetch the winner with a one-hot MXU contraction; here the
// winner is carried as (t, row) and its 17-column row read once at the end.
//
// The schedule kernel takes one ray block per CTA, looping over its lanes:
// pass A by the packed sweep (the globals with r != 0, kBlock rows a
// stage, the arithmetic of kernel A), its record written where kernel A
// writes it; each lane's footprint op for op as accel._footprint_mask;
// the block's min and max (exact in any order); then per tile the overlap,
// and the scheduled ids written ascending by a ballot and prefix sum (the
// unscheduled ones after them), the [NB, 1 + T] row block_schedule's
// argsort gives.  Rays past n are the reference's filler rays, made here.
//
// The sweep kernel: a CTA of kBlock threads, two rays each, takes 512
// lanes of a ray block and stages the rows of its scheduled tiles whose
// r != 0 into a PackedTile, ascending by tile and then by row, kBlock
// candidate rows (about ten of the headline's 24-row tiles) per stage, each
// carrying its table row; the packed sweep's mask-then-root pass
// (sweep_packed_tile) sweeps them.  The ascending staged order with
// strict < keeps the plain sweep's winner.
//
// What bounds it on an H100: the pair tests, the schedule's (24 f32
// operations each, csrc/common.cuh sweep_packed_tile; chip_smoke.py reads
// them back through `stats`) and pass A's (lanes x active globals); the
// brute sweep would test every sphere (488 for the final scene).
#include "common.cuh"

using namespace wrt;

constexpr int kThreads = kBlock;                // threads per CTA
constexpr int kGridAttrCols = ATTR_COLS + 1;    // accel.GRID_ATTR_COLS
constexpr float kBig = 1e8f;                    // accel._BIG
constexpr float kEps = 1e-12f;                  // accel._EPS

struct GridArgs {
  const float* origin;     // [3, n] (ROWS) or [n, 3] (COLS)
  const float* direction;  // as origin
  const float* time;       // [n]
  const float* glob;       // [n_glob, ATTR_COLS]: the globals (pass A)
  const float* attrs;      // [n_tiles * st, kGridAttrCols], tile-major
  const float* boxes;      // [n_tiles, 4]: x_lo, x_hi, z_lo, z_hi
  const float* y_slab;     // [2]: y_lo, y_hi of the gridded spheres
  int32_t* sched;          // [nb, 1 + n_tiles]: count, tile ids
  float* out_f;            // pass A's record, then the merged record:
  int32_t* out_i;          //   [12, n] / [2, n] (ROWS) or [n, 12] / [n, 2]
  uint8_t* out_hit;        // [n]
  unsigned long long* stats;  // [2]: CTA tiles, pair tests; or null
  float* carry_t;          // [nb * ray_block]: pass A's t between stages,
  int32_t* carry_i;        //   and its glob row; null for one stage
  long long n;             // lanes
  long long nb;            // ray blocks, ceil(n / ray_block)
  int n_glob;
  int n_tiles;
  int st;                  // rows per tile
  int ray_block;
  float min_t;
  void* stream;
};

// Lane i's ray into slot r of `ry`, or past n the filler ray
// accel.pad_rays_rows (ROWS: o = (0, -1e9, 0), d = (0, 0, 1)) or
// pad_rays_cols (COLS: d = 0) makes.
template <Layout L, int R>
__device__ __forceinline__ void load_lane(const GridArgs& a, long long i, int r,
                                          Rays<R>& ry) {
  if (i < a.n) {
    load3<L>(a.origin, i, a.n, ry.ox[r], ry.oy[r], ry.oz[r]);
    load3<L>(a.direction, i, a.n, ry.dx[r], ry.dy[r], ry.dz[r]);
    ry.tm[r] = a.time[i];
  } else {
    ry.ox[r] = 0.0f;
    ry.oy[r] = -1e9f;
    ry.oz[r] = 0.0f;
    ry.dx[r] = 0.0f;
    ry.dy[r] = 0.0f;
    ry.dz[r] = L == Layout::ROWS ? 1.0f : 0.0f;
    ry.tm[r] = 0.0f;
  }
  ry.a[r] = ry.dx[r] * ry.dx[r] + ry.dy[r] * ry.dy[r] + ry.dz[r] * ry.dz[r];
}

constexpr int kRays = 2;  // rays per sweep-kernel thread

// One pass of pass A over the block's lanes against the `cnt` globals
// staged in `sh`.  CARRY_IN: each lane starts from the (t, row) of the
// earlier stages, else from no hit; LAST: the lane's record is written and
// its footprint folded into fp, else its (t, row) is carried on.  Without
// a barrier, so warps run ahead into the next lanes' loads.
template <Layout L, bool CARRY_IN, bool LAST>
__device__ __forceinline__ void pass_a_lanes(const GridArgs& a, long long blk,
                                             const PackedTile& sh, int cnt,
                                             bool uniform, float fp[4]) {
  const float y_lo = a.y_slab[0], y_hi = a.y_slab[1];
  for (int base = 0; base < a.ray_block; base += kThreads) {
    const int off = base + threadIdx.x;
    const bool on = off < a.ray_block;
    const long long i = blk * a.ray_block + (on ? off : 0);
    Rays<1> ry;
    load_lane<L, 1>(a, i, 0, ry);
    float best_t = kNoHit;
    int best_i = -1;
    if (!on) continue;
    if (CARRY_IN) {
      best_t = a.carry_t[i];
      best_i = a.carry_i[i];
    }
    if (cnt > 0) {  // chunks of 8: the globals are few
      if (uniform)
        sweep_packed_tile<1, true, 8>(sh, cnt, ry, a.min_t, &best_t, &best_i);
      else
        sweep_packed_tile<1, false, 8>(sh, cnt, ry, a.min_t, &best_t, &best_i);
    }
    if (!LAST) {
      a.carry_t[i] = best_t;
      a.carry_i[i] = best_i;
      continue;
    }
    const float ox = ry.ox[0], oy = ry.oy[0], oz = ry.oz[0];
    const float dx = ry.dx[0], dy = ry.dy[0], dz = ry.dz[0];
    if (i < a.n) {
      const HitRec h = winner_record(a.glob, best_t, best_i, ox, oy, oz, dx,
                                     dy, dz, ry.tm[0]);
      store_record<L>(h, i, a.n, a.out_f, a.out_i, a.out_hit);
    }
    // accel._footprint_mask, one lane.
    const float dy_safe = fabsf(dy) < kEps ? (dy < 0.0f ? -kEps : kEps) : dy;
    const float ta = (y_lo - oy) / dy_safe;
    const float tb = (y_hi - oy) / dy_safe;
    const float lo_t = tmax(tmin(ta, tb), a.min_t);
    const float hi_t = tmin(tmax(ta, tb), tmin(best_t, kBig));
    const bool empty = lo_t > hi_t;
    const float xa = ox + lo_t * dx, xb = ox + hi_t * dx;
    const float za = oz + lo_t * dz, zb = oz + hi_t * dz;
    fp[0] = tmin(fp[0], empty ? kBig : tmin(xa, xb));
    fp[1] = tmax(fp[1], empty ? -kBig : tmax(xa, xb));
    fp[2] = tmin(fp[2], empty ? kBig : tmin(za, zb));
    fp[3] = tmax(fp[3], empty ? -kBig : tmax(za, zb));
  }
}

// STAGED: more than kBlock global rows.  Its own kernel, so that the
// registers its carried passes need do not lower the occupancy of the
// one-stage kernel (every built-in scene), whose lane loop is
// latency-bound on the column layout's strided loads.
template <Layout L, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    hit_grid_schedule_kernel(const GridArgs a) {
  __shared__ PackedTile sh;
  __shared__ float red[kThreads / 32][4];
  const long long blk = blockIdx.x;
  // The block's footprint box: x min, x max, z min, z max.
  float fp[4] = {f32_inf(), -f32_inf(), f32_inf(), -f32_inf()};
  // Pass A's globals, kBlock rows a stage.  A grid of at most kBlock
  // global rows (every built-in scene: final has 8) is one stage, staged
  // once for all the block's lanes.  More rows take one more pass over
  // the block's lanes per further stage, each lane's (t, row) carried
  // between passes in the carry buffers (filler lanes too, which have no
  // record); the stages run ascending with strict <, so the lowest row
  // keeps ties, as _sweep over the whole table does, and the last pass
  // writes the record and the footprint from the final winner.
  if constexpr (!STAGED) {
    auto glob_row = [&](int k, int& row) {
      row = k;
      return a.glob[(size_t)k * ATTR_COLS + A_RADIUS] != 0.0f;
    };
    bool uniform = false;
    const int cnt = stage_packed_rows(a.glob, ATTR_COLS, a.n_glob, glob_row, sh, uniform);
    pass_a_lanes<L, false, true>(a, blk, sh, cnt, uniform, fp);
  } else {
    const int n_stages = (a.n_glob + kBlock - 1) / kBlock;
    for (int stage = 0; stage < n_stages; ++stage) {
      const int row0 = stage * kBlock;
      auto glob_row = [&](int k, int& row) {
        row = row0 + k;
        return a.glob[(size_t)row * ATTR_COLS + A_RADIUS] != 0.0f;
      };
      bool uniform = false;
      const int cnt = stage_packed_rows(a.glob, ATTR_COLS, min(kBlock, a.n_glob - row0),
                                        glob_row, sh, uniform);
      if (stage == 0)
        pass_a_lanes<L, false, false>(a, blk, sh, cnt, uniform, fp);
      else if (stage < n_stages - 1)
        pass_a_lanes<L, true, false>(a, blk, sh, cnt, uniform, fp);
      else
        pass_a_lanes<L, true, true>(a, blk, sh, cnt, uniform, fp);
    }
  }
  for (int s = 16; s > 0; s >>= 1) {
    fp[0] = tmin(fp[0], __shfl_xor_sync(0xffffffffu, fp[0], s));
    fp[1] = tmax(fp[1], __shfl_xor_sync(0xffffffffu, fp[1], s));
    fp[2] = tmin(fp[2], __shfl_xor_sync(0xffffffffu, fp[2], s));
    fp[3] = tmax(fp[3], __shfl_xor_sync(0xffffffffu, fp[3], s));
  }
  if ((threadIdx.x & 31) == 0)
    for (int c = 0; c < 4; ++c) red[threadIdx.x >> 5][c] = fp[c];
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) {
    fp[0] = tmin(fp[0], red[w][0]);
    fp[1] = tmax(fp[1], red[w][1]);
    fp[2] = tmin(fp[2], red[w][2]);
    fp[3] = tmax(fp[3], red[w][3]);
  }

  // The schedule row: the count, the overlapping tiles ascending, then the
  // others ascending (block_schedule's argsort of where(mask, id, T + id)).
  auto overlap = [&](int t) {
    const float* b = a.boxes + 4 * (size_t)t;
    return fp[0] <= b[1] && fp[1] >= b[0] && fp[2] <= b[3] && fp[3] >= b[2];
  };
  int32_t* row = a.sched + blk * (a.n_tiles + 1);
  int count = 0;
  for (int t0 = 0; t0 < a.n_tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    int total;
    cta_prefix(t < a.n_tiles && overlap(t), sh.warp_cnt, total);
    count += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) row[0] = count;
  int before = 0;  // overlapping tiles in earlier chunks
  for (int t0 = 0; t0 < a.n_tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const bool ov = t < a.n_tiles && overlap(t);
    int total;
    const int pos = cta_prefix(ov, sh.warp_cnt, total);
    if (t < a.n_tiles)
      row[1 + (ov ? before + pos : count + (t0 - before) + (threadIdx.x - pos))] = t;
    before += total;
    __syncthreads();
  }
}

// kRays rays per thread: a CTA takes kRays * kThreads lanes of one ray
// block, so each staged row serves kRays pair tests per shared load.
template <Layout L>
__global__ void __launch_bounds__(kThreads) hit_grid_kernel(const GridArgs a) {
  constexpr int R = kRays;
  __shared__ PackedTile sh;
  const int per_block = (a.ray_block + R * kThreads - 1) / (R * kThreads);
  const long long blk = blockIdx.x / per_block;           // ray block
  const int base = (blockIdx.x % per_block) * R * kThreads;
  Rays<R> ry;
  long long idx[R];
  bool on[R], any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int off = base + r * kThreads + threadIdx.x;
    idx[r] = blk * a.ray_block + off;
    on[r] = off < a.ray_block && idx[r] < a.n;
    any = any || on[r];
    load_lane<L, R>(a, on[r] ? idx[r] : 0, r, ry);
  }

  const int32_t* sched = a.sched + blk * (a.n_tiles + 1);
  const int count = sched[0];
  const int st = a.st;
  float best_t[R];
  int best_row[R];
  const int staged = sweep_packed_rows<R>(
      a.attrs, kGridAttrCols, count * st,
      [&](int k, int& row) {
        row = sched[1 + k / st] * st + k % st;
        return a.attrs[(size_t)row * kGridAttrCols + A_RADIUS] != 0.0f;
      },
      sh, any, ry, a.min_t, best_t, best_row);

  if (a.stats != nullptr) {
    unsigned long long pairs = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) pairs += on[r] ? (unsigned long long)staged : 0ull;
    for (int s = 16; s > 0; s >>= 1)
      pairs += __shfl_down_sync(0xffffffffu, pairs, s);
    if ((threadIdx.x & 31) == 0) atomicAdd(a.stats + 1, pairs);
    if (threadIdx.x == 0) atomicAdd(a.stats, (unsigned long long)count);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!on[r] || best_row[r] < 0) continue;
    // Pass A's (t, original index), then the lexicographic merge.
    const long long i = idx[r];
    const float t_a = L == Layout::ROWS ? a.out_f[i] : a.out_f[12 * i];
    const int idx_a = L == Layout::ROWS ? a.out_i[i] : a.out_i[2 * i];
    const float* g = a.attrs + (size_t)best_row[r] * kGridAttrCols;
    if (!(best_t[r] < t_a || (best_t[r] == t_a && (int)g[A_IDX] < idx_a))) continue;
    const HitRec h = sphere_record(g, best_t[r], ry.ox[r], ry.oy[r], ry.oz[r],
                                   ry.dx[r], ry.dy[r], ry.dz[r], ry.tm[r]);
    store_record<L>(h, i, a.n, a.out_f, a.out_i, a.out_hit);
  }
}

template <Layout L>
static void launch_schedule(const GridArgs* a, unsigned grid, cudaStream_t s) {
  if (a->n_glob > kBlock)
    hit_grid_schedule_kernel<L, true><<<grid, kThreads, 0, s>>>(*a);
  else
    hit_grid_schedule_kernel<L, false><<<grid, kThreads, 0, s>>>(*a);
}

extern "C" int wrt_hit_grid_schedule(const GridArgs* a, int cols) {
  if (a->n <= 0) return 0;
  const unsigned grid = (unsigned)a->nb;
  cudaStream_t s = (cudaStream_t)a->stream;
  if (cols)
    launch_schedule<Layout::COLS>(a, grid, s);
  else
    launch_schedule<Layout::ROWS>(a, grid, s);
  return (int)cudaGetLastError();
}

extern "C" int wrt_hit_grid(const GridArgs* a, int cols) {
  if (a->n <= 0) return 0;
  const long long per_block = (a->ray_block + kRays * kThreads - 1) / (kRays * kThreads);
  const unsigned grid = (unsigned)(a->nb * per_block);
  cudaStream_t s = (cudaStream_t)a->stream;
  if (cols)
    hit_grid_kernel<Layout::COLS><<<grid, kThreads, 0, s>>>(*a);
  else
    hit_grid_kernel<Layout::ROWS><<<grid, kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
