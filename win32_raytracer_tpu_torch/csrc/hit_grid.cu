// Kernel I: pass B of the sphere grid and its merge with pass A, in the
// rows layout (persistent scheduler) and the column layout.
//
// Replaces the TPU kernels win32_raytracer_tpu/kernels/hit_grid_rows.py:98
// (_grid_kernel_rows, the rows instance; accel="grid" on a plain sphere
// scene) and win32_raytracer_tpu/kernels/experimental/hit_grid.py:50
// (_grid_kernel, the column instance).  Both compute one function: for each
// lane, the nearest root with t > min_t and r != 0 among the rows of the
// tiles its ray block's schedule lists, tiles in ascending id with strict <
// across tiles and the lowest row within one.  The TPU kernels fetch the
// winner with a one-hot MXU contraction whose ones column flags "this tile
// won"; here the winner is carried as (t, row) and its 17-column row read
// once at the end.  Pass A (the globals, kernel A or G) has already written
// its record into out_f / out_i / out_hit; this kernel merges into it in
// place on (t, original index), the reference's merge_best, writing a lane
// only where pass B wins, with store_record<L> (the record of kernels A/G).
//
// What bounds it on an H100: the pair tests the schedule leaves (27 f32
// operations each, csrc/common.cuh sphere_pair_t), a data-dependent count
// that chip_smoke.py reads back through `stats`; the brute sweep would test
// every sphere (488 for the final scene).  Design, after kernel D's: the
// reference walks its blocks in order with the whole tile table in VMEM;
// here a CTA of up to kThreads threads takes one slice of a ray block (no
// state carries between CTAs), reads the block's count and tile ids, and
// stages each scheduled tile's geometry through shared memory; every lane
// of a CTA sweeps the same rows, so the only divergence is a root's branch.
// The mask and schedule prelude stays torch ops (kernels/hit_grid.py), as
// it was XLA around the reference's kernel.
#include "common.cuh"

using namespace wrt;

constexpr int kThreads = 256;                   // lanes per CTA (at most)
constexpr int kGridAttrCols = ATTR_COLS + 1;    // accel.GRID_ATTR_COLS

struct GridArgs {
  const float* origin;     // [3, n] (ROWS) or [n, 3] (COLS)
  const float* direction;  // as origin
  const float* time;       // [n]
  const float* attrs;      // [n_tiles * st, kGridAttrCols], tile-major
  const int32_t* sched;    // [n / ray_block, 1 + n_tiles]: count, tile ids
  float* out_f;            // pass A's record in, the merged record out:
  int32_t* out_i;          //   [12, n] / [2, n] (ROWS) or [n, 12] / [n, 2]
  uint8_t* out_hit;        // [n]
  unsigned long long* stats;  // [2]: tiles staged, pair tests; or null
  long long n;             // lanes, a multiple of ray_block
  int n_tiles;
  int st;                  // rows per tile
  int ray_block;
  float min_t;
  void* stream;
};

template <Layout L>
__global__ void __launch_bounds__(kThreads) hit_grid_kernel(const GridArgs a) {
  __shared__ SphereTile sh;
  const int per_block = (a.ray_block + blockDim.x - 1) / blockDim.x;
  const long long blk = blockIdx.x / per_block;           // ray block
  const int off = (blockIdx.x % per_block) * blockDim.x + threadIdx.x;
  const bool on = off < a.ray_block;
  const long long n = a.n;
  const long long i = blk * a.ray_block + (on ? off : 0);
  float ox, oy, oz, dx, dy, dz;
  load3<L>(a.origin, i, n, ox, oy, oz);
  load3<L>(a.direction, i, n, dx, dy, dz);
  const float tm = a.time[i];
  const float aa = dx * dx + dy * dy + dz * dz;

  const int32_t* sched = a.sched + blk * (a.n_tiles + 1);
  const int count = sched[0];
  float best_t = kNoHit;
  long long best_row = -1;
  unsigned long long tiles = 0, pairs = 0;
  for (int j = 0; j < count; ++j) {
    const long long row0 = (long long)sched[1 + j] * a.st;
    for (int r0 = 0; r0 < a.st; r0 += kTile) {
      const int cnt = min(kTile, a.st - r0);
      __syncthreads();  // the previous rows are consumed
      stage_spheres(a.attrs, kGridAttrCols, row0 + r0, cnt, sh);
      __syncthreads();
      if (!on) continue;
      for (int r = 0; r < cnt; ++r) {
        if (sh.r[r] == 0.0f) continue;  // tile padding (accel._pad_rows)
        ++pairs;
        sphere_pair_t(sh, r, ox, oy, oz, dx, dy, dz, tm, aa, a.min_t,
                      [&](float t) {
                        if (t < best_t) {
                          best_t = t;
                          best_row = row0 + r0 + r;
                        }
                      });
      }
    }
    tiles += 1;
  }

  if (a.stats != nullptr) {
    for (int s = 16; s > 0; s >>= 1)
      pairs += __shfl_down_sync(0xffffffffu, pairs, s);
    if ((threadIdx.x & 31) == 0) atomicAdd(a.stats + 1, pairs);
    if (threadIdx.x == 0) atomicAdd(a.stats, tiles);
  }
  if (!on || best_row < 0) return;
  // Pass A's (t, original index), then the lexicographic merge.
  const float t_a = L == Layout::ROWS ? a.out_f[i] : a.out_f[12 * i];
  const int idx_a = L == Layout::ROWS ? a.out_i[i] : a.out_i[2 * i];
  const float* g = a.attrs + (size_t)best_row * kGridAttrCols;
  if (!(best_t < t_a || (best_t == t_a && (int)g[A_IDX] < idx_a))) return;
  const HitRec h = sphere_record(g, best_t, ox, oy, oz, dx, dy, dz, tm);
  store_record<L>(h, i, n, a.out_f, a.out_i, a.out_hit);
}

extern "C" int wrt_hit_grid(const GridArgs* a, int cols) {
  if (a->n <= 0) return 0;
  const int threads = a->ray_block < kThreads ? ((a->ray_block + 31) / 32) * 32
                                              : kThreads;
  const long long per_block = (a->ray_block + threads - 1) / threads;
  const unsigned grid = (unsigned)((a->n / a->ray_block) * per_block);
  cudaStream_t s = (cudaStream_t)a->stream;
  if (cols)
    hit_grid_kernel<Layout::COLS><<<grid, threads, 0, s>>>(*a);
  else
    hit_grid_kernel<Layout::ROWS><<<grid, threads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
