// Kernel D: nearest two-sided triangle hit through the Morton-tile grid,
// rows layout, as two launches: the schedule kernel and the sweep kernel.
//
// Replaces the TPU kernels win32_raytracer_tpu/kernels/tri_grid_rows.py
// (_tri_grid_kernel_mxu :252, the default, and _tri_grid_kernel :212, the
// exact variant), the triangle pass of meshes of >= 512 triangles (BASELINE
// config 4, mesh20k), and the XLA prelude around them (tri_accel's
// tri_block_schedule_rows and _tri_grid_raw's argsort, :318-393).  Both
// kernels compute one function; this one computes it in exact f32
// (ops/hit_tri.py's pair test), so it is held to the exact variant and the
// plain sweep, not to the MXU variant's split-bf16 flips.
//
// Semantics kept from the reference: each ray block of `ray_block` lanes
// sweeps only the tiles its schedule row lists (the conservative block
// mask), front to back by the tile entry bound; the sweep stops early once
// no lane's min(best t, segment end) reaches the next tile's bound
// (_sweep_scheduled); a tile no lane's capped segment touches is skipped
// (the any-touch slab gate against the quantised, expanded tile box, with
// the reference's slop: _any_touch); strict < across tiles and the lowest
// row within a tile; the winner is carried as (t, row) and its attributes
// are read once after the sweep.
//
// The schedule kernel takes one ray block per CTA: each lane's scene-box
// clip and segment end (tri_accel.clip_segment_to_box, written out as
// cap_eff), the block's segment, origin and |d| extremes (exact in any
// order), then per tile the overlap and entry bound tlo op for op as
// tri_block_schedule_rows (IEEE sqrtf, true division), the key clamped to
// _TLO_CAP (_TLO_PAD where the tile is not scheduled), the order of
// torch.argsort(stable=True) on the keys, the count and the bounds floored
// onto the 1/1024 grid: kernels/tri_grid.block_schedule's sched and
// bounds, in its layouts.  That order is the scheduled tiles with a key
// other than NaN by (key, tile id), then the unscheduled tiles (_TLO_PAD,
// above every scheduled key) by id, then the scheduled tiles whose key is
// NaN by id.  The last two classes take their places by a prefix count in
// id order.  The first is ranked among itself: up to a CTA's worth of
// tiles in shared memory by counting (each thread ranks one tile against
// the others), more by a stable LSD radix sort of the key bits, 8 bits a
// pass, through the block's schedule row and a scratch row of the same
// size, O(T) a pass whatever T is.
//
// What bounds the sweep on an H100: the pair tests the schedule leaves (46
// f32 multiplies, adds and a division plus 6 compares each) and the
// any-touch tests (27 f32 operations and compares per lane and walked
// entry), data-dependent counts that chip_smoke.py reads back through
// `stats`.  Few blocks hold most of that work, so the time went to the
// serial chains of the CTAs that sweep many tiles (PERF.md, section 6).
// Design: a CTA of up to kSweepThreads threads takes 32 lanes of one ray
// block (no state carries between CTAs), kSub threads a lane, each sweeping
// every kSub-th row of a tile; the lane's tile winner is folded over them
// by shuffles (the nearest t, the lowest row on ties).  The CTA copies its
// block's walk (tile ids, bounds, quantised boxes) into shared memory, so
// the walk reads nothing from device memory but the tile rows.  The rows
// come from a per-grid copy of the geometry packed as three float4s a row
// (tri_accel.make_tri_grid's tile_geom), staged with 16-byte cp.async copies into
// one of two buffers: the next tile's copy is issued while the current one
// is swept, whenever some lane's segment (capped by its best t so far, which
// only shrinks) touches it.  One CTA vote per walk entry carries the
// entry's any-touch test, the early exit against its bound and the next
// entry's prefetch test; a touched tile adds one barrier, for its rows.
// A warp with no touching lane skips the arithmetic.  The per-CTA and
// per-warp decisions are stricter than the reference's per-block ones and
// still exact: a skipped tile cannot hold a hit nearer than a lane's
// min(best t, segment end).
#include "common.cuh"

using namespace wrt;

constexpr int kThreads = 256;                  // schedule threads per CTA (at most)
constexpr int kSweepThreads = 128;             // sweep threads per CTA (at most)
constexpr int kSub = 4;                        // sweep threads per lane
constexpr int kWalk = 256;                     // walk entries per smem window
constexpr int kGridCols = TRI_ATTR_COLS + 1;   // tri_accel.TRI_GRID_COLS
constexpr int kGeomF4 = 3;                     // float4s per packed row
constexpr float kBig = 1e8f;                   // tri_accel._BIG
constexpr float kEpsDir = 1e-12f;              // tri_grid_rows._EPS_DIR, tri_accel._EPS
constexpr float kSlopRel = 1e-4f;              // tri_grid_rows._SKIP_SLOP_REL
constexpr float kSlopAbs = 1e-5f;              // tri_grid_rows._SKIP_SLOP_ABS
constexpr float kTloScale = 1024.0f;           // kernels/tri_grid._TLO_SCALE
constexpr float kTloInv = 1.0f / 1024.0f;      // _TLO_INV
constexpr float kTloCap = 1.0e6f;              // _TLO_CAP
constexpr float kTloPad = 1.5e6f;              // _TLO_PAD

struct TriGridArgs {
  const float* origin;    // [3, n]
  const float* direction; // [3, n]
  const float* t_cap;     // [n] or null
  const float* attrs;     // [n_tiles * st, kGridCols], tile-major
  const float4* geom;     // [n_tiles * st, kGeomF4]: v0, e1, e2 packed
  const float* boxes;     // [n_tiles, 6]: x0, x1, y0, y1, z0, z1
  const float* qboxes;    // [n_tiles, 6]: boxes on the 1/1024 grid, widened
  const float* scene_box; // [6]
  int32_t* sched;         // [nb, 1 + n_tiles]: count, tile ids
  float* bounds;          // [nb, n_tiles + 1]: entry bounds, schedule order
  float* cap_eff;         // [n]: segment ends (the schedule kernel's)
  uint32_t* sort_keys;    // [nb, n_tiles]: scratch: the keys by tile id, then
  int32_t* sort_ids;      //   the radix sort's second buffer (with these ids)
  float* out_f;           // [12, n]
  int32_t* out_i;         // [2, n]
  uint8_t* out_hit;       // [n]
  unsigned long long* stats;  // [4]: CTA tiles staged, pair tests,
                              // any-touch tests, walk entries; or null
  long long n;            // lanes
  long long nb;           // ray blocks, ceil(n / ray_block)
  int n_tiles;
  int st;                 // rows per tile
  int ray_block;
  float min_t;
  void* stream;
};

// d with +-eps for near-zero components (tri_accel._slab's d_safe).
__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < kEpsDir ? (d < 0.0f ? -kEpsDir : kEpsDir) : d;
}

// 1/d with +-eps for near-zero components (tri_grid_rows._safe_inv).
__device__ __forceinline__ float safe_inv(float d) { return 1.0f / safe_dir(d); }

// Does the segment [t_lo, t_hi] slab-intersect the box
// (tri_grid_rows._any_touch, one lane)?
__device__ __forceinline__ bool any_touch(const float* box, const float o[3],
                                          const float inv[3], float t_lo,
                                          float t_hi) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float ta = (box[2 * ax] - o[ax]) * inv[ax];
    const float tb = (box[2 * ax + 1] - o[ax]) * inv[ax];
    t_lo = fmaxf(t_lo, fminf(ta, tb));
    t_hi = fminf(t_hi, fmaxf(ta, tb));
  }
  return t_lo <= t_hi * (1.0f + kSlopRel) + kSlopAbs;
}

// Lane i's ray, or past n the filler ray tri_accel.pad_rays makes
// (o = (0, -1e9, 0), d = (0, 0, 1), t_cap 0).
__device__ __forceinline__ void load_ray(const TriGridArgs& a, long long i,
                                         float o[3], float d[3], float& cap) {
  const long long n = a.n;
  if (i < n) {
    for (int c = 0; c < 3; ++c) {
      o[c] = a.origin[c * n + i];
      d[c] = a.direction[c * n + i];
    }
    cap = a.t_cap != nullptr ? a.t_cap[i] : 0.0f;
  } else {
    o[0] = 0.0f, o[1] = -1e9f, o[2] = 0.0f;
    d[0] = 0.0f, d[1] = 0.0f, d[2] = 1.0f;
    cap = 0.0f;
  }
}

// A bound key on the 1/1024 grid (block_schedule's floor, int32, f32).
__device__ __forceinline__ float quantize_bound(float key) {
  return (float)(int)floorf(key * kTloScale) * kTloInv;
}

constexpr int kRed = 13;  // segment lo[3], hi[3], origin lo[3], hi[3], |d|^2 max
constexpr int kDigits = 256;  // radix of the sort: 8 bits a pass, 4 passes

// f32 bits in an order that unsigned compares keep: -0 taken as +0 (the
// two compare equal), negatives below positives.
__device__ __forceinline__ uint32_t ordered_bits(float key) {
  const uint32_t u = __float_as_uint(key + 0.0f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

// Exclusive prefix counts of three exclusive predicates over the CTA's
// threads in thread order, and their totals (one barrier; `cnt` holds
// 3 x blockDim.x / 32 ints, not read by another call until a barrier).
__device__ __forceinline__ void cta_prefix3(const bool pred[3], int (*cnt)[kThreads / 32],
                                            int pos[3], int total[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot[3];
  for (int c = 0; c < 3; ++c) {
    ballot[c] = __ballot_sync(0xffffffffu, pred[c]);
    if (lane == 0) cnt[c][warp] = __popc(ballot[c]);
  }
  __syncthreads();
  for (int c = 0; c < 3; ++c) {
    pos[c] = __popc(ballot[c] & ((1u << lane) - 1u));
    total[c] = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      pos[c] += w < warp ? cnt[c][w] : 0;
      total[c] += cnt[c][w];
    }
  }
}

// One pass of the stable LSD radix sort of `m` (key bits, tile id) pairs
// from (src_k, src_i) into (dst_k, dst_i) by digit (ordered_bits >> shift)
// & 255; `base` holds the digit's first place (the exclusive scan of this
// pass's digit counts) on entry.  The pairs go a CTA's worth at a time:
// each pair's place is its digit's base, the pairs of its digit in earlier
// warps of the chunk, and those in its own warp at lower lanes
// (__match_any_sync).  FINAL writes the schedule row: ids at dst_i and the
// bounds, floored onto the 1/1024 grid, at dst_b.
template <bool FINAL>
__device__ __forceinline__ void radix_pass(const uint32_t* src_k, const int32_t* src_i,
                                           uint32_t* dst_k, int32_t* dst_i, float* dst_b,
                                           int m, int shift, int* base,
                                           int (*wcnt)[kDigits]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int c0 = 0; c0 < m; c0 += blockDim.x) {
    const int e = c0 + threadIdx.x;
    const bool valid = e < m;
    const uint32_t k = valid ? src_k[e] : 0u;
    const int32_t id = valid ? src_i[e] : 0;
    const uint32_t dig = valid ? (ordered_bits(__uint_as_float(k)) >> shift) & 255u
                               : (uint32_t)kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int below = __popc(peers & ((1u << lane) - 1u));
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x)
      for (int w = 0; w < warps; ++w) wcnt[w][d] = 0;
    __syncthreads();
    if (valid && below == 0) wcnt[warp][dig] = __popc(peers);
    __syncthreads();
    if (valid) {
      int off = base[dig] + below;
      for (int w = 0; w < warp; ++w) off += wcnt[w][dig];
      dst_i[off] = id;
      if (FINAL)
        dst_b[off] = quantize_bound(__uint_as_float(k));
      else
        dst_k[off] = k;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x)
      for (int w = 0; w < warps; ++w) base[d] += wcnt[w][d];
  }
}

// base[d] = the count of digits below d in `hist` (warp 0 alone; the CTA
// must be ordered before and after by barriers).
__device__ __forceinline__ void digit_bases(const int* hist, int* base) {
  if (threadIdx.x >= 32) return;
  constexpr int per = kDigits / 32;
  int v[per], sum = 0;
  for (int j = 0; j < per; ++j) {
    v[j] = hist[threadIdx.x * per + j];
    sum += v[j];
  }
  int incl = sum;
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, s);
    if (threadIdx.x >= s) incl += o;
  }
  int run = incl - sum;
  for (int j = 0; j < per; ++j) {
    base[threadIdx.x * per + j] = run;
    run += v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    tri_grid_schedule_kernel(const TriGridArgs a) {
  __shared__ float red[kThreads / 32][kRed];
  __shared__ int cls_cnt[3][kThreads / 32];
  __shared__ float s_key[kThreads];          // few scheduled tiles: by count
  __shared__ int s_id[kThreads];
  __shared__ int hist[4][kDigits];           // many: the radix sort's digits
  __shared__ int base[kDigits];
  __shared__ int wcnt[kThreads / 32][kDigits];
  const long long blk = blockIdx.x;
  const float* sb = a.scene_box;
  float acc[kRed];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc[c] = f32_inf();
    acc[3 + c] = -f32_inf();
    acc[6 + c] = f32_inf();
    acc[9 + c] = -f32_inf();
  }
  acc[12] = -f32_inf();
  for (int off = threadIdx.x; off < a.ray_block; off += blockDim.x) {
    const long long i = blk * a.ray_block + off;
    float o[3], d[3], cap;
    load_ray(a, i, o, d, cap);
    // tri_accel.clip_segment_to_box.
    float lo_t = a.min_t, hi_t = kBig;
    if (a.t_cap != nullptr) hi_t = tmin(hi_t, cap);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float ds = safe_dir(d[ax]);
      const float ta = (sb[2 * ax] - o[ax]) / ds;
      const float tb = (sb[2 * ax + 1] - o[ax]) / ds;
      lo_t = tmax(lo_t, tmin(ta, tb));
      hi_t = tmin(hi_t, tmax(ta, tb));
    }
    const bool empty = lo_t > hi_t;
    if (i < a.n) a.cap_eff[i] = empty ? 0.0f : hi_t;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float pa = o[ax] + lo_t * d[ax], pb = o[ax] + hi_t * d[ax];
      acc[ax] = tmin(acc[ax], empty ? kBig : tmin(pa, pb));
      acc[3 + ax] = tmax(acc[3 + ax], empty ? -kBig : tmax(pa, pb));
      acc[6 + ax] = tmin(acc[6 + ax], empty ? kBig : o[ax]);
      acc[9 + ax] = tmax(acc[9 + ax], empty ? -kBig : o[ax]);
    }
    const float d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    acc[12] = tmax(acc[12], empty ? 0.0f : d2);
  }
  // The block's extremes: min for lo rows, max for hi rows and |d|^2.
  auto fold = [](int c, float x, float y) {
    return (c < 3 || (c >= 6 && c < 9)) ? tmin(x, y) : tmax(x, y);
  };
#pragma unroll
  for (int c = 0; c < kRed; ++c)
    for (int s = 16; s > 0; s >>= 1)
      acc[c] = fold(c, acc[c], __shfl_xor_sync(0xffffffffu, acc[c], s));
  const int warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0)
    for (int c = 0; c < kRed; ++c) red[threadIdx.x >> 5][c] = acc[c];
  __syncthreads();
  for (int w = 0; w < warps; ++w)
#pragma unroll
    for (int c = 0; c < kRed; ++c) acc[c] = fold(c, acc[c], red[w][c]);
  const float dmax = sqrtf(acc[12]);

  // Per tile: overlap, entry bound and key (tri_block_schedule_rows, then
  // block_schedule's key), kept by tile id in the scratch row; the count
  // of scheduled tiles whose key is not NaN (n_s) and of unscheduled ones.
  const int T = a.n_tiles;
  uint32_t* keys = a.sort_keys + blk * (size_t)T;
  int32_t* ids = a.sort_ids + blk * (size_t)T;
  int32_t* srow = a.sched + blk * (T + 1);
  float* brow = a.bounds + blk * (T + 1);
  int n_s = 0, n_pad = 0;
  for (int t0 = 0; t0 < T; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    bool ov = false;
    float key = 0.0f;
    if (t < T) {
      const float* bx = a.boxes + 6 * (size_t)t;
      ov = true;
      float dist2 = 0.0f;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        ov = ov && acc[ax] <= bx[2 * ax + 1] && acc[3 + ax] >= bx[2 * ax];
        const float gap = tmax(tmax(bx[2 * ax] - acc[9 + ax],
                                    acc[6 + ax] - bx[2 * ax + 1]), 0.0f);
        dist2 = dist2 + gap * gap;
      }
      const float tlo = tmax(sqrtf(dist2) / tmax(dmax, kEpsDir), a.min_t);
      key = ov ? tmin(tlo, kTloCap) : kTloPad;
      keys[t] = __float_as_uint(key);
    }
    n_s += __syncthreads_count(ov && key == key);
    n_pad += __syncthreads_count(t < T && !ov);
  }
  const int n_nan = T - n_s - n_pad;
  const bool few = n_s <= (int)blockDim.x;

  // Each tile to its class's place: the scheduled tiles with a key into
  // s_key / s_id (few) or the first n_s places of the schedule row (many),
  // in id order; the others straight to their places in the row.
  for (int d = threadIdx.x; d < 4 * kDigits; d += blockDim.x) (&hist[0][0])[d] = 0;
  __syncthreads();
  int before[3] = {0, 0, 0};
  for (int t0 = 0; t0 < T; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const float key = t < T ? __uint_as_float(keys[t]) : 0.0f;
    const bool pad = t < T && key == kTloPad;
    const bool cls[3] = {t < T && key == key && !pad, pad, t < T && key != key};
    int pos[3], total[3];
    cta_prefix3(cls, cls_cnt, pos, total);
    if (cls[0]) {
      const int e = before[0] + pos[0];
      if (few) {
        s_key[e] = key;
        s_id[e] = t;
      } else {
        reinterpret_cast<uint32_t*>(brow)[e] = __float_as_uint(key);
        srow[1 + e] = t;
        const uint32_t u = ordered_bits(key);
        for (int p = 0; p < 4; ++p) atomicAdd(&hist[p][(u >> (8 * p)) & 255u], 1);
      }
    } else if (cls[1] || cls[2]) {
      const int r = cls[1] ? n_s + before[1] + pos[1] : n_s + n_pad + before[2] + pos[2];
      srow[1 + r] = t;
      brow[r] = quantize_bound(key);
    }
    for (int c = 0; c < 3; ++c) before[c] += total[c];
    __syncthreads();  // cls_cnt is read before the next chunk's counts
  }
  if (threadIdx.x == 0) {
    srow[0] = n_s + n_nan;
    brow[T] = quantize_bound(kTloPad);
  }

  if (few) {
    // Rank counting: tile e's place among the n_s by (key, id); s_* hold
    // them in id order, so a lower place in s_* is a lower id.
    const int e = threadIdx.x;
    if (e < n_s) {
      const float k = s_key[e];
      int rank = 0;
      for (int u = 0; u < n_s; ++u) {
        const float ku = s_key[u];
        rank += (ku < k || (ku == k && u < e)) ? 1 : 0;
      }
      srow[1 + rank] = s_id[e];
      brow[rank] = quantize_bound(k);
    }
    return;
  }
  // Many: the stable LSD radix sort, row -> scratch -> row -> scratch ->
  // row, stable in each pass, so pairs of equal keys keep id order.
  uint32_t* row_k = reinterpret_cast<uint32_t*>(brow);
  int32_t* row_i = srow + 1;
  for (int p = 0; p < 4; ++p) {
    __syncthreads();  // hist complete, base free, the previous pass written
    digit_bases(hist[p], base);
    __syncthreads();
    if (p == 3)
      radix_pass<true>(keys, ids, nullptr, row_i, brow, n_s, 8 * p, base, wcnt);
    else if (p % 2 == 0)
      radix_pass<false>(row_k, row_i, keys, ids, nullptr, n_s, 8 * p, base, wcnt);
    else
      radix_pass<false>(keys, ids, row_k, row_i, nullptr, n_s, 8 * p, base, wcnt);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The OR over the CTA of each lane's `bits` (one barrier); `slots` holds
// blockDim.x / 32 words and alternates between two consecutive votes.
__device__ __forceinline__ unsigned cta_or(unsigned bits, unsigned* slots) {
  const unsigned w = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = w;
  __syncthreads();
  unsigned all = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) all |= slots[k];
  return all;
}

enum Vote : unsigned { V_TOUCH = 1, V_REACH = 2, V_NEXT = 4 };

template <bool EARLY_EXIT, bool ANY_SKIP>
__global__ void __launch_bounds__(kSweepThreads) tri_grid_kernel(const TriGridArgs a) {
  extern __shared__ float4 geo[];          // two buffers of st * kGeomF4
  __shared__ int w_tile[kWalk];
  __shared__ float w_bound[kWalk];
  __shared__ float w_box[kWalk * 6];
  __shared__ unsigned votes[2][kSweepThreads / 32];
  // kSub neighbouring threads share a lane: each sweeps every kSub-th row
  // of a tile, and the lane's tile winner is folded over them.
  const int sub = threadIdx.x % kSub;
  const int lanes = blockDim.x / kSub;
  const int per_block = (a.ray_block + lanes - 1) / lanes;
  const long long blk = blockIdx.x / per_block;           // ray block
  const int off = (blockIdx.x % per_block) * lanes + threadIdx.x / kSub;
  const long long i = blk * a.ray_block + off;
  const bool on = off < a.ray_block && i < a.n;
  float o[3], d[3], cap;
  load_ray(a, on ? i : 0, o, d, cap);
  cap = on ? a.cap_eff[i] : 0.0f;
  const float inv[3] = {safe_inv(d[0]), safe_inv(d[1]), safe_inv(d[2])};

  const int32_t* sched = a.sched + blk * (a.n_tiles + 1);
  const float* bounds = a.bounds + blk * (a.n_tiles + 1);
  const int count = sched[0];
  const int st = a.st;
  const int tile_f4 = st * kGeomF4;
  float best_t = kNoHit;
  long long best_row = -1;
  unsigned tiles = 0, pairs = 0, touches = 0, walked = 0;

  auto prefetch = [&](int tile, int buf) {
    const float4* src = a.geom + (size_t)tile * tile_f4;
    float4* dst = geo + buf * tile_f4;
    for (int q = threadIdx.x; q < tile_f4; q += blockDim.x) cp_async16(dst + q, src + q);
    cp_async_commit();
  };
  if (count > 0) prefetch(sched[1], 0);

  int j = 0;
  bool stop = false;
  for (int w0 = 0; w0 < count && !stop; w0 += kWalk) {
    const int m = min(kWalk, count - w0);
    __syncthreads();  // the previous window is consumed
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const int tile = sched[1 + w0 + k];
      w_tile[k] = tile;
      w_bound[k] = bounds[w0 + k];
      for (int c = 0; c < 6; ++c) w_box[6 * k + c] = a.qboxes[6 * tile + c];
    }
    __syncthreads();
    for (int jj = 0; jj < m; ++jj, ++j) {
      // One vote: this entry's any-touch test, the early exit against its
      // bound (best t after the previous entry) and the next entry's
      // prefetch test (a superset of its any-touch test after this entry:
      // best t only shrinks).
      const float t_hi = fminf(cap, best_t);
      const bool has_next = j + 1 < count;
      const int next = !has_next ? -1 : jj + 1 < m ? w_tile[jj + 1] : sched[2 + j];
      unsigned bits = ANY_SKIP ? 0u : V_NEXT;
      bool touch = on;
      if (ANY_SKIP) {
        touch = on && any_touch(&w_box[6 * jj], o, inv, a.min_t, t_hi);
        if (on && has_next) {
          const float* nb = jj + 1 < m ? &w_box[6 * (jj + 1)] : a.qboxes + 6 * next;
          bits |= any_touch(nb, o, inv, a.min_t, t_hi) ? V_NEXT : 0u;
        }
      }
      if (EARLY_EXIT && on && fminf(best_t, cap) >= w_bound[jj]) bits |= V_REACH;
      if (touch) bits |= V_TOUCH;
      unsigned all = V_TOUCH | V_REACH | V_NEXT;
      if (ANY_SKIP || EARLY_EXIT)
        all = cta_or(bits, votes[j & 1]);
      else
        __syncthreads();  // the buffer the next copy fills is consumed
      if (EARLY_EXIT && j > 0 && !(all & V_REACH)) {
        stop = true;
        break;
      }
      walked += 1;
      if (ANY_SKIP && on && sub == 0) touches += 1;
      cp_async_wait_all();  // this entry's rows (and any unused copy) landed
      if (has_next && (all & V_NEXT)) prefetch(next, (j + 1) & 1);
      if (!(all & V_TOUCH)) continue;
      __syncthreads();  // every thread's part of this entry's rows is visible
      const bool warp_on = __any_sync(0xffffffffu, touch);
      tiles += 1;
      if (!warp_on) continue;  // warp-uniform: every thread below shuffles
      const float4* g = geo + (j & 1) * tile_f4;
      float tile_t = kNoHit;
      int tile_r = -1;
      for (int r = sub; r < st; r += kSub) {
        const float4 p = g[kGeomF4 * r], q = g[kGeomF4 * r + 1], s = g[kGeomF4 * r + 2];
        const float t = tri_pair_geom(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, s.x,
                                      o[0], o[1], o[2], d[0], d[1], d[2], a.min_t);
        if (t < tile_t) {
          tile_t = t;
          tile_r = r;
        }
      }
      // The tile's winner over the lane's threads: the nearest t, the
      // lowest row on ties, as one thread sweeping the rows in order keeps.
#pragma unroll
      for (int m = 1; m < kSub; m <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, tile_t, m);
        const int orow = __shfl_xor_sync(0xffffffffu, tile_r, m);
        if (ot < tile_t || (ot == tile_t && orow < tile_r)) {
          tile_t = ot;
          tile_r = orow;
        }
      }
      if (tile_t < best_t) {
        best_t = tile_t;
        best_row = (long long)w_tile[jj] * st + tile_r;
      }
      if (on && sub == 0) pairs += st;
    }
  }
  cp_async_wait_all();

  if (a.stats != nullptr) {
    for (int s = 16; s > 0; s >>= 1) {
      pairs += __shfl_down_sync(0xffffffffu, pairs, s);
      touches += __shfl_down_sync(0xffffffffu, touches, s);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(a.stats + 1, (unsigned long long)pairs);
      atomicAdd(a.stats + 2, (unsigned long long)touches);
    }
    if (threadIdx.x == 0) {
      atomicAdd(a.stats, (unsigned long long)tiles);
      atomicAdd(a.stats + 3, (unsigned long long)walked);
    }
  }
  if (!on || sub != 0) return;
  const HitRec h = tri_winner_record(a.attrs, kGridCols, best_t, best_row,
                                     o[0], o[1], o[2], d[0], d[1], d[2]);
  write_record(h, i, a.n, a.out_f, a.out_i, a.out_hit);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename K>
static int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

extern "C" int wrt_tri_grid_schedule(const TriGridArgs* a) {
  if (a->n <= 0) return 0;
  const int threads = a->ray_block < kThreads ? ((a->ray_block + 31) / 32) * 32
                                              : kThreads;
  tri_grid_schedule_kernel<<<(unsigned)a->nb, threads, 0,
                             (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}

template <bool E, bool S>
static int launch_sweep(const TriGridArgs* a) {
  const int threads = a->ray_block * kSub < kSweepThreads
                          ? ((a->ray_block * kSub + 31) / 32) * 32
                          : kSweepThreads;
  const int lanes = threads / kSub;
  const long long per_block = (a->ray_block + lanes - 1) / lanes;
  const size_t smem = (size_t)2 * a->st * kGeomF4 * sizeof(float4);
  if (int rc = allow_smem(tri_grid_kernel<E, S>, smem)) return rc;
  tri_grid_kernel<E, S><<<(unsigned)(a->nb * per_block), threads, smem,
                          (cudaStream_t)a->stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int wrt_hit_tri_grid(const TriGridArgs* a, int early_exit,
                                int any_skip) {
  if (a->n <= 0) return 0;
  if (early_exit && any_skip) return launch_sweep<true, true>(a);
  if (early_exit) return launch_sweep<true, false>(a);
  if (any_skip) return launch_sweep<false, true>(a);
  return launch_sweep<false, false>(a);
}
