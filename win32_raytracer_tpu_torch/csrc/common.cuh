// Device functions shared by the sphere-hit kernels (hit.cu, hit_cols.cu,
// the sphere grid's hit_grid.cu),
// the fused bounce kernels (bounce.cu), the split bounce's hit+sky and
// scatter+respawn kernels (hit_sky.cu, scatter.cu) and the triangle kernels
// (tri.cu, tri_cols.cu, tri_grid.cu).  Two sweeps live here: the sphere
// sweep (sweep_packed_rows: kernels A, B, B-multi, E, G and both of
// kernel I's launches) and the triangle sweep (tri_hit_body: kernels C
// and H); kernel D shares the triangle pair test tri_pair_geom only.
//
// Every function here mirrors a plain torch function of the package op for
// op, in the same order (win32_raytracer_tpu_torch/ops/hit.py,
// ops/hit_tri.py, ops/rows.py, persistent.py), and the library is built
// with --fmad=false so no multiply and add are contracted into one
// rounding.  With IEEE sqrtf and division
// (nvcc's defaults without --use_fast_math) a kernel then rounds where its
// plain version rounds; only the transcendental functions may differ in
// the last place.  The triangle sweep's mask pass (tri_may_hit) mirrors
// nothing: it only skips pairs that the exact test provably rejects.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wrt {

// Packed sphere attribute columns (ops/hit.py _attr_matrix).
enum AttrCol : int {
  A_C1X = 0, A_C1Y, A_C1Z, A_DCX, A_DCY, A_DCZ, A_T1, A_INVDT, A_RADIUS,
  A_MAT, A_ALR, A_ALG, A_ALB, A_FUZZ, A_IOR, A_IDX, ATTR_COLS
};

// Packed camera rows (kernels/bounce.py pack_camera); a multi-frame batch
// packs one such row block per frame, [n_frames, CAM_ROWS].
enum CamRow : int {
  C_ORIGIN = 0, C_LLC = 3, C_HORIZ = 6, C_VERT = 9, C_RIGHT = 12, C_UP = 15,
  C_LENS = 18, C_SH_OPEN = 19, C_SH_CLOSE = 20, CAM_ROWS = 21
};

enum Material : int { LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2 };

constexpr float kNoHit = 1e30f;                       // ops/hit.py F32_MAX
constexpr float kTwoPi = 6.28318530717958647692f;     // f32(2 pi)
constexpr int kBlock = 256;                           // lanes per block

// torch.minimum / torch.maximum: NaN if either operand is NaN (fminf and
// fmaxf would drop it).  Exact in any order, so block reductions by these
// equal torch's amin / amax.
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// The sphere sweep (ops/hit.py _sweep): the nearest front-face root with
// t > min_t over every active sphere, strict < so the lowest row keeps
// ties.  Every sphere kernel sweeps this way (kernels A, B and B-multi
// through B's bounce_lane, E, G, and both of kernel I's launches): _sweep's
// pair test, op for op, with few instructions around it.
//  * Only active rows are staged, in candidate order (ascending; kernel I's
//    sweep: its scheduled tiles ascending, then their rows), each carrying
//    its table row: no per-pair active load and branch, no padding rows,
//    and the strict < still keeps the lowest row on ties.
//  * The geometry is packed for 16-byte shared loads, {c1, r*r} and
//    {dc, 0} per sphere, with {t1, invdt} and the original row (an int,
//    read only for a root) beside them.  r*r is the f32 product _sweep
//    forms for every pair, formed once.
//  * Where every staged row has the same (t1, invdt) bits (every sphere of
//    the built-in scenes: t1 = 0, t2 = 1), the lerp (tm - t1) * invdt is
//    one value per ray and tile: the same operands, the same rounding.
//  * Each chunk of 32 staged spheres (8 for kernel I's few globals) is
//    swept twice: for the bits disc >= 0, with no branch, then for the
//    roots of the set bits.
//  * R rays per thread (kernels A, E and G two on a batch that fills the
//    card, else one: kernels/hit.rays_per_thread; B one; kernel I's sweep
//    two), so each staged sphere serves R pair tests per load.
// A pair test is 23 f32 multiplies, adds and subtractions and a compare
// (25 and a compare where the tile's (t1, invdt) differ).
// tests/test_torch_sweep_packed.py and tests/test_torch_grid_sched.py hold
// these visiting orders, written in torch, against ops/hit.py _sweep and
// accel._sweep_tiles bit for bit.
// ---------------------------------------------------------------------------

struct PackedTile {
  float4 cr[kBlock];           // c1x, c1y, c1z, r*r
  float4 dr[kBlock];           // dcx, dcy, dcz, 0
  float2 tv[kBlock];           // t1, invdt
  int row[kBlock];             // the original row
  int warp_cnt[kBlock / 32];   // active rows per warp of the stage
};

template <int R>
struct Rays {  // R rays of one thread; a = |d|^2
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R], tm[R], a[R];
};

// The exclusive prefix count of `pred` over the CTA's threads in thread
// order, and its total.  blockDim.x must be kBlock and every thread must
// call it; `warp_cnt` (kBlock / 32 ints of shared memory) must not be read
// by another call until a barrier after this one.
__device__ __forceinline__ int cta_prefix(bool pred, int* warp_cnt, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u));
  total = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    const int c = warp_cnt[w];
    pos += w < warp ? c : 0;
    total += c;
  }
  return pos;
}

// Stage the active rows among `rows` (<= kBlock) candidate rows of a
// [*, cols] sphere attribute table into `sh`, in candidate order; returns
// how many, and sets `uniform` when they all share their (t1, invdt) bits.
// cand(j, row) gives candidate j's table row and whether it is active.
// blockDim.x must be kBlock and every thread must call it.  Its first
// barrier orders it after the previous tile's readers; it ends behind a
// barrier.
template <typename Cand>
__device__ __forceinline__ int stage_packed_rows(const float* __restrict__ attrs,
                                                 int cols, int rows, Cand&& cand,
                                                 PackedTile& sh, bool& uniform) {
  const int j = threadIdx.x;
  int row = 0;
  const bool act = j < rows && cand(j, row);
  int total;
  const int pos = cta_prefix(act, sh.warp_cnt, total);
  float t1 = 0.0f, invdt = 0.0f;
  if (act) {
    const float* g = attrs + (size_t)row * cols;
    const float r = g[A_RADIUS];
    t1 = g[A_T1];
    invdt = g[A_INVDT];
    sh.cr[pos] = make_float4(g[A_C1X], g[A_C1Y], g[A_C1Z], r * r);
    sh.dr[pos] = make_float4(g[A_DCX], g[A_DCY], g[A_DCZ], 0.0f);
    sh.tv[pos] = make_float2(t1, invdt);
    sh.row[pos] = row;
  }
  __syncthreads();
  const bool odd = act && (__float_as_uint(t1) != __float_as_uint(sh.tv[0].x) ||
                           __float_as_uint(invdt) != __float_as_uint(sh.tv[0].y));
  uniform = !__syncthreads_or(odd);
  return total;
}

// b and the discriminant of ray r of `ry` against staged sphere j, whose
// lerp (tm - t1) * invdt is `l`: _sweep's pair test up to disc.
template <int R>
__device__ __forceinline__ float2 packed_disc(const PackedTile& sh, int j,
                                              const Rays<R>& ry, int r,
                                              float l) {
  const float4 cr = sh.cr[j];
  const float4 dr = sh.dr[j];
  const float cx = cr.x + dr.x * l;
  const float cy = cr.y + dr.y * l;
  const float cz = cr.z + dr.z * l;
  const float ocx = ry.ox[r] - cx, ocy = ry.oy[r] - cy, ocz = ry.oz[r] - cz;
  const float b = ry.dx[r] * ocx + ry.dy[r] * ocy + ry.dz[r] * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - cr.w;
  return make_float2(b, b * b - ry.a[r] * c);
}

// The pair tests of R rays against the cnt staged spheres of `sh`, in
// chunks of CH (<= 32, dividing kBlock) spheres; UNIFORM: every staged row
// has tv[0]'s (t1, invdt).
// A chunk's first pass forms each pair's discriminant and keeps only the
// bit disc >= 0, with no branch; the second visits the set bits in
// ascending order and forms those roots, recomputing b and disc by the
// same operations.  Most pairs miss, so the hot pass issues no root, no
// branch and no reconvergence, and the strict < over ascending rows keeps
// _sweep's winner.
template <int R, bool UNIFORM, int CH = 32>
__device__ __forceinline__ void sweep_packed_tile(const PackedTile& sh,
                                                  int cnt, const Rays<R>& ry,
                                                  float min_t, float* best_t,
                                                  int* best_i) {
  float lerp[R];
  if (UNIFORM) {
    const float2 tv = sh.tv[0];
#pragma unroll
    for (int r = 0; r < R; ++r) lerp[r] = (ry.tm[r] - tv.x) * tv.y;
  }
  for (int j0 = 0; j0 < cnt; j0 += CH) {  // j0 + CH - 1 < kBlock: in bounds
    unsigned m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = 0u;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      float2 tv = make_float2(0.0f, 0.0f);
      if (!UNIFORM) tv = sh.tv[j0 + k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float l = UNIFORM ? lerp[r] : (ry.tm[r] - tv.x) * tv.y;
        const float disc = packed_disc(sh, j0 + k, ry, r, l).y;
        m[r] |= (disc >= 0.0f ? 1u : 0u) << k;
      }
    }
    const int left = cnt - j0;  // rows past cnt hold stale values
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (left < CH) m[r] &= (1u << left) - 1u;
      while (m[r]) {
        const int j = j0 + __ffs(m[r]) - 1;
        m[r] &= m[r] - 1u;
        const float l = UNIFORM ? lerp[r] : (ry.tm[r] - sh.tv[j].x) * sh.tv[j].y;
        const float2 bd = packed_disc(sh, j, ry, r, l);
        const float t = (-bd.x - sqrtf(bd.y)) / ry.a[r];
        if (t > min_t && t < best_t[r]) {
          best_t[r] = t;
          best_i[r] = sh.row[j];
        }
      }
    }
  }
}

// Every thread of the block must call this: the nearest root of each of
// its R rays over the active candidates among n_cand rows of a [*, cols]
// table (stage_packed_rows' cand(k, row), k in [0, n_cand)), staged kBlock
// candidates at a time in candidate order.  Threads with `on` false help
// stage and skip the arithmetic.  best_i is the table row, -1 on a miss.
// Returns the rows staged (each a pair test of every ray with `on`).
template <int R, typename Cand>
__device__ __forceinline__ int sweep_packed_rows(const float* __restrict__ attrs,
                                                  int cols, int n_cand, Cand&& cand,
                                                  PackedTile& sh, bool on,
                                                  const Rays<R>& ry, float min_t,
                                                  float* best_t, int* best_i) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_t[r] = kNoHit;
    best_i[r] = -1;
  }
  int staged = 0;
  for (int base = 0; base < n_cand; base += kBlock) {
    bool uniform;
    const int cnt = stage_packed_rows(
        attrs, cols, min(kBlock, n_cand - base),
        [&](int j, int& row) { return cand(base + j, row); }, sh, uniform);
    staged += cnt;
    if (!on || cnt == 0) continue;
    if (uniform)
      sweep_packed_tile<R, true>(sh, cnt, ry, min_t, best_t, best_i);
    else
      sweep_packed_tile<R, false>(sh, cnt, ry, min_t, best_t, best_i);
  }
  return staged;
}

// sweep_packed_rows over the active rows of a [n_spheres, ATTR_COLS]
// table, ascending (kernels A, B, E and G).
template <int R>
__device__ __forceinline__ void sweep_packed(const float* __restrict__ attrs,
                                             const uint8_t* __restrict__ active,
                                             int n_spheres,
                                             PackedTile& sh, bool on,
                                             const Rays<R>& ry, float min_t,
                                             float* best_t, int* best_i) {
  sweep_packed_rows<R>(attrs, ATTR_COLS, n_spheres,
                       [&](int k, int& row) {
                         row = k;
                         return active[k] != 0;
                       },
                       sh, on, ry, min_t, best_t, best_i);
}

// The layout of a batch of rays and of the record a hit kernel writes: ROWS
// for the persistent scheduler (rays [3, n], the record by write_record;
// kernels A, C and E), COLS for the wavefront scheduler (rays [n, 3], ray k
// at p[3k..3k+2]; the record as out_f [n, 12] and out_i [n, 2] with the
// fields of write_record in the same order; kernels G and H).
enum class Layout { ROWS, COLS };

template <Layout L>
__device__ __forceinline__ void load3(const float* __restrict__ p, long long k,
                                      long long n, float& x, float& y,
                                      float& z) {
  if (L == Layout::COLS) {
    x = p[3 * k];
    y = p[3 * k + 1];
    z = p[3 * k + 2];
  } else {
    x = p[k];
    y = p[n + k];
    z = p[2 * n + k];
  }
}

// Ray k of a batch of n (origin and direction in layout L, [n] time) into
// slot r of `ry`.
template <Layout L, int R>
__device__ __forceinline__ void load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ tm,
                                         long long k, long long n, int r,
                                         Rays<R>& ry) {
  load3<L>(o, k, n, ry.ox[r], ry.oy[r], ry.oz[r]);
  load3<L>(d, k, n, ry.dx[r], ry.dy[r], ry.dz[r]);
  ry.tm[r] = tm[k];
  ry.a[r] = ry.dx[r] * ry.dx[r] + ry.dy[r] * ry.dy[r] + ry.dz[r] * ry.dz[r];
}

// The winner's record (ops/hit.py hit_spheres after the sweep): attributes
// fetched by index, all zero on a miss.
struct HitRec {
  bool hit;
  float t, px, py, pz, nx, ny, nz, alr, alg, alb, fuzz, ior;
  int idx, mat;
};

// The record of the sphere whose attribute row (its first ATTR_COLS
// columns) is `row`, or of a miss when `row` is null.
__device__ __forceinline__ HitRec sphere_record(
    const float* __restrict__ row, float best_t,
    float ox, float oy, float oz, float dx, float dy, float dz, float tm) {
  HitRec h;
  h.hit = row != nullptr;
  float g[ATTR_COLS];
#pragma unroll
  for (int c = 0; c < ATTR_COLS; ++c) g[c] = h.hit ? row[c] : 0.0f;
  const float ts = h.hit ? best_t : 0.0f;
  h.t = best_t;
  h.px = ox + ts * dx;
  h.py = oy + ts * dy;
  h.pz = oz + ts * dz;
  const float lerp = (tm - g[A_T1]) * g[A_INVDT];
  const float cx = g[A_C1X] + g[A_DCX] * lerp;
  const float cy = g[A_C1Y] + g[A_DCY] * lerp;
  const float cz = g[A_C1Z] + g[A_DCZ] * lerp;
  const float denom = g[A_RADIUS] == 0.0f ? 1.0f : g[A_RADIUS];
  h.nx = (h.px - cx) / denom;
  h.ny = (h.py - cy) / denom;
  h.nz = (h.pz - cz) / denom;
  h.idx = (int)g[A_IDX];
  h.mat = (int)g[A_MAT];
  h.alr = g[A_ALR];
  h.alg = g[A_ALG];
  h.alb = g[A_ALB];
  h.fuzz = g[A_FUZZ];
  h.ior = g[A_IOR];
  return h;
}

// The record of sphere best_i of a [*, ATTR_COLS] table (-1: a miss).
__device__ __forceinline__ HitRec winner_record(
    const float* __restrict__ attrs, float best_t, int best_i,
    float ox, float oy, float oz, float dx, float dy, float dz, float tm) {
  return sphere_record(best_i >= 0 ? attrs + (size_t)best_i * ATTR_COLS
                                   : nullptr,
                       best_t, ox, oy, oz, dx, dy, dz, tm);
}

// ---------------------------------------------------------------------------
// Triangles (ops/hit_tri.py): two-sided Moller-Trumbore, nearest t > min_t,
// strict < so the first row keeps ties.
// ---------------------------------------------------------------------------

// Packed triangle attribute columns (ops/hit_tri.py _T_*); the grid's tile
// rows carry one more column (tri_accel.TRI_GRID_COLS).
enum TriCol : int {
  T_V0X = 0, T_V0Y, T_V0Z, T_E1X, T_E1Y, T_E1Z, T_E2X, T_E2Y, T_E2Z,
  T_MAT, T_ALR, T_ALG, T_ALB, T_FUZZ, T_IOR, T_IDX, TRI_ATTR_COLS
};

constexpr float kDetEps = 1e-9f;     // ops/hit_tri.py _DET_EPS

// The pair test of ops/hit_tri.py tri_pair_t against the triangle (v0, e1,
// e2): t of a valid hit, else kNoHit.  Kernel D calls it on every pair,
// kernels C and H on the pairs their mask pass keeps (tri_sweep_packed).
__device__ __forceinline__ float tri_pair_geom(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float min_t) {
  const float px = dy * e2z - dz * e2y;  // pvec = d x e2
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) >= kDetEps;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float tx = ox - v0x;             // tvec = o - v0
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;  // qvec = tvec x e1
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool valid = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > min_t;
  return valid ? t : kNoHit;
}

// The winner's record (ops/hit_tri.py tri_record_rows_from_gather): row
// `best_row` of a [*, cols] table read once, all zero on a miss; the normal
// is the unit cross product e1 x e2.
__device__ __forceinline__ HitRec tri_winner_record(
    const float* __restrict__ attrs, int cols, float best_t,
    long long best_row, float ox, float oy, float oz, float dx, float dy,
    float dz) {
  HitRec h;
  h.hit = best_t < kNoHit;
  float g[TRI_ATTR_COLS];
#pragma unroll
  for (int c = 0; c < TRI_ATTR_COLS; ++c)
    g[c] = best_row >= 0 ? attrs[(size_t)best_row * cols + c] : 0.0f;
  const float ts = h.hit ? best_t : 0.0f;
  h.t = best_t;
  h.px = ox + ts * dx;
  h.py = oy + ts * dy;
  h.pz = oz + ts * dz;
  const float gx = g[T_E1Y] * g[T_E2Z] - g[T_E1Z] * g[T_E2Y];
  const float gy = g[T_E1Z] * g[T_E2X] - g[T_E1X] * g[T_E2Z];
  const float gz = g[T_E1X] * g[T_E2Y] - g[T_E1Y] * g[T_E2X];
  const float norm = sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-30f));
  h.nx = gx / norm;
  h.ny = gy / norm;
  h.nz = gz / norm;
  h.idx = (int)g[T_IDX];
  h.mat = (int)g[T_MAT];
  h.alr = g[T_ALR];
  h.alg = g[T_ALG];
  h.alb = g[T_ALB];
  h.fuzz = g[T_FUZZ];
  h.ior = g[T_IOR];
  return h;
}

// A hit record in the rows layout every hit kernel writes: out_f [12, n]
// (t, point, normal, albedo, fuzz, ior), out_i [2, n] (idx, mat), hit [n].
__device__ __forceinline__ void write_record(const HitRec& h, long long i,
                                             long long n, float* out_f,
                                             int32_t* out_i, uint8_t* out_hit) {
  const float vals[12] = {h.t,  h.px,  h.py,  h.pz,  h.nx,   h.ny,
                          h.nz, h.alr, h.alg, h.alb, h.fuzz, h.ior};
#pragma unroll
  for (int r = 0; r < 12; ++r) out_f[r * n + i] = vals[r];
  out_i[i] = h.idx;
  out_i[n + i] = h.mat;
  out_hit[i] = h.hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The brute hit kernels' bodies, templated on the layout of the rays they
// read and the record they write (kernels A and G, C and H).  The sweep is
// the same code in both layouts.
// ---------------------------------------------------------------------------

template <Layout L>
__device__ __forceinline__ void store_record(const HitRec& h, long long i,
                                             long long n, float* out_f,
                                             int32_t* out_i, uint8_t* out_hit) {
  if (L == Layout::ROWS) {
    write_record(h, i, n, out_f, out_i, out_hit);
    return;
  }
  const float vals[12] = {h.t,  h.px,  h.py,  h.pz,  h.nx,   h.ny,
                          h.nz, h.alr, h.alg, h.alb, h.fuzz, h.ior};
  float* row = out_f + 12 * i;
#pragma unroll
  for (int r = 0; r < 12; ++r) row[r] = vals[r];
  out_i[2 * i] = h.idx;
  out_i[2 * i + 1] = h.mat;
  out_hit[i] = h.hit ? 1 : 0;
}

struct HitArgs {
  const float* origin;     // [3, n] (ROWS) or [n, 3] (COLS)
  const float* direction;  // as origin
  const float* time;       // [n]
  const float* attrs;      // [n_spheres, ATTR_COLS]
  const uint8_t* active;   // [n_spheres]
  float* out_f;            // [12, n] or [n, 12]: t, point, normal, albedo, fuzz, ior
  int32_t* out_i;          // [2, n] or [n, 2]: idx, mat
  uint8_t* out_hit;        // [n]
  long long n;
  int n_spheres;
  float min_t;
  void* stream;
};

// R rays per thread, rays blockIdx.x * kBlock * R + r * kBlock + threadIdx.x
// (r < R); the block stages the active spheres through `sh`
// (sweep_packed), then each ray's winner is read by index once.
template <Layout L, int R>
__device__ __forceinline__ void sphere_hit_body(const HitArgs& a, PackedTile& sh) {
  const long long n = a.n;
  const long long i0 = (long long)blockIdx.x * (kBlock * R) + threadIdx.x;
  Rays<R> ry;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + (long long)r * kBlock;
    load_ray<L, R>(a.origin, a.direction, a.time, i < n ? i : 0, n, r, ry);
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
    store_record<L>(h, i, n, a.out_f, a.out_i, a.out_hit);
  }
}

// Launch kernel<R> with R = rays (1 or 2) rays per thread over a->n rays.
template <typename Args, typename K1, typename K2>
__host__ int launch_rays(const Args* a, int rays, K1 k1, K2 k2) {
  if (a->n <= 0) return 0;
  if (rays != 1 && rays != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)a->stream;
  const long long per_block = (long long)kBlock * rays;
  const unsigned grid = (unsigned)((a->n + per_block - 1) / per_block);
  if (rays == 2)
    k2<<<grid, kBlock, 0, stream>>>(*a);
  else
    k1<<<grid, kBlock, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

struct TriArgs {
  const float* origin;     // [3, n] (ROWS) or [n, 3] (COLS)
  const float* direction;  // as origin
  const float* attrs;      // [n_tris, TRI_ATTR_COLS]
  const uint8_t* active;   // [n_tris]
  float* out_f;            // [12, n] or [n, 12]
  int32_t* out_i;          // [2, n] or [n, 2]
  uint8_t* out_hit;        // [n]
  long long n;
  int n_tris;
  float min_t;
  void* stream;
};

// ---------------------------------------------------------------------------
// The triangle sweep of kernels C and H (ops/hit_tri.py _sweep): the
// nearest t of tri_pair_geom over every active row, strict < so the lowest
// row keeps ties.  It has the sphere sweep's shape (sweep_packed):
//  * Stages of up to kBlock candidate rows; only the active ones are
//    staged, ascending, by the CTA's ballot-and-prefix count (cta_prefix),
//    each as three float4s in kernel D's layout ({v0, e1x}, {e1y, e1z,
//    e2x, e2y}, {e2z, 0, 0, 0}; the third read as one float) with its
//    table row beside them in an int array, read only for a pair that
//    passes the mask.  Any table size: the stages repeat.
//  * R rays per thread (kernels/hit.rays_per_thread, as kernels A, E, G),
//    so one staged triangle's loads serve R pair tests.
//  * Each chunk of kTriChunk staged triangles is swept twice.  The first
//    pass forms, by tri_pair_geom's own operations, det, un = tvec.pvec,
//    vn = d.qvec and tn = e2.qvec (the numerators of u, v and t), and sets
//    bit k where the pair may pass (tri_may_hit): no division, no select,
//    no branch.  The second visits the set bits ascending and runs the
//    exact test, tri_pair_geom, on the same staged values: the same
//    operations give the same bits, so the winner, its t and its row are
//    _sweep's.
//
// Why the mask keeps every pair the exact test accepts (tri_may_hit).  Let
// D = |det| >= 1e-9 (ok), s = sign(det), and for any x of un, vn, tn the
// real quotient x s / D.  inv_det = RN(1/det) = s (1 + d0) / D with
// |d0| <= 2^-22 (2^-24 while 1/D is normal; 1/D >= 2^-128, so a subnormal
// inv_det still errs by at most 2^-150 / 2^-128).  Flipping a sign is
// exact, so us = un s, vs = vn s, ts = tn s and us + vs = s RN(un + vn)
// are formed without rounding, and every bound below is compared as
// "not provably out", so a NaN keeps its pair.
//  * u >= 0 (also u = -0): if us < -D 2^-24 (D 2^-24 exact: D is normal),
//    |un inv_det| > 2^-24 (1 - 2^-22) > 2^-25, so u = RN(un inv_det) is a
//    negative number or -inf, never -0: the exact test rejects.  So does
//    v with vs.
//  * RN(u + v) <= 1: accepted u, v >= -0 give u + v <= 1 + 2^-24, and
//    un s / D <= (u + 2^-150) / ((1 - 2^-24)(1 - 2^-22)) (the same for
//    vn), so (un + vn) s <= D (1 + 2^-20) < D (1 + 2^-18); RN is
//    monotone, so us + vs <= RN(D (1 + 2^-18)).  A larger margin than
//    needed: its product is the one rounding, and an overflow to inf
//    keeps the pair.
//  * t > min_t: with min_t >= 2^-64, t is normal, tn s / D >= t /
//    ((1 + 2^-24)(1 + 2^-22)) > min_t (1 - 2^-21), while lo = RN(min_t
//    (1 - 2^-18)) <= min_t (1 - 2^-18)(1 + 2^-24); so ts >= D lo as
//    reals, and the float ts >= RN(D lo).  Below 2^-64 (or NaN) lo is
//    -inf and t does not filter.
// det = +-inf passes the bounds (D 2^-24 = inf) where it must and fails
// D lo = inf where t = tn * 0 cannot exceed min_t.  A far hit (t above
// the running best) is kept: too rare to pay two operations a pair.
// tests/test_torch_tri_sweep_packed.py writes this order in torch, holds
// it to ops/hit_tri.py _sweep bit for bit and holds the mask to the exact
// test on adversarial pairs (it fails with any margin set to zero).
// A mask pair test is 41 f32 multiplies, adds and subtractions, the sign
// flips, three margin products, a sum and five compares.
// ---------------------------------------------------------------------------

constexpr int kTriGeomF4 = 3;  // float4s per staged triangle (kernel D's kGeomF4)
// Triangles per mask pass.  The pass is unrolled: at 32 triangles and two
// rays a thread its body is 64 pair tests, some 3,600 instructions (57 KB),
// which outgrew the instruction cache (two rays a thread measured 0.434 ms
// at 32, 0.369 at 16, 0.360 at 8 on kernel C's main shape, one ray 0.39 at
// each; PERF.md section 6).
constexpr int kTriChunk = 8;

struct TriStage {
  float4 geo[kBlock * kTriGeomF4];  // {v0, e1x}, {e1y, e1z, e2x, e2y}, {e2z, 0...}
  int row[kBlock];                  // the original row
  int warp_cnt[kBlock / 32];        // active rows per warp of the stage
};

// Stage the active rows among rows [base, base + rows) (rows <= kBlock) of
// a [*, TRI_ATTR_COLS] table into `sh`, ascending; returns how many.
// blockDim.x must be kBlock and every thread must call it.  Its first
// barrier (in cta_prefix) orders it after the previous stage's readers; it
// ends behind a barrier.
__device__ __forceinline__ int stage_tris_packed(const float* __restrict__ attrs,
                                                 const uint8_t* __restrict__ active,
                                                 int base, int rows,
                                                 TriStage& sh) {
  const int row = base + threadIdx.x;
  const bool act = (int)threadIdx.x < rows && active[row] != 0;
  int total;
  const int pos = cta_prefix(act, sh.warp_cnt, total);
  if (act) {
    const float* g = attrs + (size_t)row * TRI_ATTR_COLS;
    float4* dst = sh.geo + kTriGeomF4 * pos;
    dst[0] = make_float4(g[T_V0X], g[T_V0Y], g[T_V0Z], g[T_E1X]);
    dst[1] = make_float4(g[T_E1Y], g[T_E1Z], g[T_E2X], g[T_E2Y]);
    dst[2] = make_float4(g[T_E2Z], 0.0f, 0.0f, 0.0f);
    sh.row[pos] = row;
  }
  __syncthreads();
  return total;
}

// The mask pass's pair test of ray r of `ry` against the staged triangle
// (p, q, e2z): false only where tri_pair_geom provably returns kNoHit (the
// bounds in the note above; lo = min_t (1 - 2^-18), or -inf).
template <int R>
__device__ __forceinline__ bool tri_may_hit(float4 p, float4 q, float e2z,
                                            const Rays<R>& ry, int r, float lo) {
  const float v0x = p.x, v0y = p.y, v0z = p.z, e1x = p.w;
  const float e1y = q.x, e1z = q.y, e2x = q.z, e2y = q.w;
  const float dx = ry.dx[r], dy = ry.dy[r], dz = ry.dz[r];
  const float px = dy * e2z - dz * e2y;  // tri_pair_geom's operations
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float tx = ry.ox[r] - v0x;
  const float ty = ry.oy[r] - v0y;
  const float tz = ry.oz[r] - v0z;
  const float un = tx * px + ty * py + tz * pz;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vn = dx * qx + dy * qy + dz * qz;
  const float tn = e2x * qx + e2y * qy + e2z * qz;
  const float ad = fabsf(det);
  const unsigned sg = __float_as_uint(det) & 0x80000000u;
  const float us = __uint_as_float(__float_as_uint(un) ^ sg);
  const float vs = __uint_as_float(__float_as_uint(vn) ^ sg);
  const float ts = __uint_as_float(__float_as_uint(tn) ^ sg);
  const float eps = ad * 0x1p-24f;
  return (ad >= kDetEps) & !(us < -eps) & !(vs < -eps) &
         !(us + vs > ad * (1.0f + 0x1p-18f)) & !(ts < ad * lo);
}

// The pair tests of R rays against the cnt staged triangles of `sh`, in
// chunks of kTriChunk: the mask pass, then tri_pair_geom on the set bits,
// ascending, strict <.
template <int R>
__device__ __forceinline__ void tri_sweep_stage(const TriStage& sh, int cnt,
                                                const Rays<R>& ry, float min_t,
                                                float lo, float* best_t,
                                                int* best_i) {
  for (int j0 = 0; j0 < cnt; j0 += kTriChunk) {  // j0 + kTriChunk <= kBlock
    unsigned m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = 0u;
#pragma unroll
    for (int k = 0; k < kTriChunk; ++k) {
      const float4* g = sh.geo + kTriGeomF4 * (j0 + k);
      const float4 p = g[0], q = g[1];
      const float e2z = g[2].x;
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] |= (tri_may_hit(p, q, e2z, ry, r, lo) ? 1u : 0u) << k;
    }
    const int left = cnt - j0;  // rows past cnt hold stale values
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (left < kTriChunk) m[r] &= (1u << left) - 1u;
      while (m[r]) {
        const int j = j0 + __ffs(m[r]) - 1;
        m[r] &= m[r] - 1u;
        const float4* g = sh.geo + kTriGeomF4 * j;
        const float4 p = g[0], q = g[1];
        const float t = tri_pair_geom(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w,
                                      g[2].x, ry.ox[r], ry.oy[r], ry.oz[r],
                                      ry.dx[r], ry.dy[r], ry.dz[r], min_t);
        if (t < best_t[r]) {
          best_t[r] = t;
          best_i[r] = sh.row[j];
        }
      }
    }
  }
}

// R rays per thread, rays blockIdx.x * kBlock * R + r * kBlock + threadIdx.x
// (r < R); the block stages the active triangles kBlock candidate rows at
// a time (stage_tris_packed) and sweeps each stage (tri_sweep_stage), then
// each ray's winner is read by index once (kernels C and H).
template <Layout L, int R>
__device__ __forceinline__ void tri_hit_body(const TriArgs& a, TriStage& sh) {
  const long long n = a.n;
  const long long i0 = (long long)blockIdx.x * (kBlock * R) + threadIdx.x;
  const bool on = i0 < n;  // idle threads still help stage
  Rays<R> ry;
  float best_t[R];
  int best_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + (long long)r * kBlock;
    const long long k = i < n ? i : 0;
    load3<L>(a.origin, k, n, ry.ox[r], ry.oy[r], ry.oz[r]);
    load3<L>(a.direction, k, n, ry.dx[r], ry.dy[r], ry.dz[r]);
    best_t[r] = kNoHit;
    best_i[r] = -1;
  }
  const float lo = a.min_t >= 0x1p-64f ? a.min_t * (1.0f - 0x1p-18f) : -f32_inf();
  for (int base = 0; base < a.n_tris; base += kBlock) {
    const int cnt = stage_tris_packed(a.attrs, a.active, base,
                                      min(kBlock, a.n_tris - base), sh);
    if (on && cnt > 0) tri_sweep_stage<R>(sh, cnt, ry, a.min_t, lo, best_t, best_i);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = i0 + (long long)r * kBlock;
    if (i >= n) break;
    const HitRec h = tri_winner_record(a.attrs, TRI_ATTR_COLS, best_t[r],
                                       best_i[r], ry.ox[r], ry.oy[r], ry.oz[r],
                                       ry.dx[r], ry.dy[r], ry.dz[r]);
    store_record<L>(h, i, n, a.out_f, a.out_i, a.out_hit);
  }
}

// ---------------------------------------------------------------------------
// Counter-based draws (core/rng.py hash_uniform01), bit-identical.
// ---------------------------------------------------------------------------

constexpr uint32_t kScatterPurpose = 0x5CA77E12u;
constexpr uint32_t kRespawnPurpose = 0x2E59A301u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// out[0..4] = the scatter stream, out[5..9] = the respawn stream of `lane`.
__device__ __forceinline__ void draws(uint32_t salt, int32_t step,
                                      uint32_t lane, float out[10]) {
  const uint32_t purposes[2] = {kScatterPurpose, kRespawnPurpose};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t s = fmix32(((uint32_t)step * 0x9E3779B9u) ^ salt ^ purposes[p]);
#pragma unroll
    for (uint32_t row = 0; row < 5; ++row) {
      const uint32_t x = fmix32(lane ^ fmix32(s + row * 0x85EBCA6Bu));
      out[p * 5 + row] = (float)(x >> 8) * (1.0f / 16777216.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// Hit + sky (persistent._hit_core): a miss adds throughput * sky gradient
// (ops/rows.py sky_color_rows); alive &= hit.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void hit_sky(bool hit, float dx, float dy, float dz,
                                        const float thr[3], float rad[3],
                                        bool& alive) {
  if (alive && !hit) {
    const float len = sqrtf(dx * dx + dy * dy + dz * dz);
    const float t = 0.5f * (dy / fmaxf(len, 1e-37f) + 1.0f);
    const float one_m = 1.0f - t;
    rad[0] = rad[0] + thr[0] * (one_m + t * 0.5f);
    rad[1] = rad[1] + thr[1] * (one_m + t * 0.7f);
    rad[2] = rad[2] + thr[2] * (one_m + t * 1.0f);
  }
  alive = alive && hit;
}

// ---------------------------------------------------------------------------
// Scatter + state update + respawn (ops/rows.py scatter_rows,
// persistent._scatter_core and persistent._respawn_core).
// ---------------------------------------------------------------------------

struct Lane {  // one lane's path state, updated in place
  float o[3], d[3], tm, thr[3], rad[3];
  int32_t depth, sample, pixel, s_base, s_quota;
  bool alive;
};

// A batch's path state, rows layout (persistent.PathState): each row
// block is [rows, n].
struct StateRows {
  const float* origin;      // [3, n]
  const float* direction;   // [3, n]
  const float* time;        // [1, n]
  const float* throughput;  // [3, n]
  const float* radiance;    // [3, n]; null where a kernel does not touch it
  const int32_t* depth;     // [1, n]
  const int32_t* sample;    // [1, n]
  const int32_t* pixel;     // [1, n]
  const uint8_t* alive;     // [1, n]
  const int32_t* s_base;    // [1, n]
  const int32_t* s_quota;   // [1, n]
};

__device__ __forceinline__ Lane load_lane(const StateRows& s, long long k,
                                          long long n) {
  Lane st;
  for (int c = 0; c < 3; ++c) {
    st.o[c] = s.origin[c * n + k];
    st.d[c] = s.direction[c * n + k];
    st.thr[c] = s.throughput[c * n + k];
    st.rad[c] = s.radiance ? s.radiance[c * n + k] : 0.0f;
  }
  st.tm = s.time[k];
  st.depth = s.depth[k];
  st.sample = s.sample[k];
  st.pixel = s.pixel[k];
  st.alive = s.alive[k] != 0;
  st.s_base = s.s_base[k];
  st.s_quota = s.s_quota[k];
  return st;
}

// The rows a bounce changes: out_f [10 or 13, n] (origin, direction, time,
// throughput[, radiance]), out_i [2, n] (depth, sample), out_alive [n].
__device__ __forceinline__ void store_lane(const Lane& st, long long i,
                                           long long n, bool with_rad,
                                           float* out_f, int32_t* out_i,
                                           uint8_t* out_alive) {
  for (int c = 0; c < 3; ++c) {
    out_f[c * n + i] = st.o[c];
    out_f[(3 + c) * n + i] = st.d[c];
    out_f[(7 + c) * n + i] = st.thr[c];
    if (with_rad) out_f[(10 + c) * n + i] = st.rad[c];
  }
  out_f[6 * n + i] = st.tm;
  out_i[i] = st.depth;
  out_i[n + i] = st.sample;
  out_alive[i] = st.alive ? 1 : 0;
}

struct StepParams {
  int32_t width, height, kpp, kx, ky, max_depth, rr_start;
  float eps, reflect_thres, refract_bias;
  int32_t schlick_ni;  // Schlick takes ni_over_nt (the reference quirk)
  int32_t n_frames;    // cameras in the batch; pixel rows span n_frames * height
};

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Floor division and modulo (torch // and % on integers).
__device__ __forceinline__ int32_t floor_div(int32_t x, int32_t d) {
  const int32_t q = x / d;
  return (x % d != 0 && ((x < 0) != (d < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t d) {
  return x - floor_div(x, d) * d;
}

// The material scatter of one live lane.  Writes the new origin and
// direction, the attenuation and whether the path survives.
__device__ __forceinline__ void scatter(const StepParams& p, const HitRec& h,
                                        const float dir[3], const float u[5],
                                        float no[3], float nd[3],
                                        float att[3], bool& sc_alive) {
  const float eps = p.eps;
  const float one_eps = 1.0f - eps;
  const float n[3] = {h.nx, h.ny, h.nz};
  const float hp[3] = {h.px, h.py, h.pz};

  // Unit-ball sample; the radius is exp(log(u)/3).
  const float z = 1.0f - 2.0f * u[0];
  const float phi = kTwoPi * u[1];
  const float br = expf(logf(u[2]) * (1.0f / 3.0f));
  const float bs = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float ball[3] = {br * bs * cosf(phi), br * bs * sinf(phi), br * z};

  // Lambertian (RayTracer.cpp:604-617); metal shares its origin.
  float lam_o[3], lam_d[3];
  for (int c = 0; c < 3; ++c) {
    lam_o[c] = hp[c] + eps * n[c];
    lam_d[c] = one_eps * n[c] + ball[c];
  }
  // Metal (RayTracer.cpp:618-635).
  const float dn2 = 2.0f * dot3(dir, n);
  float refl[3], met_d[3];
  for (int c = 0; c < 3; ++c) {
    refl[c] = dir[c] - dn2 * n[c];
    met_d[c] = refl[c] + h.fuzz * ball[c];
  }
  const bool met_ok = dot3(met_d, n) > 0.0f;

  // Dielectric (RayTracer.cpp:636-688), quirks included.
  const float neg_d[3] = {-dir[0], -dir[1], -dir[2]};
  const float len = fmaxf(sqrtf(dot3(neg_d, neg_d)), 1e-37f);
  const float dtl[3] = {neg_d[0] / len, neg_d[1] / len, neg_d[2] / len};
  const bool entering = dot3(dtl, n) > 0.0f;
  const float ni = entering ? 1.0f / h.ior : h.ior;
  float rfn[3], roff[3];
  for (int c = 0; c < 3; ++c) {
    rfn[c] = entering ? n[c] : -n[c];
    const float off = eps * n[c];
    roff[c] = entering ? -off : off;
  }
  const float cosine = dot3(dtl, rfn);
  const float sa = p.schlick_ni ? ni : h.ior;
  float r0 = (1.0f - sa) / (1.0f + sa);
  r0 = r0 * r0;
  const float reflect_prob = r0 + (1.0f - r0) * powf(1.0f - cosine, 5.0f);
  const bool is_refl = (p.reflect_thres + u[3]) < reflect_prob;

  const float dt = cosine;  // rdot(rnormalize(-d), rfn), the same values
  const float disc = p.refract_bias - ni * ni * (1.0f - dt * dt);
  const bool refr_ok = disc > 0.0f;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float dnr2 = 2.0f * dot3(dir, rfn);
  const bool back = is_refl || !refr_ok;

  const bool is_met = h.mat == METAL;
  const bool is_die = h.mat == DIELECTRIC;
  for (int c = 0; c < 3; ++c) {
    const float refr = ni * (dtl[c] - rfn[c] * dt) - rfn[c] * sq;
    const float tir = dir[c] - dnr2 * rfn[c];
    const float die_d = is_refl ? refl[c] : (refr_ok ? refr : tir);
    const float die_o = back ? hp[c] - roff[c] : hp[c] + roff[c];
    no[c] = is_die ? die_o : lam_o[c];
    nd[c] = is_die ? die_d : (is_met ? met_d[c] : lam_d[c]);
  }
  att[0] = is_die ? 1.0f : h.alr;
  att[1] = is_die ? 1.0f : h.alg;
  att[2] = is_die ? 1.0f : h.alb;
  sc_alive = is_met ? met_ok : true;
}

// One lane's scatter, depth / roulette update and respawn.  `st.alive` is
// the post-hit alive flag on entry and the lane's new alive flag on exit;
// `cams` is [p.n_frames, CAM_ROWS].  Returns whether the roulette ended the
// path (never under LEAN); a caller that does not count drops it.
template <bool LEAN>
__device__ __forceinline__ bool scatter_respawn(const StepParams& p,
                                                const float* __restrict__ cams,
                                                const HitRec& h,
                                                const float u[10], Lane& st) {
  // --- scatter and state update (persistent._scatter_core) ---
  const bool live = st.alive;
  bool alive = false;
  bool rr_kill = false;
  if (live) {
    float no[3], nd[3], att[3];
    bool sc_alive;
    scatter(p, h, st.d, u, no, nd, att, sc_alive);
    for (int c = 0; c < 3; ++c) {
      st.thr[c] = st.thr[c] * att[c];
      st.o[c] = no[c];
      st.d[c] = nd[c];
    }
    st.depth = st.depth + 1;
    alive = sc_alive && (st.depth <= p.max_depth);
    if (!LEAN) {
      const float m = fmaxf(fmaxf(st.thr[0], st.thr[1]), st.thr[2]);
      const float pr = fminf(fmaxf(m, 0.05f), 1.0f);
      if (alive && st.depth >= p.rr_start) {
        for (int c = 0; c < 3; ++c) st.thr[c] = st.thr[c] / pr;
        alive = u[4] < pr;
        rr_kill = !alive;
      }
    }
  }

  // --- respawn (persistent._respawn_core) ---
  const bool start = !alive && (st.sample < st.s_quota - 1);
  if (start) {
    st.sample = st.sample + 1;
    const int32_t pd = st.pixel / p.kpp;
    int32_t y = pd / p.width;
    const int32_t x = pd % p.width;
    // Multi-frame batch: the row of the virtual tall image picks the
    // frame's camera (an out-of-range frame takes camera 0, as the
    // reference's select chain does).  One frame skips this entirely.
    const float* cam = cams;
    if (p.n_frames > 1) {
      const int32_t fid = y / p.height;
      y = y - fid * p.height;
      if (fid >= 1 && fid < p.n_frames) cam = cams + (size_t)fid * CAM_ROWS;
    }
    float uj = u[5], vj = u[6];
    if (!LEAN) {
      const int32_t gs = st.s_base + st.sample;
      const int32_t sx = floor_mod(gs, p.kx);
      const int32_t sy = floor_mod(floor_div(gs, p.kx), p.ky);
      uj = ((float)sx + uj) / (float)p.kx;
      vj = ((float)sy + vj) / (float)p.ky;
    }
    const float uu = ((float)x + uj) / (float)p.width;
    const float vv = ((float)(p.height - y) + vj) / (float)p.height;

    st.tm = cam[C_SH_OPEN] + (cam[C_SH_CLOSE] - cam[C_SH_OPEN]) * u[7];
    const float lr = sqrtf(u[8]) * cam[C_LENS];
    const float th = kTwoPi * u[9];
    const float lc = lr * cosf(th);
    const float ls = lr * sinf(th);
    for (int c = 0; c < 3; ++c) {
      st.o[c] = cam[C_ORIGIN + c] + (cam[C_RIGHT + c] * lc + cam[C_UP + c] * ls);
      st.d[c] = cam[C_LLC + c] + uu * cam[C_HORIZ + c] + vv * cam[C_VERT + c] - st.o[c];
      st.thr[c] = 1.0f;
    }
    st.depth = 0;
  }
  st.alive = alive || start;
  return rr_kill;
}

// Adds to *dst the lanes of the calling warp that set `pred`: one atomic a
// warp, by its lowest active lane.
__device__ __forceinline__ void warp_count(unsigned long long* dst, bool pred) {
  const unsigned active = __activemask();
  const unsigned votes = __ballot_sync(active, pred);
  if (votes != 0u && (int)(threadIdx.x & 31) == __ffs(active) - 1)
    atomicAdd(dst, (unsigned long long)__popc(votes));
}

}  // namespace wrt
