// Nearest / any-hit triangle query for 256-ray subtiles (kernel K1), with
// its supergroup pre-pass (K1b).
//
// Replaces the Pallas TPU kernel raytracer_tpu/ops/mesh_pallas.py::_kernel
// (with its _mt_merge and live_bits), entered through mesh_nearest()
// (pallas_call at mesh_pallas.py:393), and the XLA pre-pass
// _live_supergroups. Python side: raytracer_tpu_torch/ops/mesh_cuda.py,
// which holds the wrappers and the plain PyTorch version of each kernel.
//
// What it computes. Per ray: the nearest (t, triangle index, u, v) with
// t > 0 strictly, |det| >= the triangle's det_eps, u, v >= 0, u + v <= 1,
// among hits below the per-ray cap (a hit at t >= cap reports +inf); on an
// exact tie in t the lowest triangle index wins. Any-hit mode reports t = 0
// if some hit lies below the cap, +inf otherwise.
//
// What bounds it on an H100. A ray x triangle test is about 50 f32
// operations (one of them an IEEE division) against 10 plane floats that
// every lane of a warp reads from one shared-memory address (a broadcast).
// The gates cull most chunks, so the floor is the f32 rate on the tests
// the per-ray gates let through (67 TFLOP/s); the live planes, read once,
// take far less time at 3.35 TB/s. What kept the first version (one CTA of
// 256 threads per subtile, 64 CTAs for a 16,384-ray call) from that floor:
// a subtile's chunks ran as one serial chain on one SM while 68 SMs idled,
// and each chunk was a 1024-long dependent loop per thread; a warp ran the
// tests of any ray of its block; the copy waited for nothing to overlap.
// The design, step by step:
//
// 1. Fill the card. The grid is (subtile, slice): S slices per subtile.
//    The subtile's work is its pre-pass list of live supergroups, front to
//    back, cut into units of STAGE = 128 triangles: (supergroup, chunk,
//    part) in that order, 8 chunks a supergroup. Slice s takes units s,
//    s + S, s + 2S, ... The launcher picks S = min(64 units per
//    supergroup, ceil(4096 / subtiles)): S = 64 for a 16,384-ray call
//    (4,096 CTAs of at most 128 tests in a row per thread), S = 8 for
//    131,072 rays. Splitting finer than a chunk shortens the longest
//    serial chain, which sets the call's time (PERF.md has the measured
//    table of unit sizes and slice counts behind the choice).
//    Slices merge through one 64-bit word per ray, (float bits of t) << 32
//    | triangle index, reduced with atomicMin: positive floats order as
//    their bits, so the smallest word is the nearest hit and, on a tie,
//    the lowest index (the plain version's first minimum). Before each
//    gate a CTA re-reads its rays' words, so gates and the early exit use
//    the best t any slice has found; both stay conservative (the gate is
//    tmin <= best t, so a tie at the box's entry is still tested). The walk
//    stops once no ray's best t reaches the entry distance of the
//    supergroup of the slice's next unit. mesh_finish_kernel then unpacks
//    each word and recomputes u and v of the winner with the walk's own
//    operations, which gives the same bits.
// 2. Gate per warp. The slab test runs per ray; a warp with no live ray
//    skips the unit (__any_sync). The block stages a unit only if some ray
//    of it is live (__syncthreads_or). Within a unit, a warp also skips the
//    rest of a triangle's test once the u test has failed for all its live
//    rays: the rays of a warp are neighbours in the image.
// 3. Any-hit leaves as soon as found. A found ray sets its word to 0 (no
//    hit has t = 0, since t > 0 strictly) and its gates close. A shadow
//    ray starts on a surface inside chunk boxes, where the slab tmin is
//    often < 0, so the flag, and not t = 0, closes them. A warp whose live
//    lanes are all found leaves the unit (checked every 32 triangles); a
//    CTA whose rays are all found stops; other slices see the word at
//    their next gate.
// 4. Stage asynchronously. A two-stage ring in dynamic shared memory is
//    filled by cp.async.bulk (the TMA's 1-D bulk copy, completion on an
//    mbarrier): one copy per plane row of the unit (a whole chunk's 10 rows
//    are 40 KB contiguous and go in one copy). The next live unit's copy is
//    issued before the current unit's tests, its gate evaluated early with
//    the best t known then (conservative). The ring is 2 x 5 KB, under
//    the 48 KB default, which leaves room for several CTAs per SM.
// 5. Empty boxes. Padding chunks carry min > max; the gate tests lo <= hi
//    on each axis, so they are never live. Their triangles never hit
//    (det_eps = +inf), so only the tests counted drop.
// 6. The pre-pass (live_supergroups_kernel): exactly the ids, counts and
//    entries of the torch version's stable sort, in one launch instead of
//    about 15. It does little work (a 16,384-ray call on dragons_equiv's
//    130 supergroups: 2.1M slab tests of about 20 operations, 0.6 us at
//    the f32 rate), so latency bounds it: a CTA per subtile (64 on 132
//    SMs) whose every warp walks every supergroup, with six global loads
//    and a 5-step shuffle each (650 dependent shuffles a warp), then ranks
//    the keys by an O(n_super^2 / 256) count, is one long chain. So a
//    cluster of 2 or 4 CTAs takes a subtile when the subtiles alone would
//    leave SMs idle (2 for a 16,384-ray call's 64 subtiles, 4 from 33
//    subtiles down); the boxes are staged in shared memory with one load;
//    the cluster's warps share the supergroups out (130 / 16: 9 a warp at
//    2 CTAs), each lane holding 8 rays in registers and taking their
//    minimum before the one shuffle tree; the keys (entry bits << 32 | id)
//    meet in the first CTA's shared memory (distributed shared memory),
//    which sorts them by a bitonic sort (O(n log^2 n) over 256 threads).
//
// Arithmetic. Built with -fmad=false and IEEE division: every sum is
// written in the order _mt_merge uses, so the kernels round exactly as the
// plain PyTorch version (separate, unfused tensor ops) does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RT = 256;        // rays per subtile = threads per CTA
constexpr int CHUNK = 1024;    // triangles per chunk
constexpr int SG = 8;          // chunks per supergroup
constexpr int N_PLANES = 10;   // p1.xyz, e1.xyz, e2.xyz, det_eps
constexpr int WARPS = RT / 32;
constexpr int STAGE = 128;     // triangles per unit = per ring stage
constexpr int PARTS = CHUNK / STAGE;
constexpr int TARGET_CTAS = 4096;   // slices split a call up to about this
constexpr float EPSILON = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;
constexpr int PRE_RAYS = RT / 32;   // rays a lane of K1b holds
constexpr int SMS = 132;            // an H100 SXM's SMs

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct WalkArgs {
  const float* o;
  const float* d;
  const float* inv_d;
  const float* cap;        // [R]
  const int32_t* ids;      // [n_sub, n_super]
  const int32_t* cnt;      // [n_sub]
  const float* ent;        // [n_sub, n_super]
  const float* bb;         // [6, n_chunks]
  const float* planes;     // [n_chunks, N_PLANES, CHUNK]
  u64* best;               // [R] merge words, preset to all ones
  int n_super;
  int n_chunks;
  int slices;
};

// Slab test of chunk ch's box against one ray: its entry distance and
// whether the line meets the box ahead of the origin (the plain version's
// gate, without the best-t term); an empty box is never met (step 5).
__device__ __forceinline__ bool chunk_slab(const WalkArgs& a, int ch,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float& tmin) {
  const int n = a.n_chunks;
  const float lx = a.bb[ch], ly = a.bb[n + ch], lz = a.bb[2 * n + ch];
  const float hx = a.bb[3 * n + ch], hy = a.bb[4 * n + ch],
              hz = a.bb[5 * n + ch];
  const float x0 = (lx - ox) * ix, x1 = (hx - ox) * ix;
  const float y0 = (ly - oy) * iy, y1 = (hy - oy) * iy;
  const float z0 = (lz - oz) * iz, z1 = (hz - oz) * iz;
  tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)),
                           fmaxf(z0, z1));
  return (tmin <= tmax + EPSILON) && (tmax >= 0.0f) && lx <= hx &&
         ly <= hy && lz <= hz;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(RT)
mesh_walk_kernel(const WalkArgs a) {
  constexpr uint32_t STAGE_FLOATS = N_PLANES * STAGE;
  extern __shared__ __align__(128) float ring[];   // 2 x [N_PLANES][STAGE]
  __shared__ __align__(8) uint64_t full[2];

  const int sub = blockIdx.x / a.slices;
  const int slice = blockIdx.x % a.slices;
  const int r = sub * RT + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const float ox = a.o[3 * r], oy = a.o[3 * r + 1], oz = a.o[3 * r + 2];
  const float dx = a.d[3 * r], dy = a.d[3 * r + 1], dz = a.d[3 * r + 2];
  const float ix = a.inv_d[3 * r], iy = a.inv_d[3 * r + 1],
              iz = a.inv_d[3 * r + 2];
  const float cap = a.cap[r];

  // bw: the smallest merge word this thread knows, seeded from the cap
  // (hits at t == cap still submit; mesh_finish_kernel reports them +inf)
  u64 bw = (static_cast<u64>(__float_as_uint(cap)) << 32) | 0xffffffffull;
  bool found = false;   // any-hit: a hit below the cap is known

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the subtile's units: (live supergroup j, chunk c, part) in that order
  const int n_units = a.cnt[sub] * SG * PARTS;
  const int32_t* my_ids = a.ids + (size_t)sub * a.n_super;
  const float* my_ent = a.ent + (size_t)sub * a.n_super;

  auto refresh = [&]() {
    const u64 g = __ldcg(a.best + r);
    if (g < bw) bw = g;
    if (ANY_HIT && g == 0ull) found = true;
  };
  auto best_t = [&]() { return __uint_as_float((uint32_t)(bw >> 32)); };

  struct Unit {
    int k;        // index in the slice's list; -1: none left
    int ch, part;
    float tmin;   // this ray's slab entry into the chunk's box
    bool geo;     // the ray's line meets the box ahead (and it is not empty)
  };
  // The slice's next unit, from its k-th on, whose chunk is live for some
  // ray of the block (block-uniform); k = -1 when none is left or no ray
  // can still improve.
  auto next_live = [&](int k) -> Unit {
    Unit n;
    for (;; ++k) {
      const int q = slice + k * a.slices;
      if (q >= n_units) break;
      refresh();
      const int p = q / PARTS;
      const int j = p / SG;
      const float tb = best_t();
      n.ch = my_ids[j] * SG + p % SG;
      n.part = q % PARTS;
      n.geo = chunk_slab(a, n.ch, ox, oy, oz, ix, iy, iz, n.tmin);
      const bool live = !found && n.geo && n.tmin <= tb;
      if (__syncthreads_or(live)) {
        n.k = k;
        return n;
      }
      const bool active = !found && tb >= my_ent[j];
      if (!__syncthreads_or(active)) break;
    }
    n.k = -1;
    return n;
  };

  auto issue = [&](const Unit& n, int s) {
    float* dst = ring + s * STAGE_FLOATS;
    const float* src =
        a.planes + (size_t)n.ch * N_PLANES * CHUNK + n.part * STAGE;
    mbar_expect_tx(&full[s], STAGE_FLOATS * 4);
    for (int q = 0; q < N_PLANES; ++q)
      bulk_g2s(dst + q * STAGE, src + q * CHUNK, STAGE * 4, &full[s]);
  };

  Unit cur = next_live(0);
  int stage = 0;
  uint32_t phase = 0;   // bit s: parity of stage s's next completion
  if (cur.k >= 0 && threadIdx.x == 0) issue(cur, 0);

  while (cur.k >= 0) {
    // the next live unit, its gate evaluated now with the best t known
    // now; its copy lands while this unit is tested
    const Unit nxt = next_live(cur.k + 1);
    if (nxt.k >= 0 && threadIdx.x == 0) issue(nxt, stage ^ 1);

    refresh();
    const bool live = !found && cur.geo && cur.tmin <= best_t();
    const bool warp_live = __any_sync(FULL, live);
    // warp 0 waits on every copy, so none is in flight when the stage is
    // filled again or the CTA exits
    if (warp_live || warp == 0) mbar_wait(&full[stage], (phase >> stage) & 1);
    if (warp_live) {
      const float* tri = ring + stage * STAGE_FLOATS;
      const uint32_t base = (uint32_t)(cur.ch * CHUNK + cur.part * STAGE);
      float tb = best_t();
      const bool was_found = found;
      bool improved = false;
      for (int i0 = 0; i0 < STAGE; i0 += 32) {
        if (ANY_HIT && __all_sync(FULL, found || !live)) break;
#pragma unroll 4
        for (int i = i0; i < i0 + 32; ++i) {
          const float p1x = tri[0 * STAGE + i], p1y = tri[1 * STAGE + i],
                      p1z = tri[2 * STAGE + i];
          const float e1x = tri[3 * STAGE + i], e1y = tri[4 * STAGE + i],
                      e1z = tri[5 * STAGE + i];
          const float e2x = tri[6 * STAGE + i], e2y = tri[7 * STAGE + i],
                      e2z = tri[8 * STAGE + i];
          const float det_eps = tri[9 * STAGE + i];

          // pvec = d x e2
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          bool ok = fabsf(det) >= det_eps;
          const float inv_det = 1.0f / (ok ? det : 1.0f);

          const float sx = ox - p1x, sy = oy - p1y, sz = oz - p1z;
          const float u = (sx * px + sy * py + sz * pz) * inv_det;
          ok = ok && (u >= 0.0f) && (u <= 1.0f);
          // the rays of a warp are neighbours: most triangles fail the u
          // test for all of them at once
          if (!__any_sync(FULL, live && !found && ok)) continue;

          // qvec = s x e1
          const float qx = sy * e1z - sz * e1y;
          const float qy = sz * e1x - sx * e1z;
          const float qz = sx * e1y - sy * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          ok = ok && (v >= 0.0f) && (u + v <= 1.0f);

          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          if (live && ok && tt > 0.0f && tt <= tb) {
            if (ANY_HIT) {
              if (tt < cap) found = true;
            } else {
              const u64 w = (static_cast<u64>(__float_as_uint(tt)) << 32) |
                            (base + (uint32_t)i);
              if (w < bw) {
                bw = w;
                tb = tt;
                improved = true;
              }
            }
          }
        }
      }
      if (ANY_HIT ? (found && !was_found) : improved)
        atomicMin(a.best + r, ANY_HIT ? 0ull : bw);
    }

    phase ^= 1u << stage;
    stage ^= 1;
    cur = nxt;
  }
}

// Unpacks each ray's merge word into (t, idx, u, v); u and v of the winner
// are recomputed with the walk's operations, so they come out bit-equal.
__global__ void mesh_finish_kernel(const u64* __restrict__ best,
                                   const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   const float* __restrict__ cap_in,
                                   const float* __restrict__ planes,
                                   float* __restrict__ t_out,
                                   int32_t* __restrict__ idx_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out, int n,
                                   int any_hit) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const u64 w = best[r];
  const float cap = cap_in[r];
  const float t = __uint_as_float((uint32_t)(w >> 32));
  idx_out[r] = 0;
  u_out[r] = 0.0f;
  v_out[r] = 0.0f;
  if (any_hit) {
    t_out[r] = (w == 0ull) ? 0.0f : INFINITY;
    return;
  }
  if (!(t < cap)) {
    t_out[r] = INFINITY;
    return;
  }
  const uint32_t g = (uint32_t)w;
  const float* tri = planes + (size_t)(g / CHUNK) * N_PLANES * CHUNK + g % CHUNK;
  const float p1x = tri[0 * CHUNK], p1y = tri[1 * CHUNK], p1z = tri[2 * CHUNK];
  const float e1x = tri[3 * CHUNK], e1y = tri[4 * CHUNK], e1z = tri[5 * CHUNK];
  const float e2x = tri[6 * CHUNK], e2y = tri[7 * CHUNK], e2z = tri[8 * CHUNK];
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / det;
  const float sx = ox - p1x, sy = oy - p1y, sz = oz - p1z;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  t_out[r] = t;
  idx_out[r] = (int32_t)g;
  u_out[r] = (sx * px + sy * py + sz * pz) * inv_det;
  v_out[r] = (dx * qx + dy * qy + dz * qz) * inv_det;
}

// K1b: each subtile's live supergroups, sorted by (entry, id), on a
// cluster of `cl` CTAs (cl = 1, 2 or 4 by the subtile count). Every CTA of
// the cluster holds the subtile's 256 rays in registers (8 a lane) and its
// supergroup boxes in shared memory; its warps take supergroups in turn
// (the cluster's cl * 8 warps over them), each lane the minimum of its 8
// rays' clamped entry distances (+inf where the ray's line misses the box,
// passes behind the origin or enters past the cap), then one shuffle tree
// for the warp: the subtile's minimum. The key (entry bits << 32 | id, -0
// keyed as +0) goes into the first CTA's shared memory (distributed shared
// memory); after the cluster's barrier that CTA sorts the keys, padded to
// a power of two with ~0, by a bitonic sort and writes ids, entries and
// the live count.
__global__ void __launch_bounds__(RT)
live_supergroups_kernel(const float* __restrict__ o,
                        const float* __restrict__ inv_d,
                        const float* __restrict__ bb_super, int n_super,
                        int n_pad, const float* __restrict__ t_cap,
                        int32_t* __restrict__ ids, int32_t* __restrict__ cnt,
                        float* __restrict__ ent) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  u64* key = reinterpret_cast<u64*>(smem);                  // [n_pad]
  float* box = reinterpret_cast<float*>(key + n_pad);       // [6, n_super]
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int sub = (int)blockIdx.x / cl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // every CTA of the cluster has started before any writes into the
  // first one's shared memory: arrive now, wait before the first write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float ox[PRE_RAYS], oy[PRE_RAYS], oz[PRE_RAYS];
  float ix[PRE_RAYS], iy[PRE_RAYS], iz[PRE_RAYS], cap[PRE_RAYS];
#pragma unroll
  for (int j = 0; j < PRE_RAYS; ++j) {
    const int r = sub * RT + lane + 32 * j;
    ox[j] = o[3 * r];
    oy[j] = o[3 * r + 1];
    oz[j] = o[3 * r + 2];
    ix[j] = inv_d[3 * r];
    iy[j] = inv_d[3 * r + 1];
    iz[j] = inv_d[3 * r + 2];
    cap[j] = t_cap ? t_cap[r] : INFINITY;
  }
  for (int e = threadIdx.x; e < 6 * n_super; e += RT) box[e] = bb_super[e];
  if (rank == 0)
    for (int s = n_super + threadIdx.x; s < n_pad; s += RT) key[s] = ~0ull;
  __syncthreads();
  u64* key0 = cluster.map_shared_rank(key, 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  for (int s = rank * WARPS + warp; s < n_super; s += cl * WARPS) {
    const float lx = box[s], ly = box[n_super + s], lz = box[2 * n_super + s];
    const float hx = box[3 * n_super + s], hy = box[4 * n_super + s],
                hz = box[5 * n_super + s];
    float e = INFINITY;
#pragma unroll
    for (int j = 0; j < PRE_RAYS; ++j) {
      const float x0 = (lx - ox[j]) * ix[j], x1 = (hx - ox[j]) * ix[j];
      const float y0 = (ly - oy[j]) * iy[j], y1 = (hy - oy[j]) * iy[j];
      const float z0 = (lz - oz[j]) * iz[j], z1 = (hz - oz[j]) * iz[j];
      const float tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)),
                               fminf(z0, z1));
      const float tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)),
                               fmaxf(z0, z1));
      const bool hit = (tmin <= tmax + EPSILON) && (tmax >= 0.0f) &&
                       (tmin <= cap[j]);
      e = fminf(e, hit ? fmaxf(tmin, 0.0f) : INFINITY);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e = fminf(e, __shfl_xor_sync(FULL, e, off));
    // -0 keys as +0, as the torch sort compares them
    if (lane == 0)
      key0[s] = (static_cast<u64>(e == 0.0f ? 0u : __float_as_uint(e))
                 << 32) | (uint32_t)s;
  }
  cluster.sync();
  if (rank != 0) return;

  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pad / 2; i += RT) {
        const int a = 2 * i - (i & (j - 1));
        const u64 ka = key[a], kb = key[a + j];
        if ((ka > kb) == ((a & k) == 0)) {
          key[a] = kb;
          key[a + j] = ka;
        }
      }
      __syncthreads();
    }
  }
  // the live keys (a finite entry) come first; the count is where they end
  const u64 dead = static_cast<u64>(INF_BITS) << 32;
  for (int i = threadIdx.x; i < n_super; i += RT) {
    const u64 ks = key[i];
    ids[(size_t)sub * n_super + i] = (int32_t)(uint32_t)ks;
    ent[(size_t)sub * n_super + i] = __uint_as_float((uint32_t)(ks >> 32));
    const bool live = ks < dead;
    if (live != (i + 1 < n_super && key[i + 1] < dead))
      cnt[sub] = i + 1;
    if (i == 0 && !live) cnt[sub] = 0;
  }
}

// Slices per subtile: enough CTAs to fill the card (about TARGET_CTAS, 4 or
// more per SM), at most one slice per unit of a supergroup.
int walk_slices(int n_sub) {
  if (n_sub < 1) return 1;
  const int s = (TARGET_CTAS + n_sub - 1) / n_sub;
  return s < 1 ? 1 : (s > SG * PARTS ? SG * PARTS : s);
}

}  // namespace

// Plain C entry points (bound with ctypes). n_rays must be a multiple of
// 256; every pointer is device memory; launches go on `stream`. Each
// returns the first CUDA error of its launches (0 when all were accepted).

// K1's slices per subtile for a call of n_rays rays.
extern "C" int mesh_nearest_slices(int n_rays) {
  return walk_slices(n_rays / RT);
}

// K1: presets the merge words, walks (subtile, slice) CTAs, unpacks.
extern "C" int mesh_nearest_launch(
    const float* o, const float* d, const float* inv_d, const float* cap,
    const int32_t* ids, const int32_t* cnt, const float* ent, int n_super,
    const float* bb_chunk, int n_chunks, const float* planes, u64* best,
    float* t_out, int32_t* idx_out, float* u_out, float* v_out, int n_rays,
    int any_hit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_sub = n_rays / RT;
  if (n_sub == 0) return 0;
  cudaError_t e = cudaMemsetAsync(best, 0xff, sizeof(u64) * n_rays, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const WalkArgs a{o, d, inv_d, cap, ids, cnt, ent, bb_chunk, planes, best,
                   n_super, n_chunks, walk_slices(n_sub)};
  const int grid = n_sub * a.slices;
  const int smem = 2 * N_PLANES * STAGE * (int)sizeof(float);
  if (any_hit)
    mesh_walk_kernel<true><<<grid, RT, smem, st>>>(a);
  else
    mesh_walk_kernel<false><<<grid, RT, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mesh_finish_kernel<<<(n_rays + RT - 1) / RT, RT, 0, st>>>(
      best, o, d, cap, planes, t_out, idx_out, u_out, v_out, n_rays, any_hit);
  return static_cast<int>(cudaGetLastError());
}

// K1b: ids/ent [n_sub, n_super], cnt [n_sub]; t_cap may be null;
// n_super <= 6954 (its keys and boxes in one CTA's shared memory).
extern "C" int live_supergroups_launch(const float* o, const float* inv_d,
                                       const float* bb_super, int n_super,
                                       const float* t_cap, int32_t* ids,
                                       int32_t* cnt, float* ent, int n_rays,
                                       void* stream) {
  const int n_sub = n_rays / RT;
  if (n_sub == 0) return 0;
  int n_pad = 1;
  while (n_pad < n_super) n_pad *= 2;
  const size_t smem = (size_t)n_pad * sizeof(u64) +
                      (size_t)n_super * 6 * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        live_supergroups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  // a cluster of CTAs per subtile where the subtiles alone leave SMs idle:
  // 4 while that keeps a CTA an SM, else 2 up to one subtile an SM (on the
  // card, 2 beat 4 and 1 at 64 subtiles, and 4 beat 2 and 8 at 16)
  const unsigned cl = 4 * n_sub <= SMS ? 4 : (n_sub <= SMS ? 2 : 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_sub * cl);
  cfg.blockDim = dim3(RT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, live_supergroups_kernel, o, inv_d,
                                     bb_super, n_super, n_pad, t_cap, ids,
                                     cnt, ent);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
