// table_gather: rows of a small per-primitive table for every ray, and the
// deterministic gradient of that lookup.
//
// Replaces raytracer_tpu/core/intersect.py::table_gather (:56), which is
// XLA, not Pallas: a masked reduce over the table axis for tables of at
// most 32 rows, a one-hot product up to 1024 rows, a gather beyond. Its
// gradient, in both of the small-table routes, is a dense sum over the
// rays that read each row. Python side: raytracer_tpu_torch/ops/
// gather_cuda.py, which holds the wrappers and the plain PyTorch version.
// Neither TPU trick is carried over: the forward is a copy, the backward a
// reduction written for the card.
//
// What it computes. For a table [G, K] (K the product of the trailing
// dims, any element type) and N indices (int32 or int64):
//   forward   out[i, :] = table[clamp(idx[i], 0, G - 1), :], an exact copy;
//   backward  grad_table[g, k] = sum over i with clamp(idx[i]) = g of
//             grad_out[i, k], f32.
// Out-of-range indices are clamped, as the JAX package's gather clamps.
//
// What bounds it on an H100. Both directions move bytes and do next to no
// arithmetic: the forward reads N indices and writes N rows, the backward
// reads N indices and N gradient rows and writes G rows. The floor is the
// bytes over 3.35 TB/s: 15 us for the forward + backward of a train step's
// largest real lookup (G 4, K 10, 524,288 int64 indices). Most calls are
// far smaller (a 16,384-ray tile, a 32,768-ray microbatch, a handful of
// rows), and there the fixed cost of a launch, about 2 us, is the time.
//
// The forward (table_gather_kernel). A CTA owns a run of whole rows, so its
// output is one contiguous span of bytes whatever the row's size (108 bytes
// for the [G, 27] shading rows). It loads its rows' indices once, clamped
// and scaled to a unit offset, into shared memory; a table of up to 32 KB
// and at most a quarter of the CTA's output (the train cells' material
// rows, not a dragons_equiv tile's 18 KB shading rows) is staged beside
// them with one cooperative load, so the random reads hit shared memory;
// a larger one is read through L1. The span is then written as
// 16-byte stores, each thread finding its first (row, column) with one
// 32-bit division and stepping through the rest, and a few 4- or 1-byte
// stores where the span's ends are not 16-byte aligned. Units are 4 bytes
// where the row's size and both pointers allow, else bytes. A CTA takes
// about 16 KB of output, fewer rows where that would leave the card's 132
// SMs short of two CTAs each. A call of at most 1 MB of output (most of a
// frame's: a tile's [G, K <= 16] lookups) skips the spans and the staging:
// a unit a thread, as a launch's fixed cost is most of its time.
//
// Why no float atomics in the backward. The rays of a train batch land on
// a handful of rows (the flagship scene has five primitives), so a float
// atomicAdd per (ray, column) would serialise on those rows and add in an
// order that changes from run to run; the port's graphed and eager train
// steps must give the same bits. PyTorch's own indexing backward sorts the
// indices and lets one warp walk each row's duplicates one after another,
// which holds a few hundred thousand rays to one row in a single serial
// chain.
//
// The backward takes one of two routes, by the table's size; the route
// and the launch configuration depend only on (N, G, K), so the same
// inputs give the same bits on every call, eagerly or in a CUDA graph
// replay.
//
// The tile route (table_gather_grad_kernel), for tables of at most
// TILES_MAX tiles of GT_MAX rows x 256 columns (every table of the train
// cells), in ONE launch:
// 1. Grid (chunk, tile): the rays in n_chunks contiguous chunks, at most
//    four CTAs per SM in all (64 registers a thread), so that every CTA
//    runs in the first wave.
// 2. A thread's terms, by the table's shape (GradMode):
//    ROWS, a table of at most ROW_CELLS cells (the material rows: 4 x 10):
//    thread t takes rays t, t + 256, ... of the chunk, loads and clamps
//    each ray's index once and adds the ray's K terms into its own column
//    of [G * K, 256] sums in shared memory.
//    ONE_ROW (most of a train step's lookups) and COLUMNS: thread t owns
//    column t % K and row t / K of each step of RPS = 256 / K rays
//    (K <= 256; wider tables are cut into column tiles), so a step's
//    gradient is one contiguous run of RPS * K floats, a warp reads
//    consecutive floats and no lane idles on a K that is not a power of
//    two (at K = 10, 250 of 256 threads read). It loads U = 8 steps at a
//    time through pointers that step. ONE_ROW loads no index and sums in a
//    register; COLUMNS clamps each index in 32 bits and sums into its own
//    column of [GT, 256] sums in shared memory.
//    The stream is bound by instructions a term, not by bytes: with 64-bit
//    products and clamps and predicated adds a float (some 35
//    instructions) it read about 1 TB/s on the card whatever the loads in
//    flight, hence the three modes.
// 3. Each thread sums its own terms in ray order. No two threads ever add
//    into one place.
// 4. The CTA adds its threads' sums of each cell in a fixed order (a warp
//    over them and a shuffle tree, or one thread in order when there are
//    few) and writes them to the output, or, with more than one chunk, to
//    a workspace [G * K, n_chunks].
// 5. The last CTA of a tile to finish, found through an arrival counter
//    (__threadfence, then atomicInc), adds the tile's partial sums in
//    chunk order (a warp over them and a shuffle tree) into the output,
//    every load of a cell issued before its first add. atomicInc wraps the
//    counter back to 0 on that last arrival,
//    so a graph replay, or the next call, finds it at zero. The counters
//    are device globals, zero when the module loads; each launch takes the
//    next TILES_MAX of a ring of SLOTS by the host's count of launches, so
//    only two backward kernels running at once, SLOTS / TILES_MAX launches
//    apart, could meet on one counter.
//
// The fixed-point route, for larger tables (an image's texels: 2048^2
// rows), whose work grows with the rays, not with G: integer sums are
// exact, so integer atomics give the same bits in any order. A call
// reaches at most N rows, so their accumulators live in an open-addressing
// hash table of 1.5 N entries, one a row, its key, K maxima and K int64
// sums side by side (31 MB at 524,288 rays x 3, within the 50 MB L2), and
// not in arrays over every cell (151 MB at 4.2M rows x 3, which made every
// scattered atomic a trip to device memory).
// 0. The output is zeroed, then the table (cudaMemsetAsync, memset nodes
//    in a graph; the table last, so that it is what L2 holds): a cell no
//    index reaches gets 0.
// 1. table_gather_scale_kernel: each (ray, column) term finds or claims
//    its row's entry (linear probing, atomicCAS on the key) and raises the
//    cell's largest magnitude, as the bits of |v| (atomicMax; an
//    order-free maximum). Which entry a row gets may change from call to
//    call; its sums do not.
// 2. table_gather_add_kernel: each term v becomes the integer
//    round(v * 2^s), s chosen per cell from its largest magnitude 2^E
//    and L = ceil(log2 N) so that N such terms cannot overflow 63 bits
//    (s = 61 - E - L), and is added into the cell's int64 (atomicAdd).
//    The rounding costs each term at most 2^(E + L - 62): the sum is off
//    by at most N^2 2^(E - 62), 2^-28 of the cell's largest term at
//    N = 2^17, where an f32 sum may be off by N 2^-24 of the terms'
//    magnitudes. An infinite term is counted instead (+inf in the low,
//    -inf in the high 32 bits); a NaN makes the cell NaN, as a float sum
//    would.
// 3. table_gather_finish_kernel: each claimed entry's cells, their
//    integers times 2^-s in f32, into the output: a pass over the table's
//    entries in order, not over the terms.
// Three scattered passes (and the memsets) against index_add_'s one: on a
// 2048^2 image's texels read by 524,288 rays it is still slower than
// index_add_ (PERF.md).
//
// Nothing is allocated here and nothing synchronises: the wrapper
// allocates the output and the workspace with PyTorch's allocator, so the
// kernels can be captured.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SMS = 132;                   // an H100 SXM's SMs
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INF_BITS = 0x7f800000u;

// forward
constexpr long long FWD_SPAN = 16 * 1024;  // output bytes a CTA aims at
constexpr long long FWD_ROWS_MAX = 4096;   // rows of a CTA
constexpr long long FWD_TABLE_SMEM = 32 * 1024;   // a table staged up to this
constexpr long long FWD_MIN_CTAS = 2 * SMS;
constexpr long long FWD_DIRECT = 1 << 20;  // output bytes of a DIRECT call

// backward, tile route
constexpr int U = 8;                       // steps a thread loads at a time
constexpr int GT_MAX = 40;                 // rows of a tile: [40, 256] f32
constexpr int ROW_CELLS = 40;              // a table this small: a thread a row
constexpr int ROW_STEPS = 2;               // rays a thread takes, at least
constexpr long long ROW_CTAS = 2 * SMS;    // CTAs of ROWS mode, at most
constexpr int TILES_MAX = 16;              // the tile route's largest grid.y
constexpr int CTAS_PER_SM = 4;
constexpr long long TARGET_CTAS = CTAS_PER_SM * SMS;
constexpr int LOADS = (TARGET_CTAS + 31) / 32;   // partial sums of a lane
constexpr long long PART_MAX = 32768;      // partial sums a last CTA adds
constexpr int WIDE = 8;                    // a sum this long takes a warp
constexpr unsigned SLOTS = 4096;           // arrival counters

// backward, fixed-point route
constexpr int GRID_MAX = SMS * 16;         // CTAs of a grid-stride launch
constexpr unsigned EMPTY = 0xffffffffu;    // rows are below it

// The tile route's arrival counters (step 5 of the note).
__device__ unsigned g_arrivals[SLOTS];
std::atomic<unsigned> next_slot{0};

// The kernels of a backward call, by the slot the C entry counts them in.
enum Kernel { K_GRAD, K_SCALE, K_ADD, K_FINISH };

struct Plan {
  int kt, rps;                             // columns of a tile, rows a step
  int gt, k_tiles, g_tiles;
  long long n_chunks, chunk;               // chunks of rays, rays a chunk
  bool rows;                               // a thread a row (ROWS mode)
  bool fixed;                              // the fixed-point route
  int lg;                                  // ceil(log2 N), that route's
  long long cap;                           // its hash table's entries
};

Plan plan_of(long long n, long long g, long long k) {
  Plan p;
  p.kt = (int)(k < THREADS ? k : THREADS);
  p.rps = THREADS / p.kt;
  p.gt = (int)(g < GT_MAX ? g : GT_MAX);
  p.k_tiles = (int)((k + p.kt - 1) / p.kt);
  p.g_tiles = (int)((g + p.gt - 1) / p.gt);
  const long long tiles = (long long)p.k_tiles * p.g_tiles;
  p.fixed = tiles > TILES_MAX;
  p.lg = 0;
  while ((1LL << p.lg) < n) ++p.lg;
  const long long rows = n < g ? n : g;    // rows a call can reach
  p.cap = rows + rows / 2 + 32;
  // chunks: each thread at least one batch of U steps; at most
  // TARGET_CTAS in all; at most PART_MAX partial sums for a tile's last
  // CTA to add
  p.rows = g > 1 && tiles == 1 && g * k <= ROW_CELLS;
  const long long per = p.rows ? (long long)THREADS * ROW_STEPS
                               : (long long)p.rps * U;   // rays a CTA, least
  long long c = (n + per - 1) / per;
  const long long by_ctas = p.rows ? ROW_CTAS : TARGET_CTAS / tiles;
  const long long by_part = PART_MAX / ((long long)p.gt * p.kt);
  if (c > by_ctas) c = by_ctas;
  if (c > by_part) c = by_part;
  if (c < 1 || p.fixed) c = 1;
  p.chunk = (n + c - 1) / c;
  p.n_chunks = (n + p.chunk - 1) / p.chunk;
  return p;
}

template <typename I>
__device__ __forceinline__ long long clamped(const I* idx, long long i,
                                             long long g) {
  const long long v = (long long)idx[i];
  return v < 0 ? 0 : (v >= g ? g - 1 : v);
}

// Rows of a forward CTA: about FWD_SPAN bytes of output, fewer where the
// grid would not give each SM two CTAs; a multiple of 16, so that every
// CTA's span starts 16-byte aligned when the output does.
long long fwd_rows(long long n, long long row_bytes) {
  long long rows = (FWD_SPAN + row_bytes - 1) / row_bytes;
  const long long fill = (n + FWD_MIN_CTAS - 1) / FWD_MIN_CTAS;
  if (fill < rows) rows = fill;
  rows = (rows + 15) / 16 * 16;
  return rows < FWD_ROWS_MAX ? rows : FWD_ROWS_MAX;
}

// How a forward CTA reads the table.
enum FwdMode { TABLE_IN_SMEM, TABLE_IN_GLOBAL, DIRECT };

// out[i, :] = table[clamp(idx[i]), :] over rows of `upr` units of type T
// (4 bytes or 1), for the rows [blockIdx.x * rows, + rows); DIRECT: unit
// blockIdx.x * THREADS + threadIdx.x of the whole call.
template <typename T, int MODE, typename I>
__global__ void __launch_bounds__(THREADS)
table_gather_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                    T* __restrict__ out, long long n, long long g, int upr,
                    int rows) {
  if (MODE == DIRECT) {
    const int q = blockIdx.x * THREADS + threadIdx.x;
    if (q < (int)n * upr) {
      const int row = q / upr;
      out[q] = table[(int)clamped(idx, row, g) * upr + q - row * upr];
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  int* at = reinterpret_cast<int*>(smem);  // [rows]: each row's unit offset
  const T* tab = table;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)(n - r0 < rows ? n - r0 : rows);
  if (MODE == TABLE_IN_SMEM) {
    T* st = reinterpret_cast<T*>(smem + (size_t)rows * sizeof(int));
    const int units = (int)g * upr;
    for (int e = threadIdx.x; e < units; e += THREADS) st[e] = table[e];
    tab = st;
  }
  for (int i = threadIdx.x; i < nr; i += THREADS)
    at[i] = (int)clamped(idx, r0 + i, g) * upr;
  __syncthreads();

  T* dst = out + r0 * upr;
  const int total = nr * upr;
  constexpr int V = 16 / sizeof(T);        // units of a 16-byte store
  const int head = min(
      total, (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) /
                   sizeof(T)));
  const int body = (total - head) / V;
  for (int q = threadIdx.x; q < head; q += THREADS) {
    const int row = q / upr;
    dst[q] = tab[at[row] + q - row * upr];
  }
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  for (int c = threadIdx.x; c < body; c += THREADS) {
    const int q = head + c * V;
    int row = q / upr;
    int col = q - row * upr;
    union {
      uint4 v;
      T u[V];
    } w;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      w.u[j] = tab[at[row] + col];
      if (++col == upr) {
        col = 0;
        ++row;
      }
    }
    vdst[c] = w.v;
  }
  for (int q = head + body * V + threadIdx.x; q < total; q += THREADS) {
    const int row = q / upr;
    dst[q] = tab[at[row] + q - row * upr];
  }
}

// A warp's fixed-order sum: the shuffle tree of its lanes' values; lane
// 0 holds it.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  return s;
}

// How a tile-route CTA maps its threads onto the terms.
enum GradMode {
  ONE_ROW,   // a table of one row: a thread a column, no index to load
  ROWS,      // a table of at most ROW_CELLS cells: a thread a ray
  COLUMNS,   // else: a thread a column of a tile
};

// Steps 1 to 5 of the tile route: one (chunk, tile) per CTA.
template <int MODE, typename I>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
table_gather_grad_kernel(const float* __restrict__ grad,
                         const I* __restrict__ idx, float* __restrict__ out,
                         float* __restrict__ part, long long n, long long g,
                         long long k, Plan p, unsigned slot) {
  extern __shared__ float acc[];           // [cells, THREADS] or [gt, THREADS]
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long chunk = blockIdx.x;
  const int kti = blockIdx.y % p.k_tiles;
  const int gti = blockIdx.y / p.k_tiles;
  const int g0 = gti * p.gt;               // the tile route's g is small
  const long long k0 = (long long)kti * p.kt;
  const int gt = (int)(g - g0 < p.gt ? g - g0 : p.gt);
  const int kt = (int)(k - k0 < p.kt ? k - k0 : p.kt);
  const int last_row = (int)g - 1;
  const long long c0 = chunk * p.chunk;
  const long long c1 = c0 + p.chunk < n ? c0 + p.chunk : n;
  // each thread's sums: ONE_ROW in a register; ROWS in its column of
  // [cells, THREADS] in shared memory (cell r * K + c); COLUMNS in its
  // column of [gt, THREADS]
  float a1 = 0.0f;
  if (MODE == ROWS)
    for (int e = 0; e < gt * kt; ++e) acc[e * THREADS + t] = 0.0f;
  if (MODE == COLUMNS)
    for (int r = 0; r < gt; ++r) acc[r * THREADS + t] = 0.0f;

  if (MODE == ROWS) {
    // rays c0 + t, + THREADS, ...: one index a ray, then its K terms; two
    // rays' loads at a time
    const int kk = (int)k;
    for (long long i = c0 + t; i < c1; i += 2 * THREADS) {
      const long long j = i + THREADS;
      const bool two = j < c1;
      const long long x0 = (long long)idx[i];
      const long long x1 = two ? (long long)idx[j] : 0;
      const int r0 = x0 < 0 ? 0 : (x0 > last_row ? last_row : (int)x0);
      const int r1 = x1 < 0 ? 0 : (x1 > last_row ? last_row : (int)x1);
      const float* v0 = grad + i * k;
      const float* v1 = grad + j * k;
      float* s0 = acc + r0 * kk * THREADS + t;
      float* s1 = acc + r1 * kk * THREADS + t;
#pragma unroll 2
      for (int c = 0; c < kk; ++c) {
        const float a = v0[c];
        const float b = two ? v1[c] : 0.0f;
        s0[c * THREADS] += a;              // in ray order
        if (two) s1[c * THREADS] += b;
      }
    }
  } else {
    // column k0 + col of rays first, first + rps, ... below c1, reached by
    // pointers that step (no 64-bit products a term)
    const int col = t % p.kt;
    const int sub = t / p.kt;
    const bool reads = sub < p.rps && col < kt;
    const long long first = c0 + sub;
    const int steps =
        reads && first < c1 ? (int)((c1 - first + p.rps - 1) / p.rps) : 0;
    const float* gp = grad + first * k + k0 + col;
    const I* ip = idx + first;
    const int gs = p.rps * (int)k;         // a step's floats
    for (int s0 = 0; s0 < steps; s0 += U) {
      int row[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = s0 + u < steps;
        v[u] = in ? gp[u * gs] : 0.0f;
        if (MODE == COLUMNS) {
          const long long x = in ? (long long)ip[u * p.rps] : -1;
          const int r = (x < 0 ? 0 : (x > last_row ? last_row : (int)x)) - g0;
          row[u] = in && (unsigned)r < (unsigned)gt ? r : -1;
        }
      }
      gp += U * gs;
      ip += U * p.rps;
#pragma unroll
      for (int u = 0; u < U; ++u) {        // in ray order
        if (MODE == ONE_ROW)
          a1 += v[u];                      // 0 past the end: a1 is never -0
        else if (row[u] >= 0)
          acc[row[u] * THREADS + t] += v[u];
      }
    }
    if (MODE == ONE_ROW) acc[t] = a1;
  }
  __syncthreads();

  // step 4: each cell's sum over the threads of its column, in a fixed
  // order; to the output when there is one chunk, else to the workspace
  // (cell e's values: acc[e * THREADS + j], j < THREADS, in ROWS mode;
  // acc[r * THREADS + j * kt + c], j < rps, else)
  const int cells = gt * kt;
  const int warp = t >> 5, lane = t & 31;
  const bool one = p.n_chunks == 1;
  const int count = MODE == ROWS ? THREADS : p.rps;
  const int stride = MODE == ROWS ? 1 : p.kt;
  if (count >= WIDE) {
    for (int e = warp; e < cells; e += THREADS / 32) {
      const int r = e / kt, c = e - r * kt;
      const float* src = acc + (MODE == ROWS ? e * THREADS : r * THREADS + c);
      float s = 0.0f;
      for (int j = lane; j < count; j += 32) s += src[j * stride];
      s = warp_sum(s);
      if (lane == 0) {
        const long long gc = (g0 + r) * k + k0 + c;
        if (one)
          out[gc] = s;
        else
          part[gc * p.n_chunks + chunk] = s;
      }
    }
  } else {
    for (int e = t; e < cells; e += THREADS) {
      const int r = e / kt, c = e - r * kt;
      const float* src = acc + r * THREADS + c;   // COLUMNS, rps < WIDE
      float s = 0.0f;
      for (int j = 0; j < count; ++j) s += src[j * stride];
      const long long gc = (g0 + r) * k + k0 + c;
      if (one)
        out[gc] = s;
      else
        part[gc * p.n_chunks + chunk] = s;
    }
  }
  if (one) return;

  // step 5: the tile's last CTA adds the partial sums in chunk order
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicInc(&g_arrivals[slot + blockIdx.y],
                     (unsigned)(p.n_chunks - 1)) ==
           (unsigned)(p.n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int m = (int)p.n_chunks;
  if (m >= WIDE) {
    // a warp a cell, lane l over chunks l, l + 32, ...: every load of the
    // cell issued before the first add
    for (int e = warp; e < cells; e += THREADS / 32) {
      const int r = e / kt, c = e - r * kt;
      const long long gc = (g0 + r) * k + k0 + c;
      const float* src = part + gc * m;
      float v[LOADS];
#pragma unroll
      for (int q = 0; q < LOADS; ++q) {
        const int j = lane + 32 * q;
        v[q] = j < m ? __ldcg(src + j) : 0.0f;
      }
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < LOADS; ++q) s += v[q];
      s = warp_sum(s);
      if (lane == 0) out[gc] = s;
    }
  } else {
    for (int e = t; e < cells; e += THREADS) {
      const int r = e / kt, c = e - r * kt;
      const long long gc = (g0 + r) * k + k0 + c;
      float v[WIDE];
#pragma unroll
      for (int j = 0; j < WIDE; ++j)
        v[j] = j < m ? __ldcg(part + gc * m + j) : 0.0f;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < WIDE; ++j) s += v[j];
      out[gc] = s;
    }
  }
}

// The fixed-point route's scale 2^s of a cell whose largest magnitude has
// the bits mb (finite, not 0): |v| < 2^(E + 1) for its exponent E.
__device__ __forceinline__ int fixed_shift(unsigned mb, int lg) {
  const int field = (int)(mb >> 23);
  const int e = (field ? field : 1) - 127;   // E (a subnormal: -126)
  return 61 - e - lg;
}

// The fixed-point route's hash table: cap entries of `stride` bytes, each
// a row's key (the row + 1; 0: free), its K cells' largest |v| bits and,
// 8-byte aligned after them, their int64 sums; side by side, so that a
// term touches one or two sectors of its entry.
struct Entries {
  unsigned char* base;
  long long stride;                        // bytes an entry
  long long sums;                          // byte offset of the sums
  unsigned cap;
  __device__ __forceinline__ unsigned* key(unsigned s) const {
    return reinterpret_cast<unsigned*>(base + s * stride);
  }
  __device__ __forceinline__ unsigned* maxbits(unsigned s, long long c) const {
    return key(s) + 1 + c;
  }
  __device__ __forceinline__ unsigned long long* acc(unsigned s,
                                                     long long c) const {
    return reinterpret_cast<unsigned long long*>(base + s * stride + sums) + c;
  }
};

// An entry's bytes and its sums' offset, for K columns.
long long entry_sums(long long k) { return (4 + 4 * k + 7) / 8 * 8; }
long long entry_bytes(long long k) { return entry_sums(k) + 8 * k; }

// A row's first entry to try: Knuth's multiplicative hash, scaled to cap.
__device__ __forceinline__ unsigned home_of(unsigned row, unsigned cap) {
  return (unsigned)(((unsigned long long)(row * 2654435761u) * cap) >> 32);
}

__device__ __forceinline__ unsigned next_of(unsigned s, unsigned cap) {
  return s + 1 == cap ? 0 : s + 1;
}

// The entry of `row`, claimed if it has none (step 1).
__device__ __forceinline__ unsigned claim(const Entries& h, unsigned row) {
  for (unsigned s = home_of(row, h.cap);; s = next_of(s, h.cap)) {
    unsigned k = __ldcg(h.key(s));
    if (k == 0) k = atomicCAS(h.key(s), 0u, row + 1);
    if (k == 0 || k == row + 1) return s;
  }
}

// The entry of `row`, claimed before (step 2).
__device__ __forceinline__ unsigned find(const Entries& h, unsigned row) {
  unsigned s = home_of(row, h.cap);
  while (__ldcg(h.key(s)) != row + 1) s = next_of(s, h.cap);
  return s;
}

// Term e of a call of n rays x k columns: its ray (as 32-bit division
// where the terms allow) and column.
__device__ __forceinline__ void term_of(long long e, long long k, bool narrow,
                                        long long& i, long long& c) {
  i = narrow ? (long long)((unsigned)e / (unsigned)k) : e / k;
  c = e - i * k;
}

// Fixed-point route, step 1: every reached row's entry and every reached
// cell's largest |v|.
template <typename I>
__global__ void table_gather_scale_kernel(const float* __restrict__ grad,
                                          const I* __restrict__ idx,
                                          Entries h, long long n, long long g,
                                          long long k) {
  const long long total = n * k;
  const bool narrow = total <= (long long)UINT32_MAX;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long i, c;
    term_of(e, k, narrow, i, c);
    const unsigned s = claim(h, (unsigned)clamped(idx, i, g));
    unsigned* m = h.maxbits(s, c);
    const unsigned b = __float_as_uint(grad[e]) & 0x7fffffffu;
    if (b > __ldcg(m)) atomicMax(m, b);    // the maximum only grows
  }
}

// Fixed-point route, step 2: every term, as an integer on its cell's
// scale, added into the cell (an infinite one counted by its sign).
template <typename I>
__global__ void table_gather_add_kernel(const float* __restrict__ grad,
                                        const I* __restrict__ idx, Entries h,
                                        long long n, long long g, long long k,
                                        int lg) {
  const long long total = n * k;
  const bool narrow = total <= (long long)UINT32_MAX;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const float v = grad[e];
    if (v == 0.0f) continue;
    long long i, c;
    term_of(e, k, narrow, i, c);
    const unsigned s = find(h, (unsigned)clamped(idx, i, g));
    const unsigned mb = __ldcg(h.maxbits(s, c));
    if (mb > INF_BITS) continue;           // a NaN cell
    if (mb == INF_BITS) {
      if (isinf(v)) atomicAdd(h.acc(s, c), v > 0.0f ? 1ull : 1ull << 32);
      continue;
    }
    const long long q = __double2ll_rn(ldexp((double)v, fixed_shift(mb, lg)));
    atomicAdd(h.acc(s, c), (unsigned long long)q);
  }
}

// Fixed-point route, step 3: every claimed entry's cells = their integers
// times 2^-s, into the output rows of the entries' keys.
__global__ void table_gather_finish_kernel(Entries h, float* __restrict__ out,
                                           long long k, int lg) {
  const long long total = (long long)h.cap * k;
  const bool narrow = total <= (long long)UINT32_MAX;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long s, c;
    term_of(e, k, narrow, s, c);
    const unsigned key = *h.key((unsigned)s);
    if (key == 0) continue;                // a free entry
    const unsigned mb = *h.maxbits((unsigned)s, c);
    const unsigned long long sum = *h.acc((unsigned)s, c);
    float r;
    if (mb == 0) {
      r = 0.0f;
    } else if (mb > INF_BITS) {
      r = __uint_as_float(0x7fc00000u);
    } else if (mb == INF_BITS) {
      const bool pos = (sum & 0xffffffffull) != 0, neg = (sum >> 32) != 0;
      r = pos && neg ? __uint_as_float(0x7fc00000u)
                     : __uint_as_float(pos ? INF_BITS : INF_BITS | 1u << 31);
    } else {
      r = (float)ldexp((double)(long long)sum, -fixed_shift(mb, lg));
    }
    out[(long long)(key - 1) * k + c] = r;
  }
}

unsigned grid_of(long long total) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  return (unsigned)(blocks < GRID_MAX ? blocks : GRID_MAX);
}

template <typename T, typename I>
int launch_forward(const void* table, const void* idx, void* out, long long n,
                   long long g, long long upr, cudaStream_t st) {
  const T* tab = static_cast<const T*>(table);
  const I* ix = static_cast<const I*>(idx);
  T* dst = static_cast<T*>(out);
  if (n * upr * (long long)sizeof(T) <= FWD_DIRECT) {
    const long long units = n * upr;
    table_gather_kernel<T, DIRECT, I>
        <<<(unsigned)((units + THREADS - 1) / THREADS), THREADS, 0, st>>>(
            tab, ix, dst, n, g, (int)upr, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const long long rows = fwd_rows(n, upr * (long long)sizeof(T));
  const long long tbytes = g * upr * (long long)sizeof(T);
  const bool staged = tbytes <= FWD_TABLE_SMEM &&
                      4 * tbytes <= rows * upr * (long long)sizeof(T);
  const size_t smem = (size_t)rows * sizeof(int) +
                      (staged ? (size_t)(tbytes + 15) / 16 * 16 : 0);
  const unsigned grid = (unsigned)((n + rows - 1) / rows);
  if (staged)
    table_gather_kernel<T, TABLE_IN_SMEM, I><<<grid, THREADS, smem, st>>>(
        tab, ix, dst, n, g, (int)upr, (int)rows);
  else
    table_gather_kernel<T, TABLE_IN_GLOBAL, I><<<grid, THREADS, smem, st>>>(
        tab, ix, dst, n, g, (int)upr, (int)rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_forward_units(const void* table, const void* idx, void* out,
                         long long n, long long g, long long row_bytes,
                         int unit, cudaStream_t st) {
  if (unit == 4)
    return launch_forward<uint32_t, I>(table, idx, out, n, g, row_bytes / 4,
                                       st);
  return launch_forward<uint8_t, I>(table, idx, out, n, g, row_bytes, st);
}

// Counts each kernel it launches in launched[Kernel].
template <typename I>
int launch_backward(const float* grad, const void* idx, float* out,
                    void* work, long long n, long long g, long long k,
                    cudaStream_t st, int* launched) {
  const Plan p = plan_of(n, g, k);
  const I* ix = static_cast<const I*>(idx);
  cudaError_t e;
  if (p.fixed) {
    Entries h;
    h.base = static_cast<unsigned char*>(work);
    h.stride = entry_bytes(k);
    h.sums = entry_sums(k);
    h.cap = (unsigned)p.cap;
    const unsigned grid = grid_of(n * k);
    if ((e = cudaMemsetAsync(out, 0, (size_t)(g * k) * sizeof(float), st)) ||
        (e = cudaMemsetAsync(work, 0, (size_t)(p.cap * h.stride), st)))
      return static_cast<int>(e);
    table_gather_scale_kernel<I><<<grid, THREADS, 0, st>>>(grad, ix, h, n, g,
                                                          k);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++launched[K_SCALE];
    table_gather_add_kernel<I><<<grid, THREADS, 0, st>>>(grad, ix, h, n, g, k,
                                                        p.lg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++launched[K_ADD];
    table_gather_finish_kernel<<<grid_of(p.cap * k), THREADS, 0, st>>>(
        h, out, k, p.lg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++launched[K_FINISH];
    return 0;
  }
  const unsigned slot = next_slot.fetch_add(TILES_MAX) % SLOTS;
  float* part = static_cast<float*>(work);
  const dim3 grid((unsigned)p.n_chunks, (unsigned)(p.k_tiles * p.g_tiles));
  if (g == 1)
    table_gather_grad_kernel<ONE_ROW, I><<<grid, THREADS, THREADS * 4, st>>>(
        grad, ix, out, part, n, g, k, p, slot);
  else if (p.rows)
    table_gather_grad_kernel<ROWS, I>
        <<<grid, THREADS, (size_t)g * k * THREADS * 4, st>>>(
            grad, ix, out, part, n, g, k, p, slot);
  else
    table_gather_grad_kernel<COLUMNS, I>
        <<<grid, THREADS, (size_t)p.gt * THREADS * 4, st>>>(
            grad, ix, out, part, n, g, k, p, slot);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++launched[K_GRAD];
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Every pointer is device memory,
// launches go on `stream`; each returns the first CUDA error of its
// launches (0 when all were accepted). n > 0, g > 0 and k > 0.

// The backward's workspace for n indices into a [g, k] table, in 4-byte
// words: g * k * chunks floats on the tile route when it cuts the rays
// into more than one chunk; on the fixed-point route the hash table, cap
// entries of a u32 key, k u32 maxima and k int64 sums; else 0.
extern "C" long long table_gather_workspace(long long n, long long g,
                                            long long k) {
  const Plan p = plan_of(n, g, k);
  if (p.fixed) return p.cap * entry_bytes(k) / 4;
  return p.n_chunks > 1 ? g * k * p.n_chunks : 0;
}

// The backward's route for n indices into a [g, k] table: 1 for the
// fixed-point route, 0 for the tile route.
extern "C" int table_gather_fixed(long long n, long long g, long long k) {
  return plan_of(n, g, k).fixed ? 1 : 0;
}

// out [n, row_bytes] = the table's rows [g, row_bytes]; `unit` (4 or 1)
// divides row_bytes and both pointers' alignment; g * row_bytes / unit
// < 2^31.
extern "C" int table_gather_forward(const void* table, const void* idx,
                                    int idx64, void* out, long long n,
                                    long long g, long long row_bytes,
                                    int unit, void* stream) {
  if (g * (row_bytes / unit) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_forward_units<int64_t>(table, idx, out, n, g,
                                               row_bytes, unit, st)
               : launch_forward_units<int32_t>(table, idx, out, n, g,
                                               row_bytes, unit, st);
}

// out [g, k] f32 = the sums of grad [n, k] f32 by index; work: the
// workspace of table_gather_workspace's size, 8-byte aligned (unused when
// that is 0); n < 2^31, g < 2^32 - 1. Adds one to launched[i] for each
// kernel it launches: 0 table_gather_grad_kernel,
// 1 table_gather_scale_kernel, 2 table_gather_add_kernel,
// 3 table_gather_finish_kernel.
extern "C" int table_gather_backward(const float* grad, const void* idx,
                                     int idx64, float* out, void* work,
                                     long long n, long long g, long long k,
                                     void* stream, int* launched) {
  if (g >= (long long)EMPTY) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_backward<int64_t>(grad, idx, out, work, n, g, k, st,
                                          launched)
               : launch_backward<int32_t>(grad, idx, out, work, n, g, k, st,
                                          launched);
}
