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
// arithmetic: the forward reads N indices and writes N rows (the table
// itself stays in L1/L2), the backward reads N indices and N gradient rows
// and writes G rows. The floor is the bytes over 3.35 TB/s.
//
// Why not atomics. The rays of a train batch land on a handful of rows
// (the flagship scene has five primitives), so a float atomicAdd per
// (ray, column) would serialise on those rows and add in an order that
// changes from run to run; the port's graphed and eager train steps must
// give the same bits. PyTorch's own indexing backward sorts the indices and
// lets one warp walk each row's duplicates one after another, which holds
// a few hundred thousand rays to one row in a single serial chain.
//
// The backward takes one of two routes, by the table's size; the route
// and the launch configuration depend only on (N, G, K), so the same
// inputs give the same bits on every call, eagerly or in a CUDA graph
// replay.
//
// The tile route, for tables of at most TILES_MAX tiles (G up to about a
// thousand rows at K = 3, 900 at K = 27; every table of the train cells):
// 1. Grid (chunk, tile). The rays are cut into n_chunks equal contiguous
//    chunks; the table's rows and columns into tiles of GT rows x KT
//    columns, so that a CTA's accumulators fit 48 KB of shared memory.
// 2. Groups own accumulators. A CTA's 256 threads form NG groups of TPR
//    threads (TPR = KT rounded up to a power of two, at most 32). Each
//    group keeps its own [GT, KT] accumulators in shared memory, its
//    threads over the columns, and walks the rays grp, grp + NG, ... of
//    the chunk in order, U rays at a time (their loads issued first). No
//    two threads ever add into one address, so no atomics are needed and
//    every sum is taken in one fixed order.
// 3. The CTA adds its groups' accumulators in group order and writes its
//    partial sum to a workspace [G * K, n_chunks] (or, for one chunk,
//    straight to the output).
// 4. table_gather_reduce_kernel: one warp per (row, column), its lanes
//    over the chunks in order, then a fixed shuffle tree.
// Every CTA reads all of its chunk's indices, so the work grows with the
// number of tiles; past TILES_MAX the other route is cheaper.
//
// The fixed-point route, for larger tables (an image's texels: 2048^2
// rows), whose work does not grow with G: integer sums are exact, so
// integer atomics give the same bits in any order.
// 1. table_gather_scale_kernel: each (row, column) cell's largest
//    magnitude, as the bits of |v| (atomicMax; an order-free maximum).
// 2. table_gather_add_kernel: each term v becomes the integer
//    round(v * 2^s), s chosen per cell from its largest magnitude 2^E
//    and L = ceil(log2 N) so that N such terms cannot overflow 63 bits
//    (s = 61 - E - L), and is added into the cell's int64 (atomicAdd).
//    The rounding costs each term at most 2^(E + L - 62): the sum is off
//    by at most N^2 2^(E - 62), 2^-28 of the cell's largest term at
//    N = 2^17, where an f32 sum may be off by N 2^-24 of the terms'
//    magnitudes. An infinite term
//    is counted instead (+inf in the low, -inf in the high 32 bits); a
//    NaN makes the cell NaN, as a float sum would.
// 3. table_gather_finish_kernel: each cell's integer times 2^-s, in f32.
// The workspace, [G * K] int64 then [G * K] u32, is zeroed on the stream
// (cudaMemsetAsync, which a graph captures as a memset node).
//
// Nothing is allocated here and nothing synchronises: the wrapper
// allocates the output and the workspace with PyTorch's allocator, so the
// kernels can be captured.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;                       // rays a group loads at a time
constexpr int SMEM_BYTES = 48 * 1024;      // the accumulators' budget
constexpr int KT_MAX = 512;                // columns of a tile
constexpr int TARGET_CTAS = 512;           // CTAs of a backward launch
constexpr int MIN_RAYS_PER_GROUP = 16;
constexpr int TILES_MAX = 16;              // the tile route's largest grid.y
constexpr int GRID_MAX = 132 * 16;         // CTAs of a grid-stride launch
constexpr unsigned INF_BITS = 0x7f800000u;

// The kernels of a backward call, by the slot the C entry counts them in.
enum Kernel { K_GRAD, K_REDUCE, K_SCALE, K_ADD, K_FINISH };

struct Plan {
  int tpr, ng, kt, gt, k_tiles, g_tiles;
  long long n_chunks, chunk;
  bool fixed;                              // the fixed-point route
  int lg;                                  // ceil(log2 N), that route's
};

Plan plan_of(long long n, long long g, long long k) {
  Plan p;
  p.kt = (int)(k < KT_MAX ? k : KT_MAX);
  p.tpr = 1;
  while (p.tpr < p.kt && p.tpr < 32) p.tpr *= 2;
  p.ng = THREADS / p.tpr;
  long long gt = SMEM_BYTES / ((long long)p.ng * p.kt * 4);
  if (gt < 1) gt = 1;
  p.gt = (int)(gt < g ? gt : g);
  p.k_tiles = (int)((k + p.kt - 1) / p.kt);
  p.g_tiles = (int)((g + p.gt - 1) / p.gt);
  const long long tiles = (long long)p.k_tiles * p.g_tiles;
  p.fixed = tiles > TILES_MAX;
  p.lg = 0;
  while ((1LL << p.lg) < n) ++p.lg;
  long long by_rays = n / ((long long)p.ng * MIN_RAYS_PER_GROUP);
  long long by_ctas = (TARGET_CTAS + tiles - 1) / tiles;
  long long c = by_rays < by_ctas ? by_rays : by_ctas;
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

// out[i, w] = table[clamp(idx[i]), w] over rows of `wpr` words of type W.
template <typename W, typename I>
__global__ void table_gather_kernel(const W* __restrict__ table,
                                    const I* __restrict__ idx,
                                    W* __restrict__ out, long long n,
                                    long long g, long long wpr) {
  const long long total = n * wpr;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / wpr;
    const long long w = e - i * wpr;
    out[e] = table[clamped(idx, i, g) * wpr + w];
  }
}

// Step 1 to 3 of the backward: one (chunk, tile) per CTA.
template <typename I>
__global__ void __launch_bounds__(THREADS)
table_gather_grad_kernel(const float* __restrict__ grad,
                         const I* __restrict__ idx, float* __restrict__ part,
                         long long n, long long g, long long k, Plan p) {
  extern __shared__ float acc[];           // [NG, GT, KT]
  const long long chunk = blockIdx.x;
  const int kti = blockIdx.y % p.k_tiles;
  const int gti = blockIdx.y / p.k_tiles;
  const long long g0 = (long long)gti * p.gt;
  const long long k0 = (long long)kti * p.kt;
  const int gt = (int)(g - g0 < p.gt ? g - g0 : p.gt);
  const int kt = (int)(k - k0 < p.kt ? k - k0 : p.kt);
  const int cells = p.gt * p.kt;
  for (int e = threadIdx.x; e < p.ng * cells; e += THREADS) acc[e] = 0.0f;
  __syncthreads();

  const int grp = threadIdx.x / p.tpr;
  const int lane = threadIdx.x - grp * p.tpr;
  float* mine = acc + (long long)grp * cells;
  const long long c0 = chunk * p.chunk;
  const long long c1 = c0 + p.chunk < n ? c0 + p.chunk : n;
  for (long long i0 = c0 + grp; i0 < c1; i0 += (long long)U * p.ng) {
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + (long long)u * p.ng;
      const long long r = i < c1 ? clamped(idx, i, g) - g0 : -1;
      row[u] = (r >= 0 && r < gt) ? (int)r : -1;
    }
    for (int c = lane; c < kt; c += p.tpr) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = row[u] >= 0
                   ? grad[(i0 + (long long)u * p.ng) * k + k0 + c]
                   : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u)       // in ray order
        if (row[u] >= 0) mine[row[u] * p.kt + c] += v[u];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < gt * p.kt; e += THREADS) {
    const int r = e / p.kt;
    const int c = e - r * p.kt;
    if (c >= kt) continue;
    float s = 0.0f;
    for (int q = 0; q < p.ng; ++q) s += acc[(long long)q * cells + e];
    part[((g0 + r) * k + k0 + c) * p.n_chunks + chunk] = s;
  }
}

// Step 4: out[e] = the chunks' partial sums of e, in a fixed order.
__global__ void table_gather_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           long long cells,
                                           long long n_chunks) {
  const long long e =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (e >= cells) return;                  // whole warps leave together
  float s = 0.0f;
  for (long long c = lane; c < n_chunks; c += 32) s += part[e * n_chunks + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[e] = s;
}

// The fixed-point route's scale 2^s of a cell whose largest magnitude has
// the bits mb (finite, not 0): |v| < 2^(E + 1) for its exponent E.
__device__ __forceinline__ int fixed_shift(unsigned mb, int lg) {
  const int field = (int)(mb >> 23);
  const int e = (field ? field : 1) - 127;   // E (a subnormal: -126)
  return 61 - e - lg;
}

// Fixed-point route, step 1: every cell's largest |v|, as its bits.
template <typename I>
__global__ void table_gather_scale_kernel(const float* __restrict__ grad,
                                          const I* __restrict__ idx,
                                          unsigned* __restrict__ maxbits,
                                          long long n, long long g,
                                          long long k) {
  const long long total = n * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / k;
    unsigned* cell = maxbits + clamped(idx, i, g) * k + (e - i * k);
    const unsigned b = __float_as_uint(grad[e]) & 0x7fffffffu;
    if (b > __ldcg(cell)) atomicMax(cell, b);   // the maximum only grows
  }
}

// Fixed-point route, step 2: every term, as an integer on its cell's
// scale, added into the cell (an infinite one counted by its sign).
template <typename I>
__global__ void table_gather_add_kernel(const float* __restrict__ grad,
                                        const I* __restrict__ idx,
                                        const unsigned* __restrict__ maxbits,
                                        unsigned long long* __restrict__ acc,
                                        long long n, long long g, long long k,
                                        int lg) {
  const long long total = n * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / k;
    const long long cell = clamped(idx, i, g) * k + (e - i * k);
    const float v = grad[e];
    const unsigned mb = maxbits[cell];
    if (v == 0.0f || mb > INF_BITS) continue;   // nothing, or a NaN cell
    if (mb == INF_BITS) {
      if (isinf(v)) atomicAdd(acc + cell, v > 0.0f ? 1ull : 1ull << 32);
      continue;
    }
    const long long q = __double2ll_rn(ldexp((double)v, fixed_shift(mb, lg)));
    atomicAdd(acc + cell, (unsigned long long)q);
  }
}

// Fixed-point route, step 3: out = each cell's integer times 2^-s.
__global__ void table_gather_finish_kernel(
    const unsigned* __restrict__ maxbits,
    const unsigned long long* __restrict__ acc, float* __restrict__ out,
    long long cells, int lg) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < cells; e += (long long)gridDim.x * blockDim.x) {
    const unsigned mb = maxbits[e];
    const unsigned long long s = acc[e];
    float r;
    if (mb == 0) {
      r = 0.0f;
    } else if (mb > INF_BITS) {
      r = __uint_as_float(0x7fc00000u);
    } else if (mb == INF_BITS) {
      const bool pos = (s & 0xffffffffull) != 0, neg = (s >> 32) != 0;
      r = pos && neg ? __uint_as_float(0x7fc00000u)
                     : __uint_as_float(pos ? INF_BITS : INF_BITS | 1u << 31);
    } else {
      r = (float)ldexp((double)(long long)s, -fixed_shift(mb, lg));
    }
    out[e] = r;
  }
}

unsigned grid_of(long long total) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  return (unsigned)(blocks < GRID_MAX ? blocks : GRID_MAX);
}

template <typename W, typename I>
int launch_forward(const void* table, const void* idx, void* out, long long n,
                   long long g, long long wpr, cudaStream_t st) {
  table_gather_kernel<W, I><<<grid_of(n * wpr), THREADS, 0, st>>>(
      static_cast<const W*>(table), static_cast<const I*>(idx),
      static_cast<W*>(out), n, g, wpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_forward_words(const void* table, const void* idx, void* out,
                         long long n, long long g, long long row_bytes,
                         int word, cudaStream_t st) {
  const long long wpr = row_bytes / word;
  switch (word) {
    case 16: return launch_forward<uint4, I>(table, idx, out, n, g, wpr, st);
    case 8: return launch_forward<uint2, I>(table, idx, out, n, g, wpr, st);
    case 4: return launch_forward<uint32_t, I>(table, idx, out, n, g, wpr, st);
    default: return launch_forward<uint8_t, I>(table, idx, out, n, g, wpr, st);
  }
}

// Counts each kernel it launches in launched[Kernel].
template <typename I>
int launch_backward(const float* grad, const void* idx, float* out,
                    void* work, long long n, long long g, long long k,
                    cudaStream_t st, int* launched) {
  const Plan p = plan_of(n, g, k);
  const I* ix = static_cast<const I*>(idx);
  const long long cells = g * k;
  cudaError_t e;
  if (p.fixed) {
    auto* acc = static_cast<unsigned long long*>(work);
    auto* maxbits = reinterpret_cast<unsigned*>(acc + cells);
    e = cudaMemsetAsync(work, 0, (size_t)cells * 12, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    table_gather_scale_kernel<I><<<grid_of(n * k), THREADS, 0, st>>>(
        grad, ix, maxbits, n, g, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++launched[K_SCALE];
    table_gather_add_kernel<I><<<grid_of(n * k), THREADS, 0, st>>>(
        grad, ix, maxbits, acc, n, g, k, p.lg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++launched[K_ADD];
    table_gather_finish_kernel<<<grid_of(cells), THREADS, 0, st>>>(
        maxbits, acc, out, cells, p.lg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++launched[K_FINISH];
    return 0;
  }
  float* dst = p.n_chunks == 1 ? out : static_cast<float*>(work);
  const dim3 grid((unsigned)p.n_chunks, (unsigned)(p.k_tiles * p.g_tiles));
  const size_t smem = (size_t)p.ng * p.gt * p.kt * sizeof(float);
  table_gather_grad_kernel<I><<<grid, THREADS, smem, st>>>(
      grad, ix, dst, n, g, k, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++launched[K_GRAD];
  if (p.n_chunks == 1) return 0;
  const long long blocks = (cells * 32 + THREADS - 1) / THREADS;
  table_gather_reduce_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const float*>(work), out, cells, p.n_chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++launched[K_REDUCE];
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Every pointer is device memory,
// launches go on `stream`; each returns the first CUDA error of its
// launches (0 when all were accepted). n > 0, g > 0 and k > 0.

// The backward's workspace for n indices into a [g, k] table, in 4-byte
// words: g * k * chunks floats on the tile route when it cuts the rays
// into more than one chunk, g * k int64 + g * k u32 on the fixed-point
// route, else 0.
extern "C" long long table_gather_workspace(long long n, long long g,
                                            long long k) {
  const Plan p = plan_of(n, g, k);
  if (p.fixed) return g * k * 3;
  return p.n_chunks > 1 ? g * k * p.n_chunks : 0;
}

// The backward's route for n indices into a [g, k] table: 1 for the
// fixed-point route, 0 for the tile route.
extern "C" int table_gather_fixed(long long n, long long g, long long k) {
  return plan_of(n, g, k).fixed ? 1 : 0;
}

// out [n, row_bytes] = the table's rows [g, row_bytes]; `word` (1, 4, 8 or
// 16) divides row_bytes and both pointers' alignment.
extern "C" int table_gather_forward(const void* table, const void* idx,
                                    int idx64, void* out, long long n,
                                    long long g, long long row_bytes,
                                    int word, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_forward_words<int64_t>(table, idx, out, n, g,
                                               row_bytes, word, st)
               : launch_forward_words<int32_t>(table, idx, out, n, g,
                                               row_bytes, word, st);
}

// out [g, k] f32 = the sums of grad [n, k] f32 by index; work: the
// workspace of table_gather_workspace's size, 8-byte aligned (unused when
// that is 0); n < 2^31. Adds one to launched[i] for each kernel it
// launches: 0 table_gather_grad_kernel, 1 table_gather_reduce_kernel,
// 2 table_gather_scale_kernel, 3 table_gather_add_kernel,
// 4 table_gather_finish_kernel.
extern "C" int table_gather_backward(const float* grad, const void* idx,
                                     int idx64, float* out, void* work,
                                     long long n, long long g, long long k,
                                     void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return idx64 ? launch_backward<int64_t>(grad, idx, out, work, n, g, k, st,
                                          launched)
               : launch_backward<int32_t>(grad, idx, out, work, n, g, k, st,
                                          launched);
}
