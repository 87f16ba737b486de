// csg_filter_kernel: the CSG filter of one root's columns, each row's hits
// walked in registers, in one launch.
//
// Replaces no TPU kernel. The JAX package leaves its filter
// (raytracer_tpu/core/csg.py::_filter_pairwise) to XLA. The port's plain
// version (raytracer_tpu_torch/core/csg.py::_filter_pairwise) builds an
// [R, C, C] bool table of which hit comes before which, ANDs it with each
// node's masks and sums it as int64: about 40 PyTorch kernels a call, and
// on the shadow path of an area light (R = a tile's rays x 100 samples =
// 409,600 rows of 16 columns) 85% of a frame's device time on the H100.
// Python side: raytracer_tpu_torch/ops/csg_cuda.py (the wrapper, the
// packed plan and the route: only where no gradient is needed, the kernel
// having no backward).
//
// What it computes, for each row r of ts [R, n_cols] (f32, contiguous):
// the root's columns cols[0..cr) are its hits t_k. Hit i comes before hit
// j when t_i < t_j, or t_i == t_j and i < j (the plain version's
// `earlier`, so NaN, +-inf, negatives and ties order as there). A hit is
// alive while finite. For each node of the root, bottom-up (csg.py's
// _node_plan order): relevant = under & alive; in_l before hit j is the
// parity of the relevant left-child hits before j, in_r of the relevant
// right-child hits; the op's truth table (csg.rs:117-123) decides each
// relevant hit, which stays alive or dies. Out: the same row with every
// root column that is not alive at the end set to +inf; the other columns
// copied. Bit for bit torch.where(alive, sub, inf) of the plain version,
// since a kept hit is its own t copied.
//
// What bounds it on an H100. A row's output depends only on its own C
// floats and on the plan (per-scene constants, passed as kernel
// arguments), so the least it must move is C floats read and C written a
// row: 409,600 x 16 x 4 B x 2 = 52.4 MB a shadow call, 15.6 us at 3.35
// TB/s. The work is cr^2 comparisons (256 for 16 columns) and two
// popcounts a column a node: far under the bytes. So one thread a row,
// everything in registers: the row's t values, for each column j a 32-bit
// mask of the columns before it, the alive mask; the node loop reads its
// op and masks from the constant bank (__grid_constant__). No [R, C, C]
// table is built anywhere, and each row is read once and written once. Templated
// on the width bucket (16, 32), so the loops over columns unroll and the
// arrays stay in registers; wider roots keep the plain paths.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NODES = 64;   // scene/builder.py: uint64 membership masks

// core/types.py CSG ops
enum { CSG_UNION = 0, CSG_INTERSECT = 1, CSG_DIFFERENCE = 2 };

// One root's plan over its columns, bit k of a mask for root column k.
template <int CR>
struct Plan {
  int cr;                    // the root's columns, 1..CR
  int n_nodes;               // its nodes, bottom-up
  int cols[CR];              // the row's column of each root column
  int op[MAX_NODES];         // each node's op
  uint32_t under[MAX_NODES]; // root columns in the node's subtree
  uint32_t left[MAX_NODES];  // root columns in the node's left child
};

__device__ __forceinline__ float kept(float t, uint32_t alive, int k) {
  return (alive >> k) & 1u ? t : __int_as_float(0x7f800000);
}

template <int CR>
__global__ void __launch_bounds__(THREADS)
    csg_filter_kernel(const float* __restrict__ src, float* __restrict__ dst,
                      long long n_rows, int n_cols,
                      const int* __restrict__ others, int n_others,
                      const __grid_constant__ Plan<CR> plan) {
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n_rows) return;
  const float* s = src + row * n_cols;
  float* d = dst + row * n_cols;
  const int cr = plan.cr;
  const float inf = __int_as_float(0x7f800000);

  float t[CR];
#pragma unroll
  for (int k = 0; k < CR; ++k) t[k] = k < cr ? s[plan.cols[k]] : inf;

  // before[j] bit i: hit i comes before hit j (t_i < t_j, or a tie and
  // i < j: t_i <= t_j). Padding columns (k >= cr) are +inf, never alive
  // and under no node, so their bits are masked off below.
  uint32_t before[CR];
#pragma unroll
  for (int j = 0; j < CR; ++j) {
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      if (i < j) m |= (uint32_t)(t[i] <= t[j]) << i;
      if (i > j) m |= (uint32_t)(t[i] < t[j]) << i;
    }
    before[j] = m;
  }
  uint32_t alive = 0;
#pragma unroll
  for (int k = 0; k < CR; ++k) alive |= (uint32_t)isfinite(t[k]) << k;

  for (int n = 0; n < plan.n_nodes; ++n) {
    const uint32_t left = plan.left[n];
    const uint32_t rel = plan.under[n] & alive;
    const uint32_t rel_l = rel & left, rel_r = rel & ~left;
    uint32_t in_l = 0, in_r = 0;
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      in_l |= (uint32_t)(__popc(before[j] & rel_l) & 1) << j;
      in_r |= (uint32_t)(__popc(before[j] & rel_r) & 1) << j;
    }
    uint32_t allowed;  // csg.rs:117-123, a bit a column (l_hit = left)
    switch (plan.op[n]) {
      case CSG_UNION:
        allowed = (left & ~in_r) | (~left & ~in_l);
        break;
      case CSG_INTERSECT:
        allowed = (left & in_r) | (~left & in_l);
        break;
      default:  // CSG_DIFFERENCE
        allowed = (left & ~in_r) | (~left & in_l);
        break;
    }
    alive = (rel & allowed) | (~rel & alive);
  }

  for (int m = 0; m < n_others; ++m) d[others[m]] = s[others[m]];
#pragma unroll
  for (int k = 0; k < CR; ++k)
    if (k < cr) d[plan.cols[k]] = kept(t[k], alive, k);
}

template <int CR>
int launch(const float* src, float* dst, long long n_rows, int n_cols,
           const int* others, int n_others, int cr, int n_nodes,
           const int32_t* host, cudaStream_t stream) {
  Plan<CR> plan{};
  plan.cr = cr;
  plan.n_nodes = n_nodes;
  for (int k = 0; k < cr; ++k) plan.cols[k] = host[k];
  for (int n = 0; n < n_nodes; ++n) {
    plan.op[n] = host[cr + n];
    plan.under[n] = static_cast<uint32_t>(host[cr + n_nodes + n]);
    plan.left[n] = static_cast<uint32_t>(host[cr + 2 * n_nodes + n]);
  }
  csg_filter_kernel<CR>
      <<<(unsigned)((n_rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          src, dst, n_rows, n_cols, others, n_others, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src, dst: two [n_rows, n_cols] f32 tables, contiguous. others: the
// n_others columns outside the root, a device array (copied from src to
// dst). host: the plan, a host array of cr + 3 * n_nodes int32: the root's
// columns, then each node's op, under mask and left mask (bit k for root
// column k), bottom-up; copied into the kernel's arguments, so a captured
// launch keeps it. Returns cudaGetLastError() after the launch.
extern "C" int csg_filter_launch(const float* src, float* dst,
                                 long long n_rows, int n_cols,
                                 const int* others, int n_others, int cr,
                                 int n_nodes, const int32_t* host,
                                 void* stream) {
  if (n_rows <= 0) return 0;
  if (cr < 1 || cr > 32 || n_nodes < 0 || n_nodes > MAX_NODES ||
      n_cols < cr || n_others < 0 || n_others > n_cols - cr ||
      (n_others > 0 && others == nullptr) || src == dst ||
      (n_rows + THREADS - 1) / THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < cr; ++k)
    if (host[k] < 0 || host[k] >= n_cols)
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cr <= 16 ? launch<16>(src, dst, n_rows, n_cols, others, n_others,
                               cr, n_nodes, host, s)
                  : launch<32>(src, dst, n_rows, n_cols, others, n_others,
                               cr, n_nodes, host, s);
}
