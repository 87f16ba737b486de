// The tile graph: one CUDA graph per tile, or per train microbatch's
// forward or backward, whose levels are skipped or run, at their packed
// width, by conditional nodes (CUDA 12.4 or later).
//
// Counterpart of the JAX package's lax.cond chain inside its compiled tile
// and train step (raytracer_tpu/core/render.py:336-347 and :413-433),
// which XLA evaluates as scalar code inside one program. The parts of a
// tile (level 0, each branch of each level, the finish) are captured by
// PyTorch as graphs of their own; this file puts them together as
// child-graph nodes in one chain, and adds each level's decision itself
// as one kernel node of the top-level graph, the graph that owns the
// conditional handles (cudaGraphSetConditional must run there):
//
//   level 0 -> [level_control L -> IF(branch 0) -> ... -> IF(branch n-1)]
//              for each level L -> finish
//
// A train microbatch's backward reads the flags its forward wrote: one
// backward_control_kernel after its head part sets the handles of every
// level, then its levels' IF nodes follow in reverse:
//
//   head -> backward_control -> [IF(branch 0) -> ... ] for each level,
//           deepest first -> level 0's vjp
//
// A level has at most five branches: the four packed widths and the train
// program's dead level.
//
// level_control_kernel: one thread computes the level's branch from its
// live count (an int64 on the card, written by the part before), as
// ops/graph_cuda.level_control_plain does: the narrowest of R/16, R/4, R/2 and
// R that holds the live rays where the level packs, the whole level where
// it does not, none when no ray lives, or the dead level where the table
// has one. It writes the int32 flags (at most one set; exactly one with
// the dead level), which the backward and the CPU path read, the level's
// entry of the level log (-1: skipped or dead, 0: whole, else the packed
// width), and every IF handle of the level. Bound: latency. It reads 8
// bytes and writes at most 24 (five flags and the log entry); what it
// costs is one kernel node's launch, where the predicates part it
// replaces was a captured graph of 21 PyTorch kernels on one int64 and a
// copy (a packing level; measured on an H100), followed by a second
// kernel that copied the flags into the handles.
//
// backward_control_kernel: one thread a level copies that level's flags
// into its IF handles, all levels in one launch.
//
// Plain C interface, bound through ctypes (ops/graph_cuda.py); every
// function returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#define MAX_BRANCHES 5
#define MAX_LEVELS 32
// a branch table's codes: a packed width (> 0), the whole level, the
// dead level
#define CODE_WHOLE 0
#define CODE_DEAD (-1)

struct Control {
  const long long* live;
  int32_t* flags;
  int32_t* log;
  long long rows;
  int code[MAX_BRANCHES];
  cudaGraphConditionalHandle h[MAX_BRANCHES];
  int n;
};

struct Backward {
  const int32_t* flags[MAX_LEVELS];
  cudaGraphConditionalHandle h[MAX_LEVELS][MAX_BRANCHES];
  int n[MAX_LEVELS];
  int levels;
};

__global__ void level_control_kernel(Control c) {
  if (threadIdx.x != 0) return;
  const long long live = *c.live, r = c.rows;
  const bool alive = live > 0;
  const long long width = live <= r / 16 ? r / 16
                          : live <= r / 4 ? r / 4
                          : live <= r / 2 ? r / 2 : r;
  int entry = -1;
  for (int k = 0; k < c.n; ++k) {
    const int code = c.code[k];
    const bool on = code == CODE_DEAD ? !alive
                    : alive && (code == CODE_WHOLE || width == code);
    c.flags[k] = on;
    if (on && code != CODE_DEAD) entry = code;
    cudaGraphSetConditional(c.h[k], on ? 1u : 0u);
  }
  *c.log = entry;
}

__global__ void backward_control_kernel(Backward b) {
  const int l = threadIdx.x;
  if (l >= b.levels) return;
  for (int k = 0; k < b.n[l]; ++k) {
    cudaGraphSetConditional(b.h[l][k], b.flags[l][k] != 0 ? 1u : 0u);
  }
}

namespace {

// A node added to ``graph`` after ``*last`` (none when null); ``*last``
// becomes the new node.
cudaError_t add_child(cudaGraph_t graph, cudaGraph_t child,
                      cudaGraphNode_t* last) {
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddChildGraphNode(
      &node, graph, *last ? last : nullptr, *last ? 1 : 0, child);
  if (err == cudaSuccess) *last = node;
  return err;
}

// ``n`` conditional handles of ``graph``. Each resets to 0 at every
// launch of the graph, so a branch runs only where this launch set it.
cudaError_t make_handles(cudaGraph_t graph, int n,
                         cudaGraphConditionalHandle* h) {
  for (int k = 0; k < n; ++k) {
    cudaError_t err = cudaGraphConditionalHandleCreate(
        &h[k], graph, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// A one-block kernel node of ``threads`` threads whose one parameter is
// ``*arg``, added after ``*last``.
cudaError_t add_kernel(cudaGraph_t graph, void* func, void* arg,
                       int threads, cudaGraphNode_t* last) {
  cudaKernelNodeParams kp{};
  void* args[] = {arg};
  kp.func = func;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(threads);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(
      &node, graph, *last ? last : nullptr, *last ? 1 : 0, &kp);
  if (err == cudaSuccess) *last = node;
  return err;
}

// ``n`` IF nodes in a chain after ``*last``, the body of IF k a
// child-graph node of ``bodies[k]``.
cudaError_t add_ifs(cudaGraph_t graph, int n,
                    const cudaGraphConditionalHandle* h,
                    void* const* bodies, cudaGraphNode_t* last) {
  for (int k = 0; k < n; ++k) {
    cudaGraphNodeParams p{};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h[k];
    p.conditional.type = cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t node;
    cudaError_t err = cudaGraphAddNode(&node, graph, last, 1, &p);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t inner = nullptr;
    err = add_child(p.conditional.phGraph_out[0],
                    static_cast<cudaGraph_t>(bodies[k]), &inner);
    if (err != cudaSuccess) return err;
    *last = node;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int tile_graph_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return err;
  return cudaDriverGetVersion(driver);
}

int tile_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// Appends ``child`` (a captured part) to the chain ending at ``*last``.
int tile_graph_add_child(void* graph, void* child, void** last) {
  return add_child(static_cast<cudaGraph_t>(graph),
                   static_cast<cudaGraph_t>(child),
                   reinterpret_cast<cudaGraphNode_t*>(last));
}

// Appends one level's decision: level_control_kernel on ``*live`` (device
// int64) for a level of ``rows`` rays whose ``n`` branches have the codes
// ``codes`` (a packed width, CODE_WHOLE or CODE_DEAD), writing ``flags``
// (device int32 [n]) and ``*log`` (device int32), then ``n`` IF nodes in
// a chain, the body of IF k a child-graph node of ``bodies[k]``.
int tile_graph_add_control(void* graph, int n, void* const* bodies,
                           const int* codes, const long long* live,
                           long long rows, int32_t* flags, int32_t* log,
                           void** last) {
  if (n < 1 || n > MAX_BRANCHES || rows < 1) return cudaErrorInvalidValue;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphNode_t* tail = reinterpret_cast<cudaGraphNode_t*>(last);
  Control c{};
  c.live = live;
  c.flags = flags;
  c.log = log;
  c.rows = rows;
  c.n = n;
  for (int k = 0; k < n; ++k) c.code[k] = codes[k];
  cudaError_t err = make_handles(g, n, c.h);
  if (err != cudaSuccess) return err;
  err = add_kernel(g, reinterpret_cast<void*>(level_control_kernel), &c, 1,
                   tail);
  if (err != cudaSuccess) return err;
  return add_ifs(g, n, c.h, bodies, tail);
}

// Appends a backward's decisions: backward_control_kernel setting the IF
// handles of ``levels`` levels from their flags (``flags[l]``, device
// int32 [n[l]], written by an earlier graph launch), then each level's
// ``n[l]`` IF nodes, level after level in the order given; ``bodies``
// holds the levels' bodies one level after the other.
int tile_graph_add_backward(void* graph, int levels, const int* n,
                            void* const* bodies, void* const* flags,
                            void** last) {
  if (levels < 1 || levels > MAX_LEVELS) return cudaErrorInvalidValue;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphNode_t* tail = reinterpret_cast<cudaGraphNode_t*>(last);
  Backward b{};
  b.levels = levels;
  for (int l = 0; l < levels; ++l) {
    if (n[l] < 1 || n[l] > MAX_BRANCHES) return cudaErrorInvalidValue;
    b.n[l] = n[l];
    b.flags[l] = static_cast<const int32_t*>(flags[l]);
    cudaError_t err = make_handles(g, n[l], b.h[l]);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = add_kernel(
      g, reinterpret_cast<void*>(backward_control_kernel), &b, 32, tail);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < levels; ++l) {
    err = add_ifs(g, n[l], b.h[l], bodies, tail);
    if (err != cudaSuccess) return err;
    bodies += n[l];
  }
  return cudaSuccess;
}

// The nodes of ``graph``'s top level: all of them, its kernel nodes and
// its child-graph nodes. cudaGraphNodeGetType answers a conditional node
// with cudaErrorUnknown in the runtime this library links (CUDA 12.9 on
// an H100 whose CUDA is 13.0, measured), so a node whose type it does
// not give counts as neither, and that error is cleared.
int tile_graph_node_count(void* graph, int* total, int* kernels,
                          int* children) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return err;
  *total = static_cast<int>(count);
  *kernels = *children = 0;
  if (count == 0) return cudaSuccess;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[count];
  err = cudaGraphGetNodes(g, nodes, &count);
  for (size_t i = 0; err == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) continue;
    *kernels += type == cudaGraphNodeTypeKernel;
    *children += type == cudaGraphNodeTypeGraph;
  }
  delete[] nodes;
  cudaGetLastError();
  return err;
}

int tile_graph_instantiate(void* graph, void** exec) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

int tile_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int tile_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return err;
}

}  // extern "C"
