// The tile graph: one CUDA graph per tile, or per train microbatch's
// forward or backward, whose levels are skipped or run, at their packed
// width, by conditional nodes (CUDA 12.4 or later).
//
// Counterpart of the JAX package's lax.cond chain inside its compiled tile
// and train step (raytracer_tpu/core/render.py:338-348 and :413-433). The
// parts of a tile (level 0, a level's predicates, each branch of each
// level, the finish) are captured by PyTorch as graphs of their own; this
// file puts them together as child-graph nodes in one chain:
//
//   level 0 -> [predicates L -> set_conditionals L -> IF(branch 0) -> ...
//               -> IF(branch n-1)] for each level L -> finish
//
// A train microbatch's backward chains its levels in reverse on the flags
// its forward wrote, with no predicates part. A level has at most five
// branches: the four packed widths and the train program's dead level.
//
// set_conditionals_kernel copies a level's int32 flags (at most one set,
// written on the card by the predicates part) into the conditional
// handles of the level's IF nodes, so that exactly the branch whose flag
// is set runs, or none. Plain C interface, bound through ctypes
// (ops/graph_cuda.py); every function returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#define MAX_BRANCHES 5

struct Handles {
  cudaGraphConditionalHandle h[MAX_BRANCHES];
  int n;
};

__global__ void set_conditionals_kernel(Handles hs, const int32_t* flags) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < hs.n; ++k) {
      cudaGraphSetConditional(hs.h[k], flags[k] != 0 ? 1u : 0u);
    }
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

// Appends one level's decision: set_conditionals_kernel on ``flags``
// (device int32 [n]), then ``n`` IF nodes in a chain, the body of IF k a
// child-graph node of ``bodies[k]``. Each handle resets to 0 at every
// launch of the graph, so a branch runs only where this launch set it.
int tile_graph_add_level(void* graph, int n, void* const* bodies,
                         const int32_t* flags, void** last) {
  if (n < 1 || n > MAX_BRANCHES) return cudaErrorInvalidValue;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphNode_t* tail = reinterpret_cast<cudaGraphNode_t*>(last);
  Handles hs{};
  hs.n = n;
  for (int k = 0; k < n; ++k) {
    cudaError_t err = cudaGraphConditionalHandleCreate(
        &hs.h[k], g, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return err;
  }
  cudaKernelNodeParams kp{};
  void* args[] = {&hs, const_cast<int32_t**>(&flags)};
  kp.func = reinterpret_cast<void*>(set_conditionals_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(32);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(
      &node, g, *tail ? tail : nullptr, *tail ? 1 : 0, &kp);
  if (err != cudaSuccess) return err;
  *tail = node;
  for (int k = 0; k < n; ++k) {
    cudaGraphNodeParams p{};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = hs.h[k];
    p.conditional.type = cudaGraphCondTypeIf;
    p.conditional.size = 1;
    err = cudaGraphAddNode(&node, g, tail, 1, &p);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t inner = nullptr;
    err = add_child(p.conditional.phGraph_out[0],
                    static_cast<cudaGraph_t>(bodies[k]), &inner);
    if (err != cudaSuccess) return err;
    *tail = node;
  }
  return cudaSuccess;
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
