// CUDA conditional graph nodes (CUDA 12.4 or later) under PyTorch's
// stream capture, for the planner's frame program
// (pvo_tpu_torch/vo/graph_capture.py).
//
// pvo_cond_begin(parent, pred, child): ``parent`` is a stream that is
// capturing a graph. Creates a conditional handle in that graph,
// captures a one-thread kernel that sets the handle from the device
// bool ``*pred``, adds an IF node after it, makes the node the parent's
// only capture dependency, and starts capturing ``child`` into the
// node's body graph. Work issued on ``child`` until pvo_cond_end(child)
// runs at replay only where ``*pred`` was true when the node was
// reached. Nested bodies work the same way with the outer body's stream
// as the parent.

#include <cuda_runtime.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int pvo_cond_begin(void* parent, const void* pred, void* child) {
  cudaStream_t ps = (cudaStream_t)parent;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  set_cond_kernel<<<1, 1, 0, ps>>>(handle, (const bool*)pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)child, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int pvo_cond_end(void* child) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &body);
}
