// Conditional nodes of a CUDA graph being captured (CUDA 12.4 and later),
// for the graph-replayed training step's bounded blocks.
//
// Not a compute kernel: graph plumbing. graph_if_begin adds an "if" node to
// the graph that `stream` is capturing, after a one-thread launch that sets
// the node's condition from a bool on the device, and starts capturing
// `body` into the node's child graph; graph_if_end ends that capture. Each
// replay then runs the child graph or skips it by the bool's value at that
// point of the replay, with no host read. The JAX package's counterpart is
// lax.cond inside its scan: its fused trace runs a capacity tier or the
// dense overflow by a count on the device.
//
// PyTorch's own CUDAGraph.begin_capture_to_if_node does the same, but is
// missing from some releases; this is the same sequence of runtime calls.
#include <cuda_runtime.h>

namespace {

__global__ void set_if_condition(cudaGraphConditionalHandle handle,
                                 const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// stream: capturing; pred: a device bool read at each replay; body: a
// stream that is not capturing, which captures the node's body until
// graph_if_end(body), in capture mode `mode` (a cudaStreamCaptureMode: the
// main capture's, so that what other threads may call stays the same).
int graph_if_begin(cudaStream_t stream, const bool* pred,
                   cudaStream_t body, int mode) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr,
                               nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_condition<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the node depends on what the stream captured last: the launch above
  const cudaGraphNode_t* deps;
  size_t n_deps;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       static_cast<cudaStreamCaptureMode>(mode));
}

int graph_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

}  // extern "C"
