// Conditional (IF and WHILE) nodes in a stream capture — the device side
// of utils/control.cond and utils/control.while_loop, the port's
// counterparts of jax.lax.cond and jax.lax.while_loop inside one captured
// CUDA graph (the reference's conds and loops inside its chunk's lax.scan).
//
// A cond under capture becomes, on the capturing stream:
//   1. one single-thread kernel that reads the predicate on the card, sets
//      two conditional handles to pred and !pred, and counts the side taken
//      in a caller-owned int32 pair (the host reads those counts once per
//      chunk, with the chunk's outputs);
//   2. an IF node on the first handle whose body graph is captured from a
//      second stream (the true branch), then an IF node on the second
//      handle (the false branch, which copies its outputs into the true
//      branch's buffers).  Each IF node becomes the capturing stream's only
//      dependency, so what follows waits for both.
// Two IF nodes rather than one IF/ELSE node: the ELSE body needs CUDA 12.8
// in libcuda as well as in the toolkit.
//
// A while_loop under capture becomes one single-thread kernel that reads
// the first predicate and sets one handle (counting the loop's entry in
// taken[1]), then a WHILE node on it whose body, captured from a second
// stream, ends with the same kernel on the body's new predicate (counting
// the iteration in taken[0]): the body runs while the handle is nonzero,
// any number of times, with no host read.
//
// The entries return the cudaError_t of their runtime calls (0 =
// success).  A census entry counts a graph's nodes by type, for the
// kernel nodes a replay runs.

#include <cuda_runtime.h>

namespace {

__global__ void cond_set_kernel(cudaGraphConditionalHandle on_true,
                                cudaGraphConditionalHandle on_false, const bool* pred,
                                int* taken) {
  const bool p = *pred;
  cudaGraphSetConditional(on_true, p ? 1u : 0u);
  cudaGraphSetConditional(on_false, p ? 0u : 1u);
  taken[p ? 0 : 1] += 1;
}

// Sets the handle of a WHILE node from *pred and counts one in *count.
__global__ void while_set_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                                 int* count) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
  *count += 1;
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr,
                                             n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorIllegalState;
}

// libcuda's cuGraphNodeGetType: the runtime's own query fails on a
// conditional node when libcuda is newer than the runtime linked here.
using NodeTypeFn = int (*)(cudaGraphNode_t, int*);

NodeTypeFn node_type_fn() {
  static NodeTypeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuGraphNodeGetType", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<NodeTypeFn>(p);
  }
  return fn;
}

// counts: kernel, memcpy, memset, conditional, other nodes of `graph`
// (its own nodes; a conditional node's body is counted where it is captured).
// The CUgraphNodeType values: kernel 0, memcpy 1, memset 2, conditional 13.
cudaError_t census(cudaGraph_t graph, int* counts) {
  for (int k = 0; k < 5; ++k) counts[k] = 0;
  const NodeTypeFn node_type = node_type_fn();
  if (node_type == nullptr) return cudaErrorSymbolNotFound;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    int type = -1;
    if (node_type(nodes[i], &type) != 0) {
      err = cudaErrorUnknown;
      break;
    }
    ++counts[type == 0 ? 0 : type == 1 ? 1 : type == 2 ? 2 : type == 13 ? 3 : 4];
  }
  delete[] nodes;
  return err;
}

}  // namespace

// Make two conditional handles in the graph `stream` is capturing into, and
// capture the kernel that sets them from *pred and counts the side taken in
// taken[0] (true) or taken[1] (false).  handles: 2 out.
extern "C" int flvis_cond_open(cudaStream_t stream, const void* pred, int* taken,
                               unsigned long long* handles) {
  cudaGraph_t graph;
  cudaError_t err = capture_info(stream, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h[2];
  for (int k = 0; k < 2; ++k) {
    err = cudaGraphConditionalHandleCreate(&h[k], graph, 0, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cond_set_kernel<<<1, 1, 0, stream>>>(h[0], h[1], static_cast<const bool*>(pred), taken);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  handles[0] = h[0];
  handles[1] = h[1];
  return 0;
}

// Make a conditional handle in the graph `stream` is capturing into, and
// capture the kernel that sets it from the first predicate *pred and counts
// the loop's entry in taken[1].  handle: 1 out.
extern "C" int flvis_while_open(cudaStream_t stream, const void* pred, int* taken,
                                unsigned long long* handle) {
  cudaGraph_t graph;
  cudaError_t err = capture_info(stream, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  while_set_kernel<<<1, 1, 0, stream>>>(h, static_cast<const bool*>(pred), taken + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle = h;
  return 0;
}

// The last kernel of a WHILE body (captured on `body`): set `handle` from
// the body's new predicate *pred and count the iteration in taken[0].
extern "C" int flvis_while_next(cudaStream_t body, unsigned long long handle, const void* pred,
                                int* taken) {
  while_set_kernel<<<1, 1, 0, body>>>(handle, static_cast<const bool*>(pred), taken);
  return static_cast<int>(cudaGetLastError());
}

// Add a conditional node on `handle` (an IF node, or a WHILE node if
// `is_while`) after everything `stream` has captured, make it the stream's
// only capture dependency, and start capturing `body` into the node's body
// graph.
extern "C" int flvis_cond_body_begin(cudaStream_t stream, unsigned long long handle,
                                     int is_while, cudaStream_t body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeGlobal));
}

// End the capture of a conditional node's body; counts (5 out): its nodes
// by type.
extern "C" int flvis_cond_body_end(cudaStream_t body, int* counts) {
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(body, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(census(graph, counts));
}

// counts (5 out): the nodes, by type, of a captured graph (its own nodes).
extern "C" int flvis_graph_census(cudaGraph_t graph, int* counts) {
  return static_cast<int>(census(graph, counts));
}

// A new non-blocking stream (out): each branch and conditional body of a
// capture needs a stream of its own, more than PyTorch's pool of 32 hands
// out distinct, and no other capture's.
extern "C" int flvis_stream_create(unsigned long long* out) {
  cudaStream_t s;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err == cudaSuccess) *out = reinterpret_cast<unsigned long long>(s);
  return static_cast<int>(err);
}
