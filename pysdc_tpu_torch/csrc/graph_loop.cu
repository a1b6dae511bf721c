// The device loop of the port: a CUDA graph WHILE node built into a stream capture.
//
// The JAX package runs every iterative solve (CG, PCG, GMRES, the Newton loops,
// the refinement of a prepared factorization) as a lax.while_loop: the trip
// count is decided on the device.  A CUDA graph holds such a loop only as a
// conditional node (CUDA 12.3+): a node of type cudaGraphCondTypeWhile runs its
// body graph while the value of its conditional handle is nonzero, and kernels
// set that value with cudaGraphSetConditional.  This file builds that node
// into a graph under stream capture, the way torch's own IF nodes are built
// (CUDAGraph::begin_capture_to_if_node), with a WHILE type:
//
//   begin_while(outer, body, flag)
//     - reads the graph that `outer` captures into and its current
//       dependencies (cudaStreamGetCaptureInfo);
//     - creates a conditional handle on that graph;
//     - captures one launch of set_conditional(handle, *flag) on `outer`, so a
//       loop whose flag is already false runs zero iterations;
//     - adds the WHILE node behind it (cudaGraphAddNode) and makes the node
//       the only dependency of what `outer` captures next;
//     - starts capturing `body` into the node's body graph
//       (cudaStreamBeginCaptureToGraph).
//   set_conditional(handle, flag, stream): the same one-thread kernel, launched
//     by the caller at the end of the body with the body's new flag.
//   end_while(body): ends the body's capture.
//
// A nested loop calls begin_while with the enclosing body stream as `outer`:
// its handle and node then belong to the enclosing body graph.
//
// No eager path: outside a capture begin_while returns cudaErrorIllegalState.
// Bound: none to speak of.  The set kernel is one thread reading one byte; the
// loop's cost is its body's, plus the conditional node's evaluation per trip.
//
// The same library holds the stamps of the port's spans
// (pysdc_tpu_torch/utils/trace.py): one-thread kernels that read the card's
// global timer (%globaltimer, nanoseconds) on the stream they are launched on.
// Captured into a graph they run at each replay, and in a WHILE body at every
// trip.  A span's row is four int64 {start, total, count, end}: trace_open
// writes start; trace_close adds the time since start to total and 1 to count,
// and writes end.  They are launched only while tracing is on.
//
// C interface, loaded with ctypes; each function returns a cudaError_t code
// (0 on success).

#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12030
#error "graph_loop.cu needs CUDA 12.3 or newer (conditional WHILE graph nodes)"
#endif

// CUDA 13 made the edge-data forms of these calls the only ones; 12.3-12.9 name them _v3 / _v2.
#if CUDART_VERSION >= 13000
#define GL_CAPTURE_INFO cudaStreamGetCaptureInfo
#define GL_ADD_NODE cudaGraphAddNode
#define GL_UPDATE_DEPENDENCIES cudaStreamUpdateCaptureDependencies
#else
#define GL_CAPTURE_INFO cudaStreamGetCaptureInfo_v3
#define GL_ADD_NODE cudaGraphAddNode_v2
#define GL_UPDATE_DEPENDENCIES cudaStreamUpdateCaptureDependencies_v2
#endif

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

__device__ __forceinline__ long long global_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void trace_open_kernel(long long* row) { row[0] = global_now(); }

__global__ void trace_close_kernel(long long* row) {
  const long long t = global_now();
  row[1] += t - row[0];
  row[2] += 1;
  row[3] = t;
}

// The timer's steps: it is read until its value has changed `changes` times; out = {smallest step, largest step,
// reads}.
__global__ void trace_resolution_kernel(long long* out, int changes) {
  long long last = global_now(), lo = -1, hi = 0, reads = 0;
  for (int seen = 0; seen < changes; ++reads) {
    const long long t = global_now();
    if (t != last) {
      const long long step = t - last;
      lo = (lo < 0 || step < lo) ? step : lo;
      hi = step > hi ? step : hi;
      last = t;
      ++seen;
    }
  }
  out[0] = lo;
  out[1] = hi;
  out[2] = reads;
}

}  // namespace

extern "C" {

// The runtime's and the driver's versions (1000 * major + 10 * minor).
int graph_loop_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDriverGetVersion(driver));
}

// Loads the set kernel now (lazy module loading would otherwise load it at its first launch, inside a capture).
int graph_loop_load(void) {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_conditional_kernel));
}

int graph_loop_set_conditional(unsigned long long handle, const void* flag, void* stream) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(flag));
  return static_cast<int>(cudaGetLastError());
}

int graph_loop_begin_while(void* outer_stream, void* body_stream, const void* flag, unsigned long long* handle_out) {
  cudaStream_t outer = static_cast<cudaStream_t>(outer_stream);
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* edges = nullptr;
  size_t ndeps = 0;
  cudaError_t err = GL_CAPTURE_INFO(outer, &status, nullptr, &graph, &deps, &edges, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return static_cast<int>(cudaErrorIllegalState);

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the flag before the first trip: a loop that has nothing to do runs zero iterations
  err = static_cast<cudaError_t>(graph_loop_set_conditional(handle, flag, outer));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = GL_CAPTURE_INFO(outer, &status, nullptr, &graph, &deps, &edges, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = GL_ADD_NODE(&node, graph, deps, edges, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];

  err = GL_UPDATE_DEPENDENCIES(outer, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(body, body_graph, nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

int graph_loop_end_while(void* body_stream) {
  cudaGraph_t graph = nullptr;  // the node's body graph: the node owns it
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}

// Loads the stamp kernels now, before a capture can meet them.
int trace_load(void) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, trace_open_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncGetAttributes(&attr, trace_close_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncGetAttributes(&attr, trace_resolution_kernel));
}

int trace_open(void* row, void* stream) {
  trace_open_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(row));
  return static_cast<int>(cudaGetLastError());
}

int trace_close(void* row, void* stream) {
  trace_close_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(row));
  return static_cast<int>(cudaGetLastError());
}

int trace_resolution(void* out, int changes, void* stream) {
  trace_resolution_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out), changes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
