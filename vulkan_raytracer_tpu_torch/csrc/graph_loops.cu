// Device-side loops for the captured wave: conditional graph nodes that run
// the bounce loop, the width ladder's phases and the alpha resample loops on
// the card, so that a wave is one graph launch and the host reads nothing
// inside it.
//
// Replaces the JAX package's device-side control flow, which the TPU ran
// inside one compiled program: the bounce loop's lax.while_loop and its
// live-lane test (vulkan_raytracer_tpu/render/integrator.py:1051-1069), the
// width ladder's phases (:1071-1124) with their lax.cond re-sorts (:1063,
// :1089), and each alpha ray query's accept/reject lax.while_loop (:165-217).
// The plain version is the host-driven interpreter of the same program tree
// in render/graphs.py (_Program.interpret), which reads each loop's
// condition on the host.
//
// Design.  PyTorch captures the program's leaves (the segments of straight
// tensor code, a resample pass, the ladder's sort, split and join) as
// cudaGraph_t's of one memory pool (torch.cuda.CUDAGraph(keep_graph=True)).
// The functions below stitch them into one parent graph: each leaf a child
// graph node, chained in program order; each loop a conditional WHILE node
// and each re-sort a conditional IF node (CUDA 12.4+), whose body graph holds
// its own leaves and nested nodes.  A condition is set on the card by
// loop_cond_kernel, one thread: it reads the loop's device scalars (the
// bounce index b against max_depth where the loop has one, and a count of
// live or pending lanes against a floor) and calls cudaGraphSetConditional.
// A WHILE node tests its condition before its first iteration, so one
// loop_cond_kernel node runs right before each conditional node (the
// entry test) and, for a WHILE, one more ends its body (the test for the
// next iteration).  Each test also keeps the node's row of counters, four
// int64: iterations (bodies run), entries (tests before the node), the
// bodies of the current entry, and the most bodies one entry ran.  The
// Python side reads the rows once a frame and multiplies each leaf's
// captured launch counts by the runs of its body.
//
// What bounds it.  loop_cond_kernel is one thread reading three scalars: a
// launch, about 2 us of device time, a few per bounce.  What it saves is
// host time: a wave with host-driven loops waits for one read per test.
//
// What a conditional body may hold: kernel, memset, device-to-device memcpy,
// empty, child-graph and conditional nodes.  graph_loops_check walks a leaf
// before it is stitched in and names the first node of another type (an
// event record or wait from a cross-stream op, a host node, a memory
// alloc or free node from a stream-ordered allocator) or a memcpy that
// touches host memory; the Python side raises.
//
// Every function returns a cudaError_t (0 on success); the Python wrapper
// raises on any other code.  Nothing here allocates device memory or
// synchronises; the parent is launched on the caller's stream (PyTorch's
// current stream).

#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle, const int* b, int max_depth,
                                 const long long* count, long long floor, long long* row,
                                 int entry) {
  const bool go = *count > floor && (b == nullptr || *b <= max_depth);
  if (entry) {  // a new entry of the node: its bodies start again from 0
    row[1] += 1;
    row[2] = 0;
  }
  if (go) {
    row[0] += 1;
    row[2] += 1;
  } else if (row[2] > row[3]) {
    row[3] = row[2];
  }
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

cudaError_t add_test(cudaGraph_t graph, cudaGraphNode_t* tail, cudaGraphConditionalHandle handle,
                     const int* b, int max_depth, const long long* count, long long floor,
                     long long* row, int entry) {
  void* args[] = {&handle, &b, &max_depth, &count, &floor, &row, &entry};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, graph, *tail ? tail : nullptr, *tail ? 1 : 0, &p);
  if (err == cudaSuccess) *tail = node;
  return err;
}

bool allowed(cudaGraphNodeType type) {
  return type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
         type == cudaGraphNodeTypeMemset || type == cudaGraphNodeTypeEmpty ||
         type == cudaGraphNodeTypeGraph || type == cudaGraphNodeTypeConditional;
}

// 1 if ptr is device memory (or managed), else 0.
bool on_device(const void* ptr) {
  if (ptr == nullptr) return true;
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();  // an unregistered host pointer leaves an error behind
    return false;
  }
  return attr.type == cudaMemoryTypeDevice || attr.type == cudaMemoryTypeManaged;
}

// Walks `graph` (and the child graphs in it): adds its nodes to *nodes and
// sets *bad_type to the type of the first node a conditional body may not
// hold (100 for a memcpy that touches host memory or an array).
cudaError_t walk(cudaGraph_t graph, int* nodes, int* bad_type) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> all(n);
  err = cudaGraphGetNodes(graph, all.data(), &n);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return err;
    *nodes += 1;
    if (*bad_type >= 0) continue;
    if (!allowed(type)) {
      *bad_type = static_cast<int>(type);
    } else if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      err = cudaGraphMemcpyNodeGetParams(node, &p);
      if (err != cudaSuccess) return err;
      if (p.srcArray || p.dstArray || !on_device(p.srcPtr.ptr) || !on_device(p.dstPtr.ptr)) {
        *bad_type = 100;
      }
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (err != cudaSuccess) return err;
      *nodes -= 1;  // the child's nodes count instead
      err = walk(child, nodes, bad_type);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* graph_loops_node_type_name(int type) {
  switch (type) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "external semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "external semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory alloc";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    case 100: return "memcpy to or from host memory or an array";
    default: return "unknown";
  }
}

int graph_loops_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaRuntimeGetVersion(runtime));
}

// Node count of a captured leaf and the type of its first node that a
// conditional body may not hold (-1: none).
int graph_loops_check(void* graph, int* nodes, int* bad_type) {
  *nodes = 0;
  *bad_type = -1;
  return static_cast<int>(walk(static_cast<cudaGraph_t>(graph), nodes, bad_type));
}

int graph_loops_create(void** graph) {
  cudaGraph_t g;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err == cudaSuccess) *graph = g;
  return static_cast<int>(err);
}

// Appends a clone of `child` to `graph` after *tail (none where it is null).
int graph_loops_add_child(void* graph, void** tail, void* child) {
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(graph),
                                               dep ? &dep : nullptr, dep ? 1 : 0,
                                               static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) *tail = node;
  return static_cast<int>(err);
}

// Appends the entry test and a conditional node (WHILE where is_while, else
// IF) to `graph` after *tail; hands back the node's handle and its body
// graph, which the caller fills.  A WHILE body ends with
// graph_loops_add_test.
int graph_loops_add_conditional(void* graph, void** tail, int is_while, const int* b,
                                int max_depth, const long long* count, long long floor,
                                long long* row, unsigned long long* handle, void** body) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t last = static_cast<cudaGraphNode_t>(*tail);
  err = add_test(g, &last, h, b, max_depth, count, floor, row, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, g, &last, 1, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tail = node;
  *handle = h;
  *body = p.conditional.phGraph_out[0];
  return 0;
}

// Appends the test that decides a WHILE body's next iteration to the body.
int graph_loops_add_test(void* body, void** tail, unsigned long long handle, const int* b,
                         int max_depth, const long long* count, long long floor, long long* row) {
  cudaGraphNode_t last = static_cast<cudaGraphNode_t>(*tail);
  cudaError_t err = add_test(static_cast<cudaGraph_t>(body), &last, handle, b, max_depth, count,
                             floor, row, 0);
  if (err == cudaSuccess) *tail = last;
  return static_cast<int>(err);
}

int graph_loops_instantiate(int device, void* graph, void** exec) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphExec_t e;
  err = cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph), 0);
  if (err == cudaSuccess) *exec = e;
  return static_cast<int>(err);
}

int graph_loops_launch(int device, void* exec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Destroys a parent graph and its executable (either may be null).  An
// executable still running on the card is freed when it completes.
int graph_loops_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}

}  // extern "C"
