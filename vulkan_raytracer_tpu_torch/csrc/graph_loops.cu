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
// its own leaves and nested nodes.  A condition is set on the card by the
// kernel that makes its count (csrc/graph_test.cuh): loop_cond_kernel counts
// a column of live or pending lane flags over a grid of 16 flags a thread,
// its last block compares the total
// against a floor and, where the loop has one, the bounce index b against
// max_depth, and calls cudaGraphSetConditional.  A WHILE node tests its
// condition before its first iteration, so one loop_cond_kernel node runs
// right before each conditional node (the entry test) and, for a bounce
// loop, one more ends its body: it adds 1 to b (the bounce's b += 1), counts
// the live lanes and, on a repacked wave, also sets the IF that follows it
// in the body (the next bounce's re-sort, which so has no test of its own).
// A resample loop's body ends with no test: its pass's commit
// (alpha_commit_kernel, csrc/wave.cu) counts the lanes it leaves pending and
// sets the loop's condition.  Likewise an instance's launch (the JAX scan's
// lax.cond(jnp.any(touches)), ops/instanced.py:229, :314) is an IF with no
// test node: the instance's step (instance_step_kernel, csrc/trace.cu)
// counts the lanes that touch its box and sets it; those IFs' control blocks
// are armed with their handles and rows by a copy at the parent graph's
// start (copy_words_kernel) and disarmed at its end.  The handle exists only once the parts are
// stitched, after PyTorch captured the pass, so the loop's entry test writes
// it, and the address of the node's row, into the loop's control block, which
// the commit reads; the commit clears the row's address when the loop ends,
// so a replay of the pass outside the device loops (and an eager pass, which
// has no block) finds no handle there.  Each test also keeps the node's row
// of counters, five int64: iterations (bodies run), entries (tests before the
// node), the bodies of the current entry, the most bodies one entry ran, and
// the sum of the counts that let a body run (a bounce loop's live lanes).
// The Python side reads the rows once a frame and multiplies each leaf's
// captured launch counts by the runs of its body.
//
// What bounds it.  A test reads a wave's flags, half a megabyte at most
// (0.16 us at 3.35 TB/s): a launch, about 2 us of device time, one a bounce
// and one at each loop's entry.  Each node costs the card its launch inside
// the graph, so the test is made where the count is made: the bounce loop's
// closing test replaces the aten ops that counted the live lanes, stepped b
// and set the re-sort flag, and a resample pass tests in its commit.  What the
// device loops save is host time: a wave with host-driven loops waits for one
// read per test.
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

#include "graph_test.cuh"

// One test's parameters; render/graphs.py _LoopTest lists the same fields in
// the same order.
struct LoopTest {
  unsigned long long handle;       // the node's condition
  unsigned long long then_handle;  // an IF after this test in the same body (then_row set)
  const uint8_t* flags;            // the lanes whose nonzero flags are the count
  long long n;                     // their number
  long long floor;                 // the count must pass it
  int* b;                          // the bounce index, or null
  long long* row;                  // the node's row of five counters
  long long* then_row;             // the IF's row, or null: no IF
  unsigned long long* word;        // flags' accumulator and block ticket
  long long* arm;                  // a resample loop's control block to arm, or null
  int max_depth;                   // b must not pass it
  int step;                        // add 1 to b before the test
  int entry;                       // the test before the node's first body
};

namespace {

constexpr int kTestThreads = 256;
constexpr int kTestBytes = 16;  // flags a thread counts

// Nonzero bytes of a word
__device__ __forceinline__ unsigned int nonzero_bytes(unsigned int w) {
  return __popc((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u);
}

// The test: the flags counted by the whole grid, 16 a thread; then in the last
// block b stepped, the row kept, the conditions set, a resample loop armed
__global__ void __launch_bounds__(kTestThreads) loop_cond_kernel(const __grid_constant__ LoopTest t) {
  unsigned int mine = 0;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kTestThreads + threadIdx.x) * kTestBytes;
  const uint8_t* p = t.flags + b0;
  if (b0 + kTestBytes <= t.n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    mine = nonzero_bytes(q.x) + nonzero_bytes(q.y) + nonzero_bytes(q.z) + nonzero_bytes(q.w);
  } else {
    for (long long k = b0; k < b0 + kTestBytes && k < t.n; ++k) mine += t.flags[k] != 0;
  }
  long long total;
  if (!last_block(t.word, block_sum(mine), total)) return;
  int b = 0;
  if (t.b != nullptr) {
    b = *t.b + t.step;
    if (t.step) *t.b = b;
  }
  const bool go = total > t.floor && (t.b == nullptr || b <= t.max_depth);
  keep_row(t.row, t.entry, go, total);
  cudaGraphSetConditional(t.handle, go ? 1u : 0u);
  if (t.then_row != nullptr) {  // the IF runs its body where the loop goes on
    keep_row(t.then_row, true, go, total);
    cudaGraphSetConditional(t.then_handle, go ? 1u : 0u);
  }
  if (go && t.arm != nullptr) {  // the resample loop's passes test themselves
    t.arm[1] = static_cast<long long>(t.handle);
    t.arm[2] = reinterpret_cast<long long>(t.row);
  }
}

// Copies n int64 words from src to dst, or zeroes them where src is null:
// the arming and disarming of the instance launches' IF control blocks
__global__ void __launch_bounds__(kTestThreads) copy_words_kernel(long long* dst,
                                                                  const long long* src,
                                                                  long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kTestThreads + threadIdx.x;
  if (i < n) dst[i] = src ? src[i] : 0;
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

// A new conditional handle of `graph` (no default value: a test sets it
// before its node runs).
int graph_loops_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, static_cast<cudaGraph_t>(graph), 0, 0);
  if (err == cudaSuccess) *handle = h;
  return static_cast<int>(err);
}

// Appends a test (loop_cond_kernel) to `graph` after *tail: a grid of one
// thread a 16 flags, one block at least.
int graph_loops_add_test(void* graph, void** tail, const LoopTest* test) {
  LoopTest t = *test;
  void* args[] = {&t};
  const long long chunks = (t.n + kTestBytes - 1) / kTestBytes;
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(static_cast<unsigned int>(
      chunks > 0 ? (chunks + kTestThreads - 1) / kTestThreads : 1));
  p.blockDim = dim3(kTestThreads, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, static_cast<cudaGraph_t>(graph),
                                           dep ? &dep : nullptr, dep ? 1 : 0, &p);
  if (err == cudaSuccess) *tail = node;
  return static_cast<int>(err);
}

// Appends a copy of n int64 words from src to dst (zeroes where src is null)
// to `graph` after *tail: a kernel node (copy_words_kernel).
int graph_loops_add_copy(void* graph, void** tail, long long* dst, const long long* src,
                         long long n) {
  void* args[] = {&dst, &src, &n};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(copy_words_kernel);
  p.gridDim = dim3(static_cast<unsigned int>(n > 0 ? (n + kTestThreads - 1) / kTestThreads : 1));
  p.blockDim = dim3(kTestThreads, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, static_cast<cudaGraph_t>(graph),
                                           dep ? &dep : nullptr, dep ? 1 : 0, &p);
  if (err == cudaSuccess) *tail = node;
  return static_cast<int>(err);
}

// Appends a conditional node (WHILE where is_while, else IF) on `handle` to
// `graph` after *tail; hands back its body graph, which the caller fills.
int graph_loops_add_conditional(void* graph, void** tail, unsigned long long handle,
                                int is_while, void** body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddNode(&node, static_cast<cudaGraph_t>(graph), dep ? &dep : nullptr,
                                     dep ? 1 : 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tail = node;
  *body = p.conditional.phGraph_out[0];
  return 0;
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
