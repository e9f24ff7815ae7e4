// Which kernels of a CUDA graph may set a conditional node's condition?
//
// The port's captured wave (vulkan_raytracer_tpu_torch/render/graphs.py)
// stitches PyTorch's captured parts into one parent graph as child-graph
// nodes, with conditional WHILE and IF nodes around them.  A condition is set
// on the card by cudaGraphSetConditional.  Three questions decide where a
// test may be made:
//
//   child   a kernel inside a child-graph node of a WHILE body sets the
//           WHILE's own condition, the handle read from device memory (as a
//           captured part would, whose kernel parameters are fixed before the
//           handle exists);
//   then    a kernel of a WHILE body sets both the WHILE's condition and that
//           of an IF node later in the same body;
//   outer   a kernel of a WHILE body sets the condition of an IF node of the
//           enclosing graph, after the WHILE;
//   nested  as child, for a WHILE nested in the body of another WHILE (whose
//           handle the nested one's body reads from memory too), as a
//           resample loop's commit sits inside the bounce loop.
//
// Each case runs a WHILE of kRuns runs whose body counts its runs.  A guard
// kernel placed directly in the body ends the loop after kRuns + kGuard runs
// whatever the case's own kernel did, so a set that the card ignores shows as
// a count, not a hang.  Prints one JSON line a case: whether the graph built,
// instantiated and ran, and what the counters read.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O2 \
//       -o /tmp/probe tools/probe_graph_conditionals.cu
//   for c in child then outer nested; do timeout 30 /tmp/probe $c; done

#include <cuda_runtime.h>

#include <cstdio>
#include <cstring>

namespace {

constexpr int kRuns = 1000;
constexpr int kGuard = 10;

struct Counters {
  unsigned long long handle;  // the WHILE's handle, for the child kernel
  int runs;                   // bodies run
  int then_runs;              // bodies of the IF inside the WHILE
  int outer_runs;             // bodies of the IF after the WHILE
  int outer_whiles;           // nested: bodies of the enclosing WHILE
  unsigned long long inner;   // nested: the inner WHILE's handle
};

__global__ void entry_kernel(cudaGraphConditionalHandle h, Counters* c) {
  c->handle = h;
  cudaGraphSetConditional(h, 1u);
}

// counts the run and sets the WHILE (from the handle in memory)
__global__ void child_kernel(Counters* c) {
  c->runs += 1;
  cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(c->handle),
                          c->runs < kRuns ? 1u : 0u);
}

// counts the run and sets the WHILE and the IF after it in the body
__global__ void then_kernel(cudaGraphConditionalHandle w, cudaGraphConditionalHandle i,
                            Counters* c) {
  c->runs += 1;
  const unsigned go = c->runs < kRuns ? 1u : 0u;
  cudaGraphSetConditional(w, go);
  cudaGraphSetConditional(i, go);
}

// counts the run, sets the WHILE and, on its last run, the IF after it
__global__ void outer_kernel(cudaGraphConditionalHandle w, cudaGraphConditionalHandle i,
                             Counters* c) {
  c->runs += 1;
  const unsigned go = c->runs < kRuns ? 1u : 0u;
  cudaGraphSetConditional(w, go);
  if (!go) cudaGraphSetConditional(i, 1u);
}

__global__ void guard_kernel(cudaGraphConditionalHandle w, Counters* c) {
  if (c->runs >= kRuns + kGuard) cudaGraphSetConditional(w, 0u);
}

// nested: the enclosing WHILE's body starts the inner loop (its entry test:
// the handle to memory, the condition 1) ...
__global__ void inner_entry_kernel(cudaGraphConditionalHandle h, Counters* c) {
  c->inner = h;
  c->runs = 0;
  cudaGraphSetConditional(h, 1u);
}

// ... whose body's child kernel counts and sets it from memory ...
__global__ void inner_child_kernel(Counters* c) {
  c->runs += 1;
  cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(c->inner),
                          c->runs < kRuns / 10 ? 1u : 0u);
}

// ... with a guard beside it; and the enclosing WHILE runs three bodies
__global__ void inner_guard_kernel(Counters* c) {
  if (c->runs >= kRuns / 10 + kGuard) {
    cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(c->inner), 0u);
  }
}

__global__ void outer_test_kernel(cudaGraphConditionalHandle w, Counters* c) {
  c->outer_whiles += 1;
  c->outer_runs += c->runs;
  cudaGraphSetConditional(w, c->outer_whiles < 3 ? 1u : 0u);
}

__global__ void count_kernel(int* n) { *n += 1; }

cudaError_t add_kernel(cudaGraph_t g, cudaGraphNode_t* tail, void* fn, void** args) {
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, g, *tail ? tail : nullptr, *tail ? 1 : 0, &p);
  if (err == cudaSuccess) *tail = node;
  return err;
}

cudaError_t add_cond(cudaGraph_t g, cudaGraphNode_t* tail, cudaGraphConditionalHandle h,
                     cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddNode(&node, g, *tail ? tail : nullptr, *tail ? 1 : 0, &p);
  if (err == cudaSuccess) {
    *tail = node;
    *body = p.conditional.phGraph_out[0];
  }
  return err;
}

#define TRY(stage, call)                                                                  \
  do {                                                                                    \
    cudaError_t e_ = (call);                                                              \
    if (e_ != cudaSuccess) {                                                              \
      std::printf("{\"case\": \"%s\", \"stage\": \"%s\", \"error\": \"%s\"}\n", name,       \
                  stage, cudaGetErrorString(e_));                                         \
      return 1;                                                                           \
    }                                                                                     \
  } while (0)

int run(const char* name) {
  Counters* c;
  TRY("alloc", cudaMalloc(&c, sizeof(Counters)));
  TRY("zero", cudaMemset(c, 0, sizeof(Counters)));
  cudaGraph_t g;
  TRY("create", cudaGraphCreate(&g, 0));
  cudaGraphConditionalHandle w, i = 0;
  TRY("handle", cudaGraphConditionalHandleCreate(&w, g, 0, 0));
  cudaGraphNode_t tail = nullptr;
  void* entry_args[] = {&w, &c};
  TRY("entry", add_kernel(g, &tail, reinterpret_cast<void*>(entry_kernel), entry_args));
  cudaGraph_t body;
  TRY("while", add_cond(g, &tail, w, cudaGraphCondTypeWhile, &body));
  cudaGraphNode_t btail = nullptr;
  if (!std::strcmp(name, "child")) {
    cudaGraph_t child;
    TRY("child", cudaGraphCreate(&child, 0));
    cudaGraphNode_t ctail = nullptr;
    void* args[] = {&c};
    TRY("child kernel", add_kernel(child, &ctail, reinterpret_cast<void*>(child_kernel), args));
    cudaGraphNode_t node;
    TRY("child node", cudaGraphAddChildGraphNode(&node, body, nullptr, 0, child));
    btail = node;
  } else if (!std::strcmp(name, "then")) {
    TRY("then handle", cudaGraphConditionalHandleCreate(&i, body, 0, 0));
    void* args[] = {&w, &i, &c};
    TRY("then kernel", add_kernel(body, &btail, reinterpret_cast<void*>(then_kernel), args));
  } else if (!std::strcmp(name, "outer")) {
    TRY("outer handle", cudaGraphConditionalHandleCreate(&i, g, 0, cudaGraphCondAssignDefault));
    void* args[] = {&w, &i, &c};
    TRY("outer kernel", add_kernel(body, &btail, reinterpret_cast<void*>(outer_kernel), args));
  } else if (!std::strcmp(name, "nested")) {
    cudaGraphConditionalHandle h;
    TRY("inner handle", cudaGraphConditionalHandleCreate(&h, body, 0, 0));
    void* entry[] = {&h, &c};
    TRY("inner entry", add_kernel(body, &btail, reinterpret_cast<void*>(inner_entry_kernel), entry));
    cudaGraph_t ib;
    TRY("inner while", add_cond(body, &btail, h, cudaGraphCondTypeWhile, &ib));
    cudaGraph_t child;
    TRY("child", cudaGraphCreate(&child, 0));
    cudaGraphNode_t ctail = nullptr;
    void* args[] = {&c};
    TRY("child kernel", add_kernel(child, &ctail, reinterpret_cast<void*>(inner_child_kernel), args));
    cudaGraphNode_t node;
    TRY("child node", cudaGraphAddChildGraphNode(&node, ib, nullptr, 0, child));
    cudaGraphNode_t itail = node;
    TRY("inner guard", add_kernel(ib, &itail, reinterpret_cast<void*>(inner_guard_kernel), args));
    void* test[] = {&w, &c};
    TRY("outer test", add_kernel(body, &btail, reinterpret_cast<void*>(outer_test_kernel), test));
  } else {
    std::printf("{\"case\": \"%s\", \"error\": \"unknown case\"}\n", name);
    return 2;
  }
  void* guard_args[] = {&w, &c};
  if (std::strcmp(name, "nested")) {
    TRY("guard", add_kernel(body, &btail, reinterpret_cast<void*>(guard_kernel), guard_args));
  }
  if (!std::strcmp(name, "then")) {
    cudaGraph_t ib;
    TRY("then if", add_cond(body, &btail, i, cudaGraphCondTypeIf, &ib));
    cudaGraphNode_t itail = nullptr;
    int* n = &c->then_runs;
    void* args[] = {&n};
    TRY("then count", add_kernel(ib, &itail, reinterpret_cast<void*>(count_kernel), args));
  }
  if (!std::strcmp(name, "outer")) {
    cudaGraph_t ob;
    TRY("outer if", add_cond(g, &tail, i, cudaGraphCondTypeIf, &ob));
    cudaGraphNode_t otail = nullptr;
    int* n = &c->outer_runs;
    void* args[] = {&n};
    TRY("outer count", add_kernel(ob, &otail, reinterpret_cast<void*>(count_kernel), args));
  }
  cudaGraphExec_t exec;
  TRY("instantiate", cudaGraphInstantiate(&exec, g, 0));
  cudaStream_t s;
  TRY("stream", cudaStreamCreate(&s));
  TRY("launch", cudaGraphLaunch(exec, s));
  TRY("run", cudaStreamSynchronize(s));
  Counters h;
  TRY("read", cudaMemcpy(&h, c, sizeof(h), cudaMemcpyDeviceToHost));
  const bool nested = !std::strcmp(name, "nested");
  const bool honoured =
      nested ? h.outer_whiles == 3 && h.outer_runs == 3 * (kRuns / 10)
             : h.runs == kRuns && (std::strcmp(name, "then") || h.then_runs == kRuns - 1) &&
                   (std::strcmp(name, "outer") || h.outer_runs == 1);
  std::printf("{\"case\": \"%s\", \"ran\": true, \"runs\": %d, \"want_runs\": %d, "
              "\"then_runs\": %d, \"outer_runs\": %d, \"outer_whiles\": %d, "
              "\"set_honoured\": %s}\n",
              name, h.runs, nested ? kRuns / 10 : kRuns, h.then_runs, h.outer_runs,
              h.outer_whiles, honoured ? "true" : "false");
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s child|then|outer|nested\n", argv[0]);
    return 2;
  }
  return run(argv[1]);
}
