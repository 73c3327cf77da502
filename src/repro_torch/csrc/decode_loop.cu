// The serving engine's decode-loop control for Hopper (sm_90a), and the
// CUDA graph that runs a chunk of decode ticks as one launch.
//
// Replaces no Pallas kernel.  It is the body epilogue and the cond of the
// JAX engine's on-device loop, src/repro/serving/engine.py:173 _decode_many
// (lines 195-217: the done-mask, the token writeback and the exit test of
// its lax.while_loop), which XLA fuses into the jitted loop.  The port runs
// that loop as a CUDA graph (repro_torch/serving/decode_graph.py): one tick
// is the model's in-place decode step, the sampler, then this kernel.
//
// What it computes, for the B slots of one tick i (buffers of int32, laid
// out by repro_torch/kernels/decode_loop/decode_loop.py):
//   inp = tokens | active | eos | remaining (B each) | limit | stop_on_free
//   out = n (= i) | toks (k, B) | acts (k, B) | dones (k, B)
//   ctl = freed | go
//   tokens    <- active ? sampled : tokens
//   remaining <- remaining - active
//   done       = active & ((eos >= 0 & sampled == eos)
//                          | lengths >= max_len - 1 | remaining <= 0)
//   row i of toks, acts, dones <- tokens, active, done
//   active    <- active & !done;  freed <- freed | any(done);  n <- i + 1
//   go         = n < limit & any(active) & !(stop_on_free & freed)
// and sets the graph's while condition to go.  The init form (once a
// chunk, before the first tick) zeroes out and freed and sets
// go = limit > 0 & any(active).
//
// What bounds it on this card: nothing but its launch.  It reads and
// writes a few dozen int32 a slot (B <= 1024), far under a microsecond of
// memory time; in the eager tick it replaced a dozen tiny PyTorch launches
// and a blocking host read.  One CTA of B threads (rounded up to a warp),
// the two any() as __syncthreads_or.
//
// The graph (decode_graph_*): an outer graph of [init kernel] -> [while
// node], whose body is a child-graph node holding one tick as PyTorch
// captured it.  The while condition is the handle this kernel sets, so a
// tick after the exit does not run (the lax.while_loop's semantics, not
// masked extra ticks), and a chunk is one cudaGraphLaunch.
//
// decode_graph_kernels lists the kernel nodes of a graph by their device
// functions' names (through the CUDA driver API, so it reads nodes that any
// library put there), for the launch counters of a replayed chunk.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

constexpr int kMaxSlots = 1024;  // B at most: one thread a slot (decode_loop.py: MAX_SLOTS)

__global__ void __launch_bounds__(kMaxSlots)
    decode_loop_kernel(const int* __restrict__ sampled, const int* __restrict__ lengths,
                       int* __restrict__ inp, int* __restrict__ out, int* __restrict__ ctl,
                       int B, int k, int max_len, int init,
                       cudaGraphConditionalHandle handle) {
  const int b = threadIdx.x;
  const bool live = b < B;
  int* tokens = inp;
  int* active = inp + B;
  const int* eos = inp + 2 * B;
  int* remaining = inp + 3 * B;
  const int limit = inp[4 * B];
  const int stop = inp[4 * B + 1];
  if (init) {
    for (int j = b; j < 1 + 3 * k * B; j += blockDim.x) out[j] = 0;
    const int any_active = __syncthreads_or(live && active[b] != 0);
    if (b == 0) {
      const int go = limit > 0 && any_active;
      ctl[0] = 0;
      ctl[1] = go;
      if (handle) cudaGraphSetConditional(handle, go);
    }
    return;
  }
  const int i = out[0];
  int done = 0, still = 0;
  if (live) {
    const int act = active[b] != 0;
    const int s = sampled[b];
    const int tok = act ? s : tokens[b];
    const int rem = remaining[b] - act;
    const int e = eos[b];
    done = act && ((e >= 0 && s == e) || lengths[b] >= max_len - 1 || rem <= 0);
    still = act && !done;
    tokens[b] = tok;
    remaining[b] = rem;
    active[b] = still;
    if (i < k) {
      out[1 + i * B + b] = tok;
      out[1 + (k + i) * B + b] = act;
      out[1 + (2 * k + i) * B + b] = done;
    }
  }
  // both barriers also order every thread's read of out[0] before its write
  const int any_done = __syncthreads_or(done);
  const int any_active = __syncthreads_or(still);
  if (b == 0) {
    const int freed = ctl[0] || any_done;
    const int go = i + 1 < limit && any_active && !(stop && freed);
    ctl[0] = freed;
    ctl[1] = go;
    out[0] = i + 1;
    if (handle) cudaGraphSetConditional(handle, go);
  }
}

int threads_for(int B) { return (B + 31) / 32 * 32; }

// A CUDA driver API function, looked up through the runtime so that the library
// links only against the CUDA runtime.
cudaError_t driver_fn(const char* name, int version, void** fn) {
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e =
      cudaGetDriverEntryPointByVersion(name, fn, version, cudaEnableDefault, &q);
#else
  (void)version;
  const cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
#endif
  if (e != cudaSuccess) return e;
  return q == cudaDriverEntryPointSuccess && *fn != nullptr ? cudaSuccess
                                                            : cudaErrorNotSupported;
}

constexpr int kDriverError = 100000;  // + a CUresult: a CUDA driver API call failed

struct GraphWalk {
  CUresult (*get_nodes)(CUgraph, CUgraphNode*, size_t*) = nullptr;
  CUresult (*node_type)(CUgraphNode, CUgraphNodeType*) = nullptr;
  CUresult (*kernel_params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*) = nullptr;
  CUresult (*child_graph)(CUgraphNode, CUgraph*) = nullptr;
  CUresult (*func_name)(const char**, CUfunction) = nullptr;
  CUresult (*kernel_name)(const char**, CUkernel) = nullptr;
  char* buf = nullptr;
  size_t cap = 0, used = 0;
  int counts[4] = {0, 0, 0, 0};  // kernel, memcpy, memset, other nodes

  int lookup() {
    struct {
      const char* name;
      int version;
      void** fn;
      bool needed;
    } want[] = {
        {"cuGraphGetNodes", 10000, reinterpret_cast<void**>(&get_nodes), true},
        {"cuGraphNodeGetType", 10000, reinterpret_cast<void**>(&node_type), true},
        {"cuGraphKernelNodeGetParams", 12000, reinterpret_cast<void**>(&kernel_params), true},
        {"cuGraphChildGraphNodeGetGraph", 10000, reinterpret_cast<void**>(&child_graph), true},
        {"cuFuncGetName", 12030, reinterpret_cast<void**>(&func_name), false},
        {"cuKernelGetName", 12030, reinterpret_cast<void**>(&kernel_name), false},
    };
    for (auto& w : want) {
      const cudaError_t e = driver_fn(w.name, w.version, w.fn);
      if (e != cudaSuccess) {
        *w.fn = nullptr;
        if (w.needed) return static_cast<int>(e);
      }
    }
    return 0;
  }

  void emit(const char* name) {
    const size_t n = strlen(name) + 1;  // and a newline
    if (used + n <= cap) {
      memcpy(buf + used, name, n - 1);
      buf[used + n - 1] = '\n';
    }
    used += n;
  }

  // Every kernel node of g and of the child graphs it holds; the bodies
  // of conditional nodes are not entered (counted as "other").
  int walk(CUgraph g) {
    size_t n = 0;
    CUresult r = get_nodes(g, nullptr, &n);
    if (r != CUDA_SUCCESS) return kDriverError + r;
    std::vector<CUgraphNode> nodes(n);
    if (n > 0 && (r = get_nodes(g, nodes.data(), &n)) != CUDA_SUCCESS) return kDriverError + r;
    for (size_t i = 0; i < n; ++i) {
      CUgraphNodeType t;
      if ((r = node_type(nodes[i], &t)) != CUDA_SUCCESS) return kDriverError + r;
      if (t == CU_GRAPH_NODE_TYPE_KERNEL) {
        CUDA_KERNEL_NODE_PARAMS_v2 p;
        memset(&p, 0, sizeof(p));
        if ((r = kernel_params(nodes[i], &p)) != CUDA_SUCCESS) return kDriverError + r;
        const char* name = nullptr;
        if (p.func != nullptr && func_name != nullptr) {
          r = func_name(&name, p.func);
        } else if (p.kern != nullptr && kernel_name != nullptr) {
          r = kernel_name(&name, p.kern);
        } else {
          return static_cast<int>(cudaErrorNotSupported);
        }
        if (r != CUDA_SUCCESS) return kDriverError + r;
        emit(name != nullptr ? name : "?");
        ++counts[0];
      } else if (t == CU_GRAPH_NODE_TYPE_GRAPH) {
        CUgraph child;
        if ((r = child_graph(nodes[i], &child)) != CUDA_SUCCESS) return kDriverError + r;
        const int e = walk(child);
        if (e != 0) return e;
      } else {
        ++counts[t == CU_GRAPH_NODE_TYPE_MEMCPY ? 1 : t == CU_GRAPH_NODE_TYPE_MEMSET ? 2 : 3];
      }
    }
    return 0;
  }
};

}  // namespace

// Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_loop/decode_loop.py.  Each returns a
// cudaError_t (0 on success), or -1 for arguments the kernel does not take.

// One launch of the control kernel on `stream` (init != 0: the chunk's
// init form; sampled and lengths are then unused).  handle 0 sets no
// graph condition (the eager loop reads go from ctl instead).
extern "C" int decode_loop_epilogue(const void* sampled, const void* lengths, void* inp,
                                    void* out, void* ctl, int B, int k, int max_len, int init,
                                    unsigned long long handle, void* stream) {
  if (B < 1 || B > kMaxSlots || k < 1 || max_len < 2 || inp == nullptr || out == nullptr ||
      ctl == nullptr || (!init && (sampled == nullptr || lengths == nullptr)))
    return -1;
  decode_loop_kernel<<<1, threads_for(B), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sampled), static_cast<const int*>(lengths),
      static_cast<int*>(inp), static_cast<int*>(out), static_cast<int*>(ctl), B, k, max_len,
      init, static_cast<cudaGraphConditionalHandle>(handle));
  return static_cast<int>(cudaGetLastError());
}

// An empty outer graph and the handle of its while condition.  The tick is
// captured after this (its control kernel needs the handle), then
// decode_graph_finish builds the loop around it.
extern "C" int decode_graph_create(void** graph_out, unsigned long long* handle_out) {
  cudaGraph_t graph;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(e);
  }
  *graph_out = graph;
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// [init kernel] -> [while (handle) { child graph: tick }], instantiated.
// The tick graph is cloned into the body (returned in body_out, owned by
// the outer graph); the caller keeps its memory (PyTorch's graph pool)
// alive for as long as the executable graph lives.
extern "C" int decode_graph_finish(void* graph_p, unsigned long long handle_v, void* tick,
                                   void* inp, void* out, void* ctl, int B, int k, int max_len,
                                   void** exec_out, void** body_out) {
  if (B < 1 || B > kMaxSlots || k < 1 || max_len < 2 || tick == nullptr) return -1;
  cudaGraph_t graph = static_cast<cudaGraph_t>(graph_p);
  cudaGraphConditionalHandle handle = static_cast<cudaGraphConditionalHandle>(handle_v);
  const int* none = nullptr;
  int init = 1;
  void* args[] = {&none, &none, &inp, &out, &ctl, &B, &k, &max_len, &init, &handle};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(decode_loop_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(threads_for(B));
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  cudaGraphNode_t init_node;
  cudaError_t e = cudaGraphAddKernelNode(&init_node, graph, nullptr, 0, &kp);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop_node;
  e = cudaGraphAddNode(&loop_node, graph, &init_node, 1, &cp);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t body_node;
  e = cudaGraphAddChildGraphNode(&body_node, body, nullptr, 0, static_cast<cudaGraph_t>(tick));
  if (e != cudaSuccess) return static_cast<int>(e);
  *body_out = body;
  cudaGraphExec_t exec;
  e = cudaGraphInstantiate(&exec, graph, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *exec_out = exec;
  return 0;
}

// The kernel nodes of `graph` and of the child graphs in it, not inside
// conditional nodes' bodies: their device functions' names, one a line,
// into buf (up to cap bytes; need_out gets the bytes the whole list takes,
// so a call with cap 0 sizes the buffer), and the count of kernel, memcpy,
// memset and other nodes into counts_out[4].  Returns 0, a cudaError_t, or
// 100000 + a CUresult when a CUDA driver API call fails.
extern "C" int decode_graph_kernels(void* graph, char* buf, unsigned long long cap,
                                    unsigned long long* need_out, int* counts_out) {
  if (graph == nullptr || need_out == nullptr || counts_out == nullptr ||
      (cap > 0 && buf == nullptr))
    return -1;
  GraphWalk w;
  int e = w.lookup();
  if (e != 0) return e;
  w.buf = buf;
  w.cap = cap;
  e = w.walk(static_cast<CUgraph>(graph));
  if (e != 0) return e;
  *need_out = w.used;
  for (int i = 0; i < 4; ++i) counts_out[i] = w.counts[i];
  return 0;
}

// One chunk: the whole loop as one launch on `stream`.
extern "C" int decode_graph_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int decode_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return static_cast<int>(e);
}
