// The Two-Track race as one device-side loop on Hopper (sm_90a): a CUDA
// graph whose conditional WHILE node repeats one captured race step.
//
// Replaces no TPU kernel.  The reference runs a racing stage as one
// lax.while_loop (src/repro/core/engine.py::_two_track_kernel): in each
// iteration both tracks step, f^ is written into three history buffers
// at the device step index s, and condition (3) is tested on the device;
// the loop stops at the trigger or at max_iters, and the histories come
// back in one device_get.  Eager PyTorch has no device-side loop, and
// torch.cuda.CUDAGraph offers only an IF node, so the loop is built here
// from the CUDA runtime's conditional nodes (CUDA 12.3 or later, in both
// the runtime and the driver):
//
//   1. dw_create makes the parent graph and its conditional handle, whose
//      default value (what the first iteration sees) the caller sets to
//      max_iters > 1;
//   2. the caller captures one race step with torch.cuda.CUDAGraph
//      (keep_graph=True), ending with dw_condition, which launches the
//      condition kernel below on the capture stream;
//   3. dw_finish adds the WHILE node to the parent and the captured graph
//      to its body as a child graph node, and instantiates the parent;
//   4. dw_launch launches the parent once on the caller's stream.
//
// The condition kernel, with s the steps done before the step just run
// (the one that wrote index s of the histories), sets
//
//     done = s + 1 >= 2  and  hist_slow[max(0, (s + 1) / 2 - 1)] < hist_fast[s]
//
// (the reference's test at engine.py:480-483), stores s + 1, and sets the
// handle to !done && s + 1 < max_iters.  One thread: the work is two loads
// and two stores; what bounds the loop is the race step it repeats.
#include <cuda_runtime.h>

namespace {

__global__ void race_condition(const float* __restrict__ hist_slow,
                               const float* __restrict__ hist_fast,
                               long long* s, bool* done, long long max_iters,
                               cudaGraphConditionalHandle handle) {
  const long long s0 = *s;
  const long long s1 = s0 + 1;
  const long long k = s1 / 2 - 1 > 0 ? s1 / 2 - 1 : 0;
  const bool hit = s1 >= 2 && hist_slow[k] < hist_fast[s0];
  *done = hit;
  *s = s1;
  cudaGraphSetConditional(handle, (!hit && s1 < max_iters) ? 1u : 0u);
}

struct Loop {
  cudaGraph_t parent = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
};

}  // namespace

extern "C" {

// The runtime's and the driver's CUDA versions (1000 * major + 10 * minor).
int dw_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDriverGetVersion(driver);
}

// A new parent graph and its WHILE handle, whose value at each launch of
// the instantiated graph is default_value.
int dw_create(unsigned default_value, void** loop_out,
              unsigned long long* handle_out) {
  Loop* loop = new Loop();
  cudaError_t err = cudaGraphCreate(&loop->parent, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&loop->handle, loop->parent,
                                           default_value,
                                           cudaGraphCondAssignDefault);
  if (err != cudaSuccess) {
    if (loop->parent) cudaGraphDestroy(loop->parent);
    delete loop;
    return (int)err;
  }
  *loop_out = loop;
  *handle_out = loop->handle;
  return 0;
}

// Launches the condition kernel on `stream` (the capture stream of the
// race step).  hist_slow and hist_fast hold max_iters float32 each; s is
// one int64, done one bool.
int dw_condition(const void* hist_slow, const void* hist_fast, void* s,
                 void* done, long long max_iters, unsigned long long handle,
                 void* stream) {
  race_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist_slow),
      static_cast<const float*>(hist_fast), static_cast<long long*>(s),
      static_cast<bool*>(done), max_iters,
      static_cast<cudaGraphConditionalHandle>(handle));
  return (int)cudaGetLastError();
}

// Puts the captured race step `body` (a cudaGraph_t) into the body of a
// WHILE node of the loop's parent graph, and instantiates the parent.
// The body is cloned into the node; the memory its kernels use stays the
// caller's to keep alive until the launch has run.
int dw_finish(void* loop_ptr, void* body) {
  Loop* loop = static_cast<Loop*>(loop_ptr);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = loop->handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaGraphAddNode(&node, loop->parent, nullptr, nullptr, 0, &params);
#else
  cudaError_t err = cudaGraphAddNode(&node, loop->parent, nullptr, 0, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGraphInstantiate(&loop->exec, loop->parent, 0);
}

int dw_launch(void* loop_ptr, void* stream) {
  return (int)cudaGraphLaunch(static_cast<Loop*>(loop_ptr)->exec,
                              static_cast<cudaStream_t>(stream));
}

// Frees the loop's graphs; the caller has waited for its launch.
int dw_destroy(void* loop_ptr) {
  Loop* loop = static_cast<Loop*>(loop_ptr);
  cudaError_t err = cudaSuccess;
  if (loop->exec) err = cudaGraphExecDestroy(loop->exec);
  cudaError_t err2 = cudaGraphDestroy(loop->parent);
  delete loop;
  return (int)(err != cudaSuccess ? err : err2);
}

const char* dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
