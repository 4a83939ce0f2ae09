// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (Pallas body `_kernel`, wrapped by src/repro/kernels/ops.py::rglru_scan).
// For a, b (B, S, W) in T (float32 or bfloat16) it computes, with h_0 = 0,
//
//     h_t = a_t * h_{t-1} + b_t          (per channel, carried in float32)
//     y_t = h_t cast to T
//
// What bounds it on the card.  Bytes: a and b are read once and y written
// once, 3 * B*S*W elements.  At the recurrentgemma-9b path shape (B 2,
// S 4096, W 4096, bfloat16) that is 201 MB, 60 us at 3.35 TB/s.  The
// arithmetic is one FMA per element, nothing next to the bytes.  But the
// recurrence is sequential in t: one thread per (batch row, channel) gives
// only B*W = 8,192 threads, each walking 4,096 dependent steps, so the
// kernel is bound by how many loads each thread keeps in flight (latency),
// not by HBM bandwidth.
//
// What the design does about it.  A block covers kThreads contiguous
// channels of one batch row, so the loads of a_t, b_t and the store of y_t
// are coalesced (W is the fastest axis); small blocks (64 threads) spread
// the 8,192 threads over 128 SMs instead of 64.  A thread loads kTile steps
// of a and b into registers before it runs the recurrence over them, so
// 2 * kTile independent loads are in flight at once; the FMA chain is the
// only sequential dependency.  A chunked two-pass scan (per-chunk partial
// products, then a carry fix-up) that puts S/chunk times more threads to
// work is later work.  The TPU kernel's (bw,) VMEM state and its block_w
// shrinking to a divisor of W have no counterpart: a ragged last block is
// masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 32;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (ceil(W / kThreads), batch); one thread per (batch row, channel)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ y, int S, int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= W) return;           // no barrier below: masked lanes just leave
  const long long base = (long long)blockIdx.y * S * W + c;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int len = min(kTile, S - t0);
    float av[kTile], bv[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < len) {
        const long long off = base + (long long)(t0 + i) * W;
        av[i] = to_f32(a[off]);
        bv[i] = to_f32(b[off]);
      } else {
        av[i] = bv[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < len) {
        h = fmaf(av[i], h, bv[i]);
        y[base + (long long)(t0 + i) * W] = from_f32<T>(h);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream`; y is (batch, S, W) in a's type.  Returns
// cudaGetLastError() after the launch (0 on success); an empty problem
// launches nothing.
int rglru_scan_launch(const void* a, const void* b, void* y, int batch, int S,
                      int W, int dtype, void* stream) {
  if (batch < 0 || batch > 65535 || S < 0 || W < 0 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0 || W == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kThreads - 1) / kThreads, batch);
  if (dtype == kFloat32)
    rglru_scan_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(y), S, W);
  else
    rglru_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(y), S, W);
  return (int)cudaGetLastError();
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
