// Fused linear-model loss and gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/linear_grad.py::linear_value_grad
// (Pallas body `_kernel`, wrapped by src/repro/kernels/ops.py).  For
// X (n, d), y (n,) in {-1, +1} and w (d,), all float32, it computes
//
//     m_i = y_i * <x_i, w>,   L = sum_i l(m_i),   g = sum_i l'(m_i) * y_i * x_i
//
// for the squared hinge (l = max(0, 1 - m)^2) and the logistic loss
// (l = softplus(-m)), accumulating in float32.
//
// What bounds it on the card: memory.  It must read 4*(n*d + n + d) bytes
// and write 4*(d + 1), and does about 4*n*d flops, so its intensity is about
// one flop per byte, far below the H100's ~20 float32 flops per byte of
// device memory (67 TF/s over 3.35 TB/s).  The least time is the bytes over
// 3.35 TB/s.
//
// What the design does about it: X is read from device memory once.  A warp
// owns one row at a time; its lanes load the row coalesced (lane l holds
// columns l, l + 32, ...), reduce the dot product with shuffles, evaluate
// l and l' on every lane, and add r * x into a per-lane gradient partial
// from the same registers, so the forward dot and the transposed
// accumulation share one read.  Rows are unrolled U at a time so that each
// warp keeps several independent loads in flight.
//
// The TPU kernel carried one resident gradient tile across a sequential
// grid; Hopper's blocks run in parallel and in no order.  So each block
// writes one (d + 1) partial (gradient and loss) to scratch, and a second
// small kernel sums the partials across blocks in a fixed order.  No float
// atomics anywhere: the result is bit-reproducible from run to run.
//
// Limits: 1 <= d <= kMaxD (columns per lane are a template parameter), X
// row-major and contiguous.  Ragged n is masked in the kernel (the TPU
// wrapper padded to block_m and subtracted the padding's loss instead).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 2048;            // 64 columns per lane
constexpr int kMinItersPerWarp = 4;    // rows-per-warp floor, in U-row groups
constexpr int kBlocksPerSm = 4;
constexpr int kFinCols = 32;
constexpr int kFinRows = 16;

enum Loss { kSquaredHinge = 0, kLogistic = 1 };

__host__ __device__ constexpr int rows_unroll(int cols) {
  return cols <= 2 ? 8 : cols <= 8 ? 4 : cols <= 16 ? 2 : 1;
}

int cols_per_lane(int d) {
  int c = 1;
  while (32 * c < d) c *= 2;
  return c;
}

__device__ __forceinline__ void loss_and_slope(float m, int loss, float* li,
                                               float* dm) {
  if (loss == kSquaredHinge) {
    const float h = fmaxf(0.f, 1.f - m);
    *li = h * h;
    *dm = -2.f * h;
  } else {
    // softplus(-m) = max(-m, 0) + log1p(exp(-|m|)); l' = -sigmoid(-m)
    const float e = expf(-fabsf(m));
    *li = fmaxf(-m, 0.f) + log1pf(e);
    *dm = -(m >= 0.f ? e / (1.f + e) : 1.f / (1.f + e));
  }
}

// One (d + 1) partial per block: columns 0..d-1 the gradient, column d the
// loss.  C = columns per lane (power of two), U = rows a warp loads at once.
template <int C, int U>
__global__ void __launch_bounds__(kThreads)
lvg_partial(const float* __restrict__ X, const float* __restrict__ y,
            const float* __restrict__ w, float* __restrict__ partial,
            long long n, int d, int loss) {
  extern __shared__ float smem[];
  float* w_s = smem;        // d
  float* red = smem + d;    // d + 1
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < d; j += kThreads) w_s[j] = w[j];
  __syncthreads();

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float lsum = 0.f;

  const long long first = ((long long)blockIdx.x * kWarps + warp) * U;
  const long long step = (long long)gridDim.x * kWarps * U;
  for (long long base = first; base < n; base += step) {
    float x[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        x[u][c] = (i < n && col < d) ? __ldg(X + i * d + col) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + u;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col < d) dot = fmaf(x[u][c], w_s[col], dot);
      }
      // xor butterfly: every lane ends with the same, full sum
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (i < n) {    // uniform across the warp
        const float yi = __ldg(y + i);
        float li, dm;
        loss_and_slope(yi * dot, loss, &li, &dm);
        const float r = dm * yi;
        lsum += li;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(r, x[u][c], acc[c]);
      }
    }
  }

  // block reduction in warp order (deterministic)
#pragma unroll 1
  for (int wp = 0; wp < kWarps; ++wp) {
    if (warp == wp) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col < d) red[col] = wp ? red[col] + acc[c] : acc[c];
      }
      if (lane == 0) red[d] = wp ? red[d] + lsum : lsum;
    }
    __syncthreads();
  }
  float* out = partial + (long long)blockIdx.x * (d + 1);
  for (int j = threadIdx.x; j <= d; j += kThreads) out[j] = red[j];
}

// out[j] = sum over blocks b of partial[b][j], in a fixed order: row group
// ty sums its contiguous range of blocks, then the groups are added in ty
// order.
__global__ void __launch_bounds__(kFinCols * kFinRows)
lvg_finalize(const float* __restrict__ partial, int blocks, int d1,
             float* __restrict__ out) {
  __shared__ float buf[kFinRows][kFinCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kFinCols + tx;
  const int chunk = (blocks + kFinRows - 1) / kFinRows;
  const int b0 = ty * chunk;
  const int b1 = min(blocks, b0 + chunk);
  float s = 0.f;
  if (j < d1)
    for (int b = b0; b < b1; ++b) s += partial[(long long)b * d1 + j];
  buf[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < d1) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kFinRows; ++r) t += buf[r][tx];
    out[j] = t;
  }
}

template <int C>
cudaError_t launch_partial(const float* X, const float* y, const float* w,
                           float* partial, long long n, int d, int loss,
                           int grid, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)d + 1) * sizeof(float);
  lvg_partial<C, rows_unroll(C)><<<grid, kThreads, smem, stream>>>(
      X, y, w, partial, n, d, loss);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lvg_max_d() { return kMaxD; }

// Blocks of the first kernel (= rows of the partial scratch the caller
// allocates as (grid, d + 1) float32); -1 for an unsupported shape.
int lvg_grid(long long n, int d, int num_sms) {
  if (d < 1 || d > kMaxD || n < 0 || num_sms < 1) return -1;
  const long long rows = (long long)kWarps * rows_unroll(cols_per_lane(d)) *
                         kMinItersPerWarp;
  long long g = (n + rows - 1) / rows;
  const long long cap = (long long)num_sms * kBlocksPerSm;
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  return (int)g;
}

// Launches both kernels on `stream`; out is (d + 1) float32: g then L.
// Returns cudaGetLastError() after the launches (0 on success).
int lvg_launch(const void* X, const void* y, const void* w, void* partial,
               void* out, long long n, int d, int loss, int grid,
               void* stream) {
  if (d < 1 || d > kMaxD || n < 0 || grid < 1 ||
      (loss != kSquaredHinge && loss != kLogistic))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  cudaError_t err;
  switch (cols_per_lane(d)) {
    case 1: err = launch_partial<1>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    case 2: err = launch_partial<2>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    case 4: err = launch_partial<4>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    case 8: err = launch_partial<8>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    case 16: err = launch_partial<16>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    case 32: err = launch_partial<32>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    case 64: err = launch_partial<64>(Xf, yf, wf, pf, n, d, loss, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int d1 = d + 1;
  lvg_finalize<<<(d1 + kFinCols - 1) / kFinCols, dim3(kFinCols, kFinRows), 0,
                 s>>>(pf, grid, d1, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* lvg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
