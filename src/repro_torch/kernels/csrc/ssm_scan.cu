// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan (Pallas
// body `_kernel`, wrapped by src/repro/kernels/ops.py::ssm_scan).  For
// u, delta (B, S, di) and Bm, Cm (B, S, N) in T (float32 or bfloat16),
// A_log (di, N) and D (di,) in float32, it computes with h_0 = 0
//
//     A   = -exp(A_log)
//     h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) (x) Bm_t   (di, N)
//     y_t = h_t . Cm_t + u_t * D                                    (di,)
//
// carrying h in float32 and writing y in T.
//
// What bounds it on the card.  Bytes: it must read u and delta, Bm and Cm
// once and write y once, 2|u| + |y| + 2|Bm| bytes.  At the LM path's shape
// (B 8, S 256, di 8192, N 16, bfloat16) that is 3 x 33.5 MB + 2 x 65.5 KB
// = 100.8 MB, 30.1 us at 3.35 TB/s.  Operations: B*S*di*N = 268M
// exponentials, which run on the SFU (multi-function unit), 16 a clock on
// each of 132 SMs: 4.2e12 a second at 1.98 GHz, so 64 us, about twice the
// byte time.  Beside them ~6 float32 operations per (t, channel, n), 1.6
// GFLOP, 24 us at 67 TF/s.  So the SFU binds before HBM does.
//
// What the design does about it.  One exponential per (t, channel, n) and
// no more: A is folded with log2(e) once per thread, so each is one
// multiply and one `ex2` on the SFU, and the remaining arithmetic is three
// FMAs.  Each thread owns one (batch row, channel) and keeps its N states
// and its N folded A values in registers; the N recurrences of a thread
// are independent, so a step issues N exponentials back to back and the
// SFU's latency is hidden within the thread as well as across warps.  A
// block covers 128 contiguous channels of one batch row, so the loads of u
// and delta at each t and the store of y are coalesced (di is the fastest
// axis).  Bm_t and Cm_t are shared by every channel of a batch row: a tile
// of kTile steps of them is staged in shared memory (as float32, zero
// padded to the template width NP) and read as broadcasts.  A thread loads
// its kTile values of u and delta into registers before the recurrence
// over the tile, so those loads are in flight together; the recurrence is
// the only sequential dependency.  Moving some exponentials off the SFU
// (a polynomial on the FMA units) is later work.
//
// Limits: 1 <= N <= 16 (NP = 4, 8 or 16 by template), every tensor
// contiguous.  Channels past di (a ragged last block) are masked in the
// kernel; the TPU wrapper instead shrank its block to a divisor of di.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;
constexpr int kMaxN = 16;
constexpr float kLog2e = 1.4426950408889634f;

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

// grid (ceil(di / kThreads), batch); one thread per (batch row, channel)
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ A_log, const float* __restrict__ D,
                T* __restrict__ y, int S, int di, int N) {
  __shared__ float Bs[kTile][NP];
  __shared__ float Cs[kTile][NP];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < di;
  const long long row0 = (long long)blockIdx.y * S;

  float A2[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    // padded states (n >= N) get A = 0 and B = C = 0: they stay 0
    A2[n] = (live && n < N) ? -expf(A_log[(long long)c * N + n]) * kLog2e
                            : 0.f;
    h[n] = 0.f;
  }
  const float Dc = live ? D[c] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int len = min(kTile, S - t0);
    __syncthreads();            // the previous tile's readers are done
    for (int i = threadIdx.x; i < kTile * NP; i += kThreads) {
      const int tt = i / NP, n = i % NP;
      float bv = 0.f, cv = 0.f;
      if (tt < len && n < N) {
        const long long off = (row0 + t0 + tt) * N + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      Bs[tt][n] = bv;
      Cs[tt][n] = cv;
    }
    __syncthreads();
    if (!live) continue;        // every thread still reaches the syncs above

    float uu[kTile], dd[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < len) {
        const long long off = (row0 + t0 + i) * di + c;
        uu[i] = to_f32(u[off]);
        dd[i] = to_f32(delta[off]);
      } else {
        uu[i] = dd[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < len) {            // uniform across the block
        const float du = dd[i] * uu[i];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          h[n] = fmaf(exp2f(dd[i] * A2[n]), h[n], du * Bs[i][n]);
          acc = fmaf(h[n], Cs[i][n], acc);
        }
        y[(row0 + t0 + i) * di + c] = from_f32<T>(fmaf(uu[i], Dc, acc));
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* u, const void* delta, const void* Bm,
                         const void* Cm, const float* A_log, const float* D,
                         void* y, int batch, int S, int di, int N,
                         cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  const T* uT = static_cast<const T*>(u);
  const T* dT = static_cast<const T*>(delta);
  const T* bT = static_cast<const T*>(Bm);
  const T* cT = static_cast<const T*>(Cm);
  T* yT = static_cast<T*>(y);
  if (N <= 4)
    ssm_scan_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        uT, dT, bT, cT, A_log, D, yT, S, di, N);
  else if (N <= 8)
    ssm_scan_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        uT, dT, bT, cT, A_log, D, yT, S, di, N);
  else
    ssm_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
        uT, dT, bT, cT, A_log, D, yT, S, di, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ssm_scan_max_state() { return kMaxN; }

// Launches the scan on `stream`; y is (batch, S, di) in u's type.  Returns
// cudaGetLastError() after the launch (0 on success); an empty problem
// launches nothing.
int ssm_scan_launch(const void* u, const void* delta, const void* Bm,
                    const void* Cm, const void* A_log, const void* D, void* y,
                    int batch, int S, int di, int N, int dtype, void* stream) {
  if (batch < 0 || batch > 65535 || S < 0 || di < 0 || N < 1 || N > kMaxN ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0 || di == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A_log);
  const float* Df = static_cast<const float*>(D);
  if (dtype == kFloat32)
    return (int)launch_typed<float>(u, delta, Bm, Cm, Af, Df, y, batch, S, di,
                                    N, s);
  return (int)launch_typed<__nv_bfloat16>(u, delta, Bm, Cm, Af, Df, y, batch,
                                          S, di, N, s);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
