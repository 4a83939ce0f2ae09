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
// exponentials.  On the SFU (multi-function unit), 16 a clock on each of
// 132 SMs, they take 64 us at 1.98 GHz, twice the byte time.  Beside each
// exponential are 4 float32 operations (delta*A, du*B, the state FMA, the
// output FMA) at 128 a clock, 32 us, and the issue slots (128 thread
// instructions a clock on an SM) bind next: each instruction per (t,
// channel, state) beyond those 5 costs as much as a quarter exponential.
// So the SFU binds first.  Moving a share of the exponentials onto the FMA
// pipe (a polynomial) was tried and lost: its ~10 instructions a state
// cost more issue slots than the SFU time they free.
//
// What the design does about it.
// - Exponentials.  Each is one `ex2.approx.ftz.f32`, a lone MUFU.EX2 (A is
//   folded with log2 e once).  The first design's exp2f, without
//   --use_fast_math, compiled to MUFU.EX2 inside a range fix-up: an
//   FSETP (x >= -126), a predicated FMUL by 0.5 before and a predicated
//   squaring after, three more issue slots per state and step.
// - Issue slots.  A thread owns the NP states of one channel; the states'
//   B_t and C_t are read as float4 broadcasts from shared memory.  y_t
//   sums the states in order in one accumulator, as the first design did
//   (at the LM path's shape y is bitwise the first design's; two
//   accumulators were no faster and moved 1,231 of 16.8M bf16 outputs by
//   an ulp).
// - Memory.  A block owns kThreads contiguous channels of one batch row.
//   u, delta, Bm and Cm arrive in tiles of kTile steps, loaded 16 bytes a
//   thread into registers one tile ahead of the scan (the loads of tile
//   k+1 are in flight while tile k is scanned) and stored to a
//   double-buffered shared tile (B and C converted to float32); y leaves
//   through a shared tile, 16 bytes a thread.  One __syncthreads a tile.
//
// Limits: 1 <= N <= 16 (NP = 4, 8 or 16 by template), every tensor
// contiguous.  Channels past di (a ragged last block) and steps past S (a
// ragged last tile) are masked; rows whose ends are not 16-byte aligned
// are loaded element by element.  The TPU wrapper instead shrank its
// block to a divisor of di.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;
constexpr int kMaxN = 16;
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Vec {                        // T values in one 16-byte chunk
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a chunk of kN values from p, of which the first `n` exist (the rest 0):
// one 16-byte load when all exist and `vec` says the address allows it
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int n, bool vec) {
  constexpr int kN = Vec<T>::kN;
  if (vec && n >= kN) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < n) e[i] = p[i];
  return r;
}

template <typename T, int NP>
struct Layout {
  static constexpr int CPB = kThreads;               // channels a block
  static constexpr int VN = Vec<T>::kN;
  static constexpr int kUChunks = kTile * CPB / VN;  // u (or delta) tile
  static constexpr int kUPer =                       // chunks a thread
      (kUChunks + kThreads - 1) / kThreads;
  static constexpr int kBCChunks = (kTile * NP + VN - 1) / VN;  // B (or C)
  static_assert(kUChunks % kThreads == 0 || kUChunks < kThreads, "u tile");
  static_assert(2 * kBCChunks <= kThreads, "B, C tile");
  // shared tiles, two buffers: u, delta and y in T, B and C in float32
  struct Smem {
    T u[2][kTile][CPB];
    T d[2][kTile][CPB];
    float4 b[2][kTile][NP / 4];
    float4 c[2][kTile][NP / 4];
    T y[2][kTile][CPB];
  };
};

// grid (ceil(di / CPB), batch); a thread per (batch row, channel)
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ A_log, const float* __restrict__ D,
                T* __restrict__ y, int S, int di, int N, int vec_u,
                int vec_bc) {
  using L = Layout<T, NP>;
  constexpr int CPB = L::CPB, VN = L::VN;
  extern __shared__ float4 smem_raw[];
  auto& sm = *reinterpret_cast<typename L::Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int ch = tid;
  const int c0 = blockIdx.x * CPB;
  const int c = c0 + ch;
  const bool live = c < di;
  const long long row0 = (long long)blockIdx.y * S;
  const int ntiles = (S + kTile - 1) / kTile;

  // padded states (n >= N) get A = 0 and B = C = 0: they stay 0
  float A2[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    A2[n] = (live && n < N) ? -expf(A_log[(long long)c * N + n]) * kLog2e
                            : 0.f;
    h[n] = 0.f;
  }
  const float Dc = live ? D[c] : 0.f;
  for (int i = tid; i < 2 * kTile * NP; i += kThreads) {
    float* b = reinterpret_cast<float*>(sm.b);
    float* cc = reinterpret_cast<float*>(sm.c);
    b[i] = cc[i] = 0.f;
  }

  // this thread's chunks of a tile: u and delta chunk tid + kThreads k,
  // and one chunk of B (tid < kBCChunks) or of C (the next kBCChunks)
  uint4 ru[L::kUPer], rd[L::kUPer], rbc;
  const bool is_b = tid < L::kBCChunks;
  const bool is_c = !is_b && tid < 2 * L::kBCChunks;
  const int bc_chunk = is_b ? tid : tid - L::kBCChunks;

  auto fetch = [&](int t0) {
    const int len = min(kTile, S - t0);
#pragma unroll
    for (int k = 0; k < L::kUPer; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / (CPB / VN), cc = c0 + (i % (CPB / VN)) * VN;
      const int n = r < len && i < L::kUChunks ? min(VN, di - cc) : 0;
      const long long off = (row0 + t0 + r) * di + cc;
      ru[k] = load_chunk(u + off, n, vec_u);
      rd[k] = load_chunk(delta + off, n, vec_u);
    }
    if (is_b || is_c) {
      const int f = bc_chunk * VN;                     // flat (step, state)
      const int n = min(VN, len * N - f);
      const T* src = (is_b ? Bm : Cm) + (row0 + t0) * N + f;
      rbc = load_chunk(src, n, vec_bc);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int k = 0; k < L::kUPer; ++k) {
      const int i = tid + k * kThreads;
      if (i >= L::kUChunks) break;
      const int r = i / (CPB / VN), cc = (i % (CPB / VN)) * VN;
      *reinterpret_cast<uint4*>(&sm.u[buf][r][cc]) = ru[k];
      *reinterpret_cast<uint4*>(&sm.d[buf][r][cc]) = rd[k];
    }
    if (is_b || is_c) {
      float v[VN];
      unpack(rbc, v, T());
      float* dst = reinterpret_cast<float*>(is_b ? sm.b[buf] : sm.c[buf]);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        const int f = bc_chunk * VN + e;
        if (f < kTile * N) dst[(f / N) * NP + f % N] = v[e];
      }
    }
  };
  auto store_y = [&](int buf, int t0) {
    const int len = min(kTile, S - t0);
#pragma unroll
    for (int k = 0; k < L::kUPer; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / (CPB / VN), cl = (i % (CPB / VN)) * VN;
      const int cc = c0 + cl;
      if (i >= L::kUChunks || r >= len || cc >= di) continue;
      T* dst = y + (row0 + t0 + r) * di + cc;
      const T* src = &sm.y[buf][r][cl];
      if (vec_u && cc + VN <= di) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < VN && cc + e < di; ++e) dst[e] = src[e];
      }
    }
  };

  fetch(0);
  __syncthreads();              // the zeroed B and C padding is written
  stash(0);
  __syncthreads();
  for (int k = 0; k < ntiles; ++k) {
    const int buf = k & 1, t0 = k * kTile;
    const int len = min(kTile, S - t0);
    if (k + 1 < ntiles) fetch(t0 + kTile);  // in flight during the scan
    for (int i = 0; i < len; ++i) {
      const float uu = to_f32(sm.u[buf][i][ch]);
      const float dd = to_f32(sm.d[buf][i][ch]);
      const float du = dd * uu;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < NP / 4; ++q) {
        const float4 b4 = sm.b[buf][i][q];
        const float4 c4 = sm.c[buf][i][q];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          h[n] = fmaf(ex2(dd * A2[n]), h[n], du * bv[e]);
          acc = fmaf(h[n], cv[e], acc);
        }
      }
      sm.y[buf][i][ch] = T(fmaf(uu, Dc, acc));
    }
    if (k + 1 < ntiles) stash(buf ^ 1);
    __syncthreads();            // y of tile k and tile k+1's inputs are in
    store_y(buf, t0);
  }
}

template <typename T, int NP>
cudaError_t launch_np(const T* u, const T* dl, const T* Bm, const T* Cm,
                      const float* A_log, const float* D, T* y, int batch,
                      int S, int di, int N, int vec_u, int vec_bc,
                      cudaStream_t stream) {
  using L = Layout<T, NP>;
  constexpr int bytes = sizeof(typename L::Smem);
  static bool opted = false;    // above 48 KB only after this, once
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const dim3 grid((di + L::CPB - 1) / L::CPB, batch);
  ssm_scan_kernel<T, NP><<<grid, kThreads, bytes, stream>>>(
      u, dl, Bm, Cm, A_log, D, y, S, di, N, vec_u, vec_bc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* u, const void* delta, const void* Bm,
                         const void* Cm, const float* A_log, const float* D,
                         void* y, int batch, int S, int di, int N,
                         cudaStream_t stream) {
  constexpr int VN = Vec<T>::kN;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_u = di % VN == 0 && aligned(u) && aligned(delta) &&
                    aligned(y);
  const int vec_bc = N % VN == 0 && aligned(Bm) && aligned(Cm);
  const T* uT = static_cast<const T*>(u);
  const T* dT = static_cast<const T*>(delta);
  const T* bT = static_cast<const T*>(Bm);
  const T* cT = static_cast<const T*>(Cm);
  T* yT = static_cast<T*>(y);
  if (N <= 4)
    return launch_np<T, 4>(uT, dT, bT, cT, A_log, D, yT, batch, S, di, N,
                           vec_u, vec_bc, stream);
  if (N <= 8)
    return launch_np<T, 8>(uT, dT, bT, cT, A_log, D, yT, batch, S, di, N,
                           vec_u, vec_bc, stream);
  return launch_np<T, 16>(uT, dT, bT, cT, A_log, D, yT, batch, S, di, N,
                          vec_u, vec_bc, stream);
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
