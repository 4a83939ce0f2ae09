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
// only B*W = 8,192 threads at that shape, two warps an SM, and keeps far
// too few loads in flight to reach the card's bandwidth.
//
// What the design does about it: a chunked scan over time, in one pass.
// The composition of steps t..u is itself one step h -> A*h + H, with
// A = prod a and H the chunk's h started from 0, so S is cut into chunks of
// kChunk steps and each block takes one chunk of one (batch row, tile of
// kCols 16-byte vectors of channels):
//
//   1. every thread loads kSteps steps of its vector of a and b into
//      registers (16-byte loads, all issued before the first use) and
//      scans them from 0, keeping (A, H) per channel;
//   2. one thread per channel folds the block's kGroups (A, H) in time
//      order into the chunk's aggregate, keeping each group's exclusive
//      prefix in shared memory;
//   3. the block publishes its aggregate to a per-call scratch and raises
//      its flag (release);
//   4. it waits for the flags of the earlier chunks of its column
//      (acquire) and folds their aggregates, in chunk order from h = 0,
//      into its carry-in;
//   5. every thread rescans its held steps from its carry-in and writes y.
//
// a and b are read from device memory once and y written once: the bytes
// are the bound's, plus 8 bytes per channel and chunk of aggregates in L2.
//
// Determinism.  Each carry-in is a fold over all earlier chunks in a fixed
// order, never a mix of prefixes and aggregates that depends on which
// block finished first, so the bits do not depend on timing, and kChunk is
// a constant, so they do not depend on the card either.  The fold costs a
// block (chunk index) L2 reads per channel, about C^2/2 over a column of C
// chunks (C = 16 at S = 4096).
//
// Forward progress.  A block takes a ticket from an atomic counter and
// works on the chunk the ticket names, chunk-major (all columns' chunk 0,
// then chunk 1, ...), so every chunk it waits on belongs to a block that
// is already running and waits on nothing later.
//
// Rounding.  The carry stays float32; composing chunks rounds at other
// places than the strictly sequential chain, so a bfloat16 y may differ by
// one ulp from a sequential scan.  With a in (0, 1), A underflows to 0 over
// a long chunk, which is harmless: 0 * h + H.
//
// The TPU kernel's (bw,) VMEM state and its block_w shrinking to a divisor
// of W have no counterpart: a ragged last chunk and a ragged channel tile
// are masked.  Where W is not a multiple of a vector, or a pointer is not
// 16-byte aligned, the same kernel loads and stores one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;                     // 16-byte vectors of channels
constexpr int kGroups = kThreads / kCols;    // time groups of a block, 32
constexpr int kSteps = 8;                    // steps a thread holds
constexpr int kChunk = kGroups * kSteps;     // steps a block, 256

enum DType { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kVec = 4;             // channels in 16 bytes
  // element k of a 16-byte vector, as float
  __device__ __forceinline__ static float get(const uint4& v, int k) {
    return __uint_as_float((&v.x)[k]);
  }
  __device__ __forceinline__ static void put(uint4& v, int k, float x) {
    (&v.x)[k] = __float_as_uint(x);
  }
  __device__ __forceinline__ static void load1(uint4& v, int k,
                                               const float* p) {
    (&v.x)[k] = __float_as_uint(__ldg(p));
  }
  __device__ __forceinline__ static void store1(float* p, const uint4& v,
                                                int k) {
    *p = __uint_as_float((&v.x)[k]);
  }
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float get(const uint4& v, int k) {
    const uint32_t w = (&v.x)[k >> 1];
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  // round to nearest even, as __float2bfloat16
  __device__ __forceinline__ static void put(uint4& v, int k, float x) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(x));
    uint32_t& w = (&v.x)[k >> 1];
    w = (k & 1) ? ((w & 0xffffu) | (h << 16)) : ((w & 0xffff0000u) | h);
  }
  __device__ __forceinline__ static void load1(uint4& v, int k,
                                               const __nv_bfloat16* p) {
    const uint32_t h = __bfloat16_as_ushort(__ldg(p));
    (&v.x)[k >> 1] |= (k & 1) ? (h << 16) : h;
  }
  __device__ __forceinline__ static void store1(__nv_bfloat16* p,
                                                const uint4& v, int k) {
    const uint32_t w = (&v.x)[k >> 1];
    *p = __ushort_as_bfloat16((unsigned short)((k & 1) ? (w >> 16) : w));
  }
};

// kVecIO: whole 16-byte vectors (W a multiple of a vector, pointers
// aligned); else one element at a time, masked to the channels < W
template <typename T, bool kVecIO>
__device__ __forceinline__ uint4 load_vec(const T* p, int valid) {
  constexpr int V = Traits<T>::kVec;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (kVecIO) {
    if (valid > 0) v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < valid) Traits<T>::load1(v, k, p + k);
  }
  return v;
}

template <typename T, bool kVecIO>
__device__ __forceinline__ void store_vec(T* p, const uint4& v, int valid) {
  constexpr int V = Traits<T>::kVec;
  if (kVecIO) {
    if (valid > 0) *reinterpret_cast<uint4*>(p) = v;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < valid) Traits<T>::store1(p + k, v, k);
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// One block per (chunk, column); a column is (batch row, channel tile).
// flags[0] is the ticket counter, flags[1 + block] the block's "published"
// flag, zero at launch; agg[block * tile + channel] its (A, H).
template <typename T, bool kVecIO>
__global__ void __launch_bounds__(kThreads, 2)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ y, int S, int W, int tiles, int columns,
                  int* __restrict__ flags, float2* __restrict__ agg) {
  constexpr int V = Traits<T>::kVec;
  constexpr int kTile = kCols * V;           // channels a block
  __shared__ float2 part[kGroups][kTile];    // (A, H), then exclusive prefix
  __shared__ float cin_s[kTile];
  __shared__ int ticket_s;

  const int tid = threadIdx.x;
  if (tid == 0) ticket_s = atomicAdd(flags, 1);
  __syncthreads();
  const int block = ticket_s;
  const int chunk = block / columns;
  const int col = block - chunk * columns;
  const int row = col / tiles;
  const int c0 = (col - row * tiles) * kTile + (tid % kCols) * V;
  const int g = tid / kCols;
  const int t0 = chunk * kChunk + g * kSteps;
  const int valid = W - c0;                  // channels of this vector < W
  const int steps = max(0, min(kSteps, S - t0));
  const long long base = (long long)row * S * W + c0;
  const bool published = chunk < (S - 1) / kChunk;   // a later chunk reads it

  // 1. load the held steps, all loads in flight before the first use
  uint4 av[kSteps], bv[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const long long off = base + (long long)(t0 + i) * W;
    const int v = i < steps ? valid : 0;
    av[i] = load_vec<T, kVecIO>(a + off, v);
    bv[i] = load_vec<T, kVecIO>(b + off, v);
  }
  float A[V], H[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    A[k] = 1.f;
    H[k] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (i < steps) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float ak = Traits<T>::get(av[i], k);
        H[k] = fmaf(ak, H[k], Traits<T>::get(bv[i], k));
        A[k] *= ak;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    part[g][(tid % kCols) * V + k] = make_float2(A[k], H[k]);
  __syncthreads();

  // 2. the chunk's aggregate, one thread per channel, groups in time order
  if (tid < kTile) {
    float Ac = 1.f, Hc = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const float2 p = part[q][tid];
      part[q][tid] = make_float2(Ac, Hc);
      Hc = fmaf(p.x, Hc, p.y);
      Ac *= p.x;
    }
    // 3. publish it (the last chunk of a column has no reader)
    if (published) {
      agg[(long long)block * kTile + tid] = make_float2(Ac, Hc);
      __threadfence();
    }
  }
  __syncthreads();
  if (tid == 0 && published) store_release(flags + 1 + block, 1);

  // 4. the carry-in: wait for the earlier chunks of this column, then fold
  //    their aggregates in chunk order from h = 0
  for (int k = tid; k < chunk; k += kThreads) {
    const int* f = flags + 1 + (k * columns + col);
    while (load_acquire(f) == 0) __nanosleep(64);
  }
  __syncthreads();
  if (tid < kTile) {
    float h = 0.f;
#pragma unroll 8
    for (int k = 0; k < chunk; ++k) {
      const float2 p = __ldcg(agg + (long long)(k * columns + col) * kTile +
                              tid);
      h = fmaf(p.x, h, p.y);
    }
    cin_s[tid] = h;
  }
  __syncthreads();

  // 5. rescan the held steps from the carry-in and write y
  float h[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = (tid % kCols) * V + k;
    const float2 pre = part[g][ch];
    h[k] = fmaf(pre.x, cin_s[ch], pre.y);
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (i < steps) {
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        h[k] = fmaf(Traits<T>::get(av[i], k), h[k],
                    Traits<T>::get(bv[i], k));
        Traits<T>::put(out, k, h[k]);
      }
      store_vec<T, kVecIO>(y + base + (long long)(t0 + i) * W, out, valid);
    }
  }
}

struct Geometry {
  long long tiles, columns, blocks;
};

int tile_width(int dtype) { return kCols * (dtype == kFloat32 ? 4 : 8); }

Geometry geometry(int batch, int S, int W, int dtype) {
  Geometry g;
  g.tiles = (W + tile_width(dtype) - 1) / tile_width(dtype);
  g.columns = batch * g.tiles;
  g.blocks = g.columns * ((S + (long long)kChunk - 1) / kChunk);
  return g;
}

bool bad_args(int batch, int S, int W, int dtype) {
  return batch < 0 || S < 0 || W < 0 ||
         (dtype != kFloat32 && dtype != kBFloat16) ||
         geometry(batch, S, W, dtype).blocks >= INT_MAX;
}

long long flag_bytes(const Geometry& g) {
  return ((4 * (1 + g.blocks) + 15) / 16) * 16;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* y, const Geometry& g,
                   int S, int W, int* flags, float2* agg, cudaStream_t s) {
  const bool vec_io = W % Traits<T>::kVec == 0 &&
                      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)y) % 16 == 0;
  const dim3 grid((unsigned)g.blocks);
  if (vec_io)
    rglru_scan_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(y), S, W, (int)g.tiles, (int)g.columns, flags, agg);
  else
    rglru_scan_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(y), S, W, (int)g.tiles, (int)g.columns, flags, agg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the per-call scratch the caller allocates for one launch (the
// flags, then the chunk aggregates); -1 for an unsupported shape.
long long rglru_scan_scratch_bytes(int batch, int S, int W, int dtype) {
  if (bad_args(batch, S, W, dtype)) return -1;
  const Geometry g = geometry(batch, S, W, dtype);
  return flag_bytes(g) + 8 * g.blocks * tile_width(dtype);
}

// Zeroes the scratch's flags and launches the scan on `stream`; y is
// (batch, S, W) in a's type.  Returns cudaGetLastError() after the launch
// (0 on success); an empty problem launches nothing.
int rglru_scan_launch(const void* a, const void* b, void* y, void* scratch,
                      int batch, int S, int W, int dtype, void* stream) {
  if (bad_args(batch, S, W, dtype)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0 || W == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(batch, S, W, dtype);
  int* flags = static_cast<int*>(scratch);
  float2* agg = reinterpret_cast<float2*>(static_cast<char*>(scratch) +
                                          flag_bytes(g));
  cudaError_t err = cudaMemsetAsync(flags, 0, 4 * (1 + g.blocks), s);
  if (err != cudaSuccess) return (int)err;
  err = dtype == kFloat32
            ? launch<float>(a, b, y, g, S, W, flags, agg, s)
            : launch<__nv_bfloat16>(a, b, y, g, S, W, flags, agg, s);
  return (int)err;
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
