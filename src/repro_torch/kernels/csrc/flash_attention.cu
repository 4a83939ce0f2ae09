// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body `_kernel`, wrapped by src/repro/kernels/
// ops.py::flash_attention).  For q (B, S, H, hd) and k, v (B, S, KV, hd) in
// T (float32 or bfloat16), in the model's layout, it computes per (b, h)
//
//     o = softmax(q k^T * hd^-1/2 + mask) v      (k, v of KV head h / (H/KV))
//
// with mask -1e30 where k > q (causal) or q - k >= window (window > 0) or
// k >= S, the running max, sum and output in float32, the denominator
// clamped at 1e-30 and o written in T: the TPU kernel's arithmetic.
//
// What bounds it on the card.  Operations: 4 * hd flops per unmasked
// (query, key) pair.  At the recurrentgemma-9b path shape (B 2, H 16, KV 1,
// S 4096, hd 256, window 2048, bfloat16) there are 201.4 M pairs, 206
// GFLOP: 0.208 ms at the 989 TFLOP/s bfloat16 tensor-core peak.  Bytes:
// q and o (67 MB each) and the unrepeated k and v (4.2 MB each), 142 MB,
// 0.042 ms.  So it is bound by operations, on the tensor cores.
//
// What the design does about it.  Both kernels below walk, for one block
// per (b, h, 64-query tile), the key tiles from the first one the window
// can reach to the causal diagonal, computing that range instead of
// testing every tile (the TPU kernel's whole-tile skip).  The GQA repeat
// is not materialized: the block reads KV head h / (H/KV).  A ragged
// sequence tail is masked, not padded.
//
// bfloat16 (the LM path): `attention_mma_kernel`, four warps, each owning
// 16 query rows.  QK^T and PV run on the tensor cores as mma.sync
// m16n8k16 (bfloat16 in, float32 accumulate), with the operands fetched
// from shared memory by ldmatrix (V with .trans).  The scores stay in
// registers: the float32 accumulator fragments of QK^T are the online
// softmax's input, and, rounded to bfloat16, the A operand of PV, as in
// FlashAttention-2.  The output accumulator, 16 x hd floats a warp (64
// registers a thread at hd 256), stays in registers too.  Q, K and V
// tiles are staged in shared memory as bfloat16 with rows padded by 16
// bytes (conflict-free ldmatrix), 101 KB at hd 256: two blocks per SM.
// The tiles are loaded synchronously; wgmma with TMA loads behind a
// producer warp is the later redesign.
//
// float32 (the tests and the card-vs-CPU checks): `attention_fma_kernel`
// on the CUDA cores in float32 FMAs, exact to float32 rounding, which
// tensor cores in TF32 would not be.  Each of 256 threads owns a 4 x 4
// block of the 64 x 64 score tile and 4 rows x hd/16 columns of the
// output in registers; q and k are staged transposed so a thread reads
// its 4 rows and 4 keys at one d as two 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 64;          // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// the key tiles [begin, end) a query tile starting at q0 can reach: the
// TPU kernel's relevant tiles, k_start <= q0 + kBQ - 1 (causal) and
// q0 - k_end < window
__device__ __forceinline__ void key_tiles(int q0, int S, int causal,
                                          int window, int& begin, int& end) {
  const int q_last = min(q0 + kBQ - 1, S - 1);
  end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  begin = 0;
  if (window > 0) {
    const int x = q0 - window - kBK + 2;     // least k_start allowed
    begin = x <= 0 ? 0 : (x + kBK - 1) / kBK;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal, int window) {
  return kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// ------------------------------------------------- bfloat16: tensor cores
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }  // padded row

template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 3 * kBQ * mma_ld<HD>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for a 16x16 (row) and b 16x8 (col) bfloat16 tile, float32 d
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [0, kBQ) of a (S, heads, HD) bfloat16 tensor starting at position
// p0, into a padded shared tile; rows at or past S are zeros
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long step, int p0, int S) {
  constexpr int kChunks = HD / 8;                // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks, p = p0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < S)
      val = *reinterpret_cast<const uint4*>(src + p * step + c * 8);
    *reinterpret_cast<uint4*>(dst + r * mma_ld<HD>() + c * 8) = val;
  }
}

// grid (ceil(S / kBQ), H, B), kMmaThreads threads, mma_smem_bytes<HD>()
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                     int causal, int window, float scale) {
  constexpr int LD = mma_ld<HD>();
  constexpr int NT = HD / 8;                     // output n-tiles of 8
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment coordinates
  const long long q_step = (long long)H * HD;
  const long long kv_step = (long long)KV * HD;
  const __nv_bfloat16* qb = q + ((long long)bb * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((long long)bb * S * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long long)bb * S * KV + kvh) * HD;
  __nv_bfloat16* ob = o + ((long long)bb * S * H + h) * HD;

  load_tile<HD>(Qs, qb, q_step, q0, S);
  int kt_begin, kt_end;
  key_tiles(q0, S, causal, window, kt_begin, kt_end);

  // this thread's rows: r0 = q0 + 16 warp + g and r0 + 8; scores in log2
  // units (scale folded with log2 e), so exp is one ex2
  const int r0 = q0 + warp * 16 + g;
  const float sl2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix row addresses: A (Q) and V.trans take row lane % 16 and
  // column 8 (lane / 16); B (K) takes row lane % 8 + 8 (lane / 16) and
  // column 8 (lane / 8 % 2)
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = (lane / 8 % 2) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();     // Qs is written; the last tile's readers are done
    load_tile<HD>(Ks, kb, kv_step, k0, S);
    load_tile<HD>(Vs, vb, kv_step, k0, S);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (warp * 16 + a_row) * LD + kk * 16 + a_col);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (jp * 16 + b_row) * LD + kk * 16 + b_col);
        mma_16816(sc[2 * jp], a, b[0], b[1]);
        mma_16816(sc[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // mask and online softmax: element c of n-tile j sits at row r0 + 8
    // (c / 2), key k0 + 8 j + 2 t + c % 2; a row's 64 scores are spread
    // over the 4 threads of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qpos = r0 + 8 * (c / 2), kpos = k0 + 8 * j + 2 * t + c % 2;
        const float s = sc[j][c] * sl2;
        sc[j][c] = visible(qpos, kpos, S, causal, window) ? s : kNegInf;
        mx[c / 2] = fmaxf(mx[c / 2], sc[j][c]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[j][c] = exp2f(sc[j][c] - m[c / 2]);
        sum[c / 2] += sc[j][c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the score fragments of n-tiles 2kk and 2kk+1 are the A
    // operand of keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + (kk * 16 + a_row) * LD + np * 16 + a_col);
        mma_16816(acc[2 * np], pa, b[0], b[1]);
        mma_16816(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = r0 + 8 * i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + s * q_step + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

// -------------------------------------------------- float32: CUDA cores
constexpr int kFmaThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kStride = 68;         // row stride of the transposed tiles

template <int HD>
__host__ __device__ constexpr int fma_smem_bytes() {
  return (2 * HD * kStride + kBK * HD + kBK * kStride) * 4;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// grid (ceil(S / kBQ), H, B), kFmaThreads threads, fma_smem_bytes<HD>()
template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int H, int KV, int causal, int window,
                     float scale) {
  // output columns a thread owns: NG groups of CW adjacent columns
  constexpr int CW = HD >= 64 ? 4 : 2;
  constexpr int NG = HD / (16 * CW);
  extern __shared__ float4 smem_fma[];
  float* Qt = reinterpret_cast<float*>(smem_fma);  // [HD][kStride], scaled
  float* Kt = Qt + HD * kStride;                   // [HD][kStride]
  float* Vs = Kt + HD * kStride;                   // [kBK][HD]
  float* Pt = Vs + kBK * HD;                       // [kBK][kStride]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long q_step = (long long)H * HD;   // between positions
  const long long kv_step = (long long)KV * HD;
  const float* qb = q + ((long long)bb * S * H + h) * HD;
  const float* kb = k + ((long long)bb * S * KV + kvh) * HD;
  const float* vb = v + ((long long)bb * S * KV + kvh) * HD;
  float* ob = o + ((long long)bb * S * H + h) * HD;

  for (int e = tid; e < kBQ * HD; e += kFmaThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    Qt[d * kStride + r] = s < S ? qb[s * q_step + d] * scale : 0.f;
  }
  int kt_begin, kt_end;
  key_tiles(q0, S, causal, window, kt_begin, kt_end);

  float m[4], l[4], acc[4][NG * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * CW; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();     // Qt is written; the last tile's readers are done
    for (int e = tid; e < kBK * HD; e += kFmaThreads) {
      const int r = e / HD, d = e % HD, s = k0 + r;
      const bool live = s < S;
      Kt[d * kStride + r] = live ? kb[s * kv_step + d] : 0.f;
      Vs[r * HD + d] = live ? vb[s * kv_step + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          &Qt[d * kStride + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(
          &Kt[d * kStride + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

    // mask, then the online softmax of each of the thread's 4 rows; the
    // 16 threads of a half-warp (one ty) share those rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        sc[i][j] = visible(qpos, kpos, S, causal, window) ? sc[i][j]
                                                           : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * CW; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kStride + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(
          &Pt[key * kStride + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = &Vs[key * HD + tx * CW];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        float va[CW];
        if constexpr (CW == 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + gi * 64);
          va[0] = w.x; va[1] = w.y; va[2] = w.z; va[3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(vrow + gi * 32);
          va[0] = w.x; va[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            acc[i][gi * CW + jj] = fmaf(pa[i], va[jj], acc[i][gi * CW + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj)
        ob[s * q_step + gi * 16 * CW + tx * CW + jj] =
            acc[i][gi * CW + jj] / denom;
  }
}

// --------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;   // above 48 KB only after this, once
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int batch, int S, int H, int KV, int causal, int window,
                      float scale, int dtype, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, batch);
  if (dtype == kFloat32) {
    static bool done = false;
    constexpr int bytes = fma_smem_bytes<HD>();
    const cudaError_t err = opt_in(attention_fma_kernel<HD>, bytes, done);
    if (err != cudaSuccess) return err;
    attention_fma_kernel<HD><<<grid, kFmaThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV,
        causal, window, scale);
  } else {
    static bool done = false;
    constexpr int bytes = mma_smem_bytes<HD>();
    const cudaError_t err = opt_in(attention_mma_kernel<HD>, bytes, done);
    if (err != cudaSuccess) return err;
    attention_mma_kernel<HD><<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), S, H, KV, causal, window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

// Launches the attention on `stream`; o is (batch, S, H, hd) in q's type.
// Returns the CUDA error of the launch (0 on success); an empty problem
// launches nothing.  bfloat16 pointers must be 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int S, int H, int KV, int hd,
                           int causal, int window, float scale, int dtype,
                           void* stream) {
  if (batch < 0 || batch > 65535 || S < 0 || H < 1 || H > 65535 || KV < 1 ||
      H % KV != 0 || !flash_attention_supports_head_dim(hd) || window < 0 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch_hd<32>(q, k, v, o, batch, S, H, KV, causal, window,
                                scale, dtype, s);
    case 64:
      return (int)launch_hd<64>(q, k, v, o, batch, S, H, KV, causal, window,
                                scale, dtype, s);
    case 128:
      return (int)launch_hd<128>(q, k, v, o, batch, S, H, KV, causal, window,
                                 scale, dtype, s);
    default:
      return (int)launch_hd<256>(q, k, v, o, batch, S, H, KV, causal, window,
                                 scale, dtype, s);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
