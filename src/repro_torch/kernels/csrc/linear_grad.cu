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
// What the design does about it: one kernel, one persistent block an SM,
// each streaming a contiguous range of rows.  A tile of rows of X is one
// contiguous span of memory, so one thread moves it (and the tile's span
// of y) into a ring of kStages shared-memory stages with 1-D bulk copies
// (`cp.async.bulk`, completing on an `mbarrier`), kStages - 1 tiles ahead
// of the threads: ~100 KB in flight an SM, whatever d is, with no
// registers or issue slots spent on the copies.  A row starts at any
// 4-byte boundary (d = 18: 72-byte rows; row views of a window), so each
// copy covers the 16-byte granules that hold the span, and the threads
// skip the few bytes before it.
//
// From the tile, a group of `lanes` lanes takes a row (at most kMaxCols
// columns a lane: two lanes at d = 18, sixteen at 300, four warps at 2048):
// each lane reads its columns of the row from shared memory once into
// registers, where its columns of w already are, forms its share of
// x_i . w, the group's xor butterfly (and, across a group's warps, a named
// barrier) gives every lane the dot product, every lane evaluates l and
// l' * y_i, and adds l' * y_i * x_ij into its own columns' gradient
// partials from the same registers.  So X is read from device memory once
// and from shared memory once, and a tile takes one barrier: reading a
// tile three times (X and w for the forward, X again for the transposed
// product) would take shared-memory bandwidth that the copies' writes need
// too.  The groups' partials are summed at the block's end.
//
// The TPU kernel carried one resident gradient tile across a sequential
// grid; Hopper's blocks run in parallel and in no order.  So each block
// writes one (d + 1) partial (gradient and loss) to a per-call scratch,
// and the sum across blocks is a fixed-order tree of two levels, each
// summer elected by an atomic ticket (acquire and release): the last block
// of each group of kGroupBlocks sums its group's partials in block order,
// and the last of those sums the groups' in group order.  One block alone
// would read every partial (G * (d + 1) floats, 1 MB at d = 2048) from L2
// on the kernel's tail; the tree reads at most kGroupBlocks rows a level.
// No float atomics: the result is bit-reproducible from run to run on one
// card.
//
// Limits: 1 <= d <= kMaxD, X row-major and contiguous.  Ragged n is masked
// in the kernel (the TPU wrapper padded to block_m and subtracted the
// padding's loss instead).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kStages = 4;
constexpr int kTileBytes = 32 * 1024;    // X bytes a stage holds, at most
constexpr int kMaxRows = 512;            // rows a tile, at most
constexpr int kMaxD = 2048;
constexpr int kGroupBlocks = 12;         // blocks a group of the final sum
constexpr int kMaxCols = 24;             // columns a lane holds, at most
// a stage: the tile of X and the tile of y, each with a granule either side
constexpr int kXStage = kTileBytes + 32;
constexpr int kYStage = 4 * kMaxRows + 32;
constexpr int kStageBytes = kXStage + kYStage;
constexpr int kSmemBytes = kStages * kStageBytes + 4 * kMaxD + 8 * kStages;
// the dynamic and the static shared memory of a block
static_assert(kSmemBytes + 4 * (kThreads / 32) + 16 <= 232448,
              "shared memory");
// the warps' partials of the gradient reuse the stages
static_assert(4 * (kThreads / 32) * kMaxD <= kStages * kStageBytes,
              "shared memory for the warps' partials");
static_assert(kStageBytes % 16 == 0 && kXStage % 16 == 0, "alignment");

enum Loss { kSquaredHinge = 0, kLogistic = 1 };

int tile_rows(int d) {
  const int r = kTileBytes / (4 * d);
  return r < kMaxRows ? r : kMaxRows;
}

// lanes that share one row: a power of two with at most kMaxCols columns a
// lane (so a row takes several warps above d = 768: 128 lanes at 2048), and,
// below 32, at least gcd(d, 32), so that the rows a warp reads at once
// start on different shared-memory banks (d = 18: 2 lanes, 16 rows a warp,
// no bank read twice)
int row_lanes(int d) {
  int g = 1;
  while (g < kThreads && ((d + g - 1) / g > kMaxCols ||
                          (g < 32 && d % (2 * g) == 0)))
    g *= 2;
  return g;
}

// floats of one block's partial: the gradient and the loss, padded to 16
// bytes so the last block reads them as float4
__host__ __device__ __forceinline__ long long partial_stride(int d) {
  return ((d + 1 + 3) / 4) * 4;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// bytes [lo, hi) of global memory, 16-byte aligned, into shared memory at
// dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, uintptr_t lo,
                                          uintptr_t hi, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(lo), "r"((uint32_t)(hi - lo)), "r"(bar) : "memory");
}

// One thread's ticket, after a barrier of its block: the release orders
// the block's writes before it (the barrier makes them the thread's), the
// acquire orders the earlier ticket holders' writes before the block's
// reads that follow the next barrier.
__device__ __forceinline__ unsigned take_ticket(unsigned* p) {
  unsigned v;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// dst[j] = sum over r < rows of src[r * stride + j], r in order, for
// j < count; the block's threads take 16-byte column quads
__device__ __forceinline__ void sum_rows(const float* src, int rows,
                                         long long stride, float* dst,
                                         int count) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int quads = (int)(stride / 4);
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < rows; r0 += kGroupBlocks) {
      // all of a group's loads in flight before the first add
      float4 v[kGroupBlocks];
#pragma unroll
      for (int r = 0; r < kGroupBlocks; ++r)
        if (r0 + r < rows) v[r] = __ldcg(s4 + (r0 + r) * stride / 4 + q);
#pragma unroll
      for (int r = 0; r < kGroupBlocks; ++r) {
        if (r0 + r < rows) {
          acc.x += v[r].x;
          acc.y += v[r].y;
          acc.z += v[r].z;
          acc.w += v[r].w;
        }
      }
    }
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < count) dst[4 * q + e] = v[e];
  }
}

struct Tile {
  long long row0;
  int rows;
};

// Block b streams rows [b*n/G, (b+1)*n/G) in tiles of `rows` rows.
__device__ __forceinline__ Tile tile_of(long long first, long long last,
                                        int rows, int k) {
  Tile t;
  t.row0 = first + (long long)k * rows;
  t.rows = (int)min((long long)rows, last - t.row0);
  return t;
}

// One thread: issue tile k's copies (X rows, then y) into stage s.
__device__ __forceinline__ void issue(const float* X, const float* y,
                                      char* stage, uint32_t bar, Tile t,
                                      int d) {
  const uintptr_t x0 = (uintptr_t)(X + t.row0 * d);
  const uintptr_t x1 = (uintptr_t)(X + (t.row0 + t.rows) * d);
  const uintptr_t y0 = (uintptr_t)(y + t.row0);
  const uintptr_t y1 = (uintptr_t)(y + t.row0 + t.rows);
  const uintptr_t xl = x0 & ~(uintptr_t)15, xh = (x1 + 15) & ~(uintptr_t)15;
  const uintptr_t yl = y0 & ~(uintptr_t)15, yh = (y1 + 15) & ~(uintptr_t)15;
  // the generic-proxy reads of this stage's last tile come before the
  // async-proxy writes of the next
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"((uint32_t)((xh - xl) + (yh - yl)))
               : "memory");
  bulk_load(smem_u32(stage), xl, xh, bar);
  bulk_load(smem_u32(stage + kXStage), yl, yh, bar);
}

// C: columns a lane holds, at most (ceil(d / lanes) <= C)
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
lvg_kernel(const float* __restrict__ X, const float* __restrict__ y,
           const float* __restrict__ w, float* __restrict__ partial,
           float* __restrict__ out, long long n, int d, int loss, int rows,
           int lanes) {
  extern __shared__ __align__(16) char smem[];
  float* w_s = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_s + kMaxD);
  __shared__ float red[kThreads / 32];
  __shared__ float dots[2][kThreads / 32];  // a round's warps' dots, by parity
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const long long first = n * blockIdx.x / G;
  const long long last = n * (blockIdx.x + 1) / G;
  const int tiles = (int)((last - first + rows - 1) / rows);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(bars + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(kStages, tiles); ++k)
      issue(X, y, smem + k * kStageBytes, smem_u32(bars + k),
            tile_of(first, last, rows, k), d);
  }
  for (int j = tid; j < d; j += kThreads) w_s[j] = w[j];
  __syncthreads();

  // a group of `lanes` lanes a row; lane l of a group holds the columns
  // l, l + lanes, ... (at most C of them) of its row, of w and of its
  // gradient partial
  const int lane_g = tid & (lanes - 1);
  const int group = tid / lanes;
  const int groups = kThreads / lanes;
  const int warp_group0 = (tid & ~31) / lanes;
  const int group_warps = lanes / 32;        // > 1: a row takes several warps
  float wr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane_g + c * lanes;
    wr[c] = j < d ? w_s[j] : 0.f;
    acc[c] = 0.f;
  }
  float lsum = 0.f;

  for (int k = 0; k < tiles; ++k) {
    const int s = k % kStages;
    const Tile t = tile_of(first, last, rows, k);
    char* stage = smem + s * kStageBytes;
    const float* xs = reinterpret_cast<const float*>(
        stage + ((uintptr_t)(X + t.row0 * d) & 15));
    const float* ys = reinterpret_cast<const float*>(
        stage + kXStage + ((uintptr_t)(y + t.row0) & 15));
    mbar_wait(smem_u32(bars + s), (k / kStages) & 1);

    // rounds as many as the warp's first group needs (the same for all
    // warps of a group), so that every lane of a warp takes part in each
    // shuffle and every warp of a group in each of its barriers
    for (int i0 = 0, round = 0; i0 + warp_group0 < t.rows;
         i0 += groups, ++round) {
      const int i = i0 + group;
      const bool live = i < t.rows;
      const float* xr = xs + i * d;
      float xv[C];
      float p0 = 0.f, p1 = 0.f;       // two chains: even and odd columns
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane_g + c * lanes;
        xv[c] = live && j < d ? xr[j] : 0.f;
        if (c & 1)
          p1 = fmaf(xv[c], wr[c], p1);
        else
          p0 = fmaf(xv[c], wr[c], p0);
      }
      // xor butterfly within the warp's part of the group, then the
      // group's warps in order: every lane ends with the full dot
      float dot = p0 + p1;
      for (int off = min(lanes, 32) >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (group_warps > 1) {
        float* part = dots[round & 1] + group * group_warps;
        if ((tid & 31) == 0) part[lane_g >> 5] = dot;
        asm volatile("bar.sync %0, %1;" :: "r"(1 + group), "r"(lanes)
                     : "memory");
        dot = 0.f;
        for (int q = 0; q < group_warps; ++q) dot += part[q];
      }
      if (live) {
        const float yi = ys[i];
        float li, dm;
        loss_and_slope(yi * dot, loss, &li, &dm);
        if (lane_g == 0) lsum += li;
        const float r = dm * yi;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(r, xv[c], acc[c]);
      }
    }
    __syncthreads();                 // every thread is done with stage s
    if (tid == 0 && k + kStages < tiles)
      issue(X, y, stage, smem_u32(bars + s),
            tile_of(first, last, rows, k + kStages), d);
  }

  // the block's partial, every sum in a fixed order: the groups within a
  // warp by a xor butterfly, then in order the slots (a warp, or a group
  // of several warps), through the stages, all consumed; the loss by a xor
  // butterfly in each warp, then the warps in order
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  const int slot_lanes = max(lanes, 32);
  const int slots = kThreads / slot_lanes;
  float* red_s = reinterpret_cast<float*>(smem);   // (slots, d)
  if ((tid & 31) < lanes) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane_g + c * lanes;
      if (j < d) red_s[(tid / slot_lanes) * d + j] = acc[c];
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  if ((tid & 31) == 0) red[warp] = lsum;
  __syncthreads();
  float* mine = partial + blockIdx.x * partial_stride(d);
  for (int j = tid; j < d; j += kThreads) {
    float g = 0.f;
    for (int sl = 0; sl < slots; ++sl) g += red_s[sl * d + j];
    mine[j] = g;
  }
  if (tid == 0) {
    float L = 0.f;
    for (int wp = 0; wp < kThreads / 32; ++wp) L += red[wp];
    mine[d] = L;
  }
  __syncthreads();

  // the two-level sum: the last block of each group of kGroupBlocks sums
  // its group's partials in block order; the last of those sums the groups
  // in group order into out
  const int groups_g = (G + kGroupBlocks - 1) / kGroupBlocks;
  const int grp = blockIdx.x / kGroupBlocks;
  const int b0 = grp * kGroupBlocks;
  const int nb = min(G - b0, kGroupBlocks);
  const long long stride = partial_stride(d);
  float* group_partial = partial + G * stride;
  unsigned* tickets = reinterpret_cast<unsigned*>(group_partial +
                                                  groups_g * stride);
  if (tid == 0) last_s = take_ticket(tickets + grp) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last_s) return;
  sum_rows(partial + b0 * stride, nb, stride, group_partial + grp * stride,
           (int)stride);
  __syncthreads();
  if (tid == 0)
    last_s = take_ticket(tickets + groups_g) == (unsigned)(groups_g - 1);
  __syncthreads();
  if (!last_s) return;
  sum_rows(group_partial, groups_g, stride, out, d + 1);
}

int groups(int grid) { return (grid + kGroupBlocks - 1) / kGroupBlocks; }

struct Args {
  const float *X, *y, *w;
  float *partial, *out;
  long long n;
  int d, loss, grid;
  cudaStream_t stream;
};

template <int C>
cudaError_t launch_kernel(const Args& a) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        lvg_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  lvg_kernel<C><<<a.grid, kThreads, kSmemBytes, a.stream>>>(
      a.X, a.y, a.w, a.partial, a.out, a.n, a.d, a.loss, tile_rows(a.d),
      row_lanes(a.d));
  return cudaGetLastError();
}

bool bad_args(long long n, int d, int grid) {
  return d < 1 || d > kMaxD || n < 0 || grid < 1;
}

}  // namespace

extern "C" {

int lvg_max_d() { return kMaxD; }

// Blocks of the launch: at most one an SM, and no more than there are
// tiles; -1 for an unsupported shape.
int lvg_grid(long long n, int d, int num_sms) {
  if (bad_args(n, d, 1) || num_sms < 1) return -1;
  const long long tiles = (n + tile_rows(d) - 1) / tile_rows(d);
  return (int)(tiles < 1 ? 1 : tiles < num_sms ? tiles : num_sms);
}

// Bytes of the per-call scratch the caller allocates for one launch of
// `grid` blocks: the blocks' partials, the groups' partials, then the
// tickets (one a group, one for the groups).
long long lvg_scratch_bytes(int d, int grid) {
  if (bad_args(0, d, grid)) return -1;
  return 4 * (partial_stride(d) * (grid + groups(grid)) + groups(grid) + 1);
}

// Zeroes the scratch's tickets and launches the kernel on `stream`; out is
// (d + 1) float32: g then L.  Returns cudaGetLastError() after the launch
// (0 on success).
int lvg_launch(const void* X, const void* y, const void* w, void* scratch,
               void* out, long long n, int d, int loss, int grid,
               void* stream) {
  if (bad_args(n, d, grid) || (loss != kSquaredHinge && loss != kLogistic))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      partial + partial_stride(d) * (grid + groups(grid)), 0,
      sizeof(unsigned) * (groups(grid) + 1), s);
  if (err != cudaSuccess) return (int)err;
  const Args a{static_cast<const float*>(X), static_cast<const float*>(y),
               static_cast<const float*>(w), partial,
               static_cast<float*>(out), n, d, loss, grid, s};
  const int cols = (d + row_lanes(d) - 1) / row_lanes(d);
  static_assert(kMaxCols == 24, "the buckets below");
  if (cols <= 4) return (int)launch_kernel<4>(a);
  if (cols <= 8) return (int)launch_kernel<8>(a);
  if (cols <= 12) return (int)launch_kernel<12>(a);
  if (cols <= 16) return (int)launch_kernel<16>(a);
  if (cols <= 20) return (int)launch_kernel<20>(a);
  return (int)launch_kernel<24>(a);
}

const char* lvg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
