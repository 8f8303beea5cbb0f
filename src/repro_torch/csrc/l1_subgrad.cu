// Fused L1 subgradient G[w] = A[w]^T sign(A[w] x_w) for every worker w, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/l1_subgrad.py::_l1_subgrad_kernel
// (pallas_call at l1_subgrad.py:46), which walks a sequential grid over 128-row
// blocks of one A_i and accumulates A_r^T sign(A_r x) into one output block.
// Here the kernel takes a leading worker axis (the port's subgrad_all form).
//
// Bound: device memory. A is read once (n*m*d*4 bytes, ~2 flops per byte
// for the two products), far below the card's ~20 flops/byte fp32 balance.
// So the loads must overlap the compute, every SM must stream at once, and
// the blocks' partial sums must not cost a second full pass.
//
// Design: one resident wave that overlaps loads with compute, then a small
// second pass in a fixed summation order.
//   * Block (c, w) owns chunk c of worker w: C = chunk_rows(n, m) consecutive
//     rows (kernels/ref.py; a function of the shapes only), R = 16 / CPT rows
//     a step. The rows stream through a ring of kStages = 3 tiles of 16 KB in
//     shared memory, two steps ahead of the compute: TMA 1-D bulk copies
//     (cp.async.bulk, completion on an mbarrier) where the rows are 16-byte
//     aligned (A aligned, d % 4 == 0), 4-byte cp.async otherwise. Up to 4
//     blocks an SM; n = 10, m = d = 1000 runs 250 blocks, n = 100 200, each
//     in one wave.
//   * Each thread owns the columns j = tid + 256 q (q < CPT, d <= 256 CPT),
//     keeps x_w[j] and g[j] in registers, and reads its columns of a step's
//     rows from the tile once: y_r = A_r . x_w (per-thread fma chain, one
//     transposing warp reduction for the step's R rows, warps in order: one
//     barrier a step), s_r = (y_r >= 0 ? 1 : -1), then g[j] += s_r A_r[j] for
//     the step's rows in row order, from 0.
//   * The chunk's g goes to partial[w, c, :]. A second launch, one thread a
//     column, sums the chunks in chunk order: G[w] = (((0 + p_0) + p_1) + ...).
//     It is a programmatic dependent launch, scheduled while the chunk pass
//     runs, and moves n * nchunks * d * 8 bytes through L2 (4 MB at n = 10).
//     Trial builds of the two other ways were slower at n = 10: a ticket per
//     worker whose last block sums the chunks (one SM then reads every
//     chunk's row, after a fence and an atomic), and a plain second launch.
//   * d > 256 * 16: one row a step read straight from device memory, g in
//     partial[w, c, :] (each column owned by one thread), any d.
// No float atomics: two identical launches are bit-equal, and the plain
// version (ref.l1_subgrad_ref) adds in the same order, so where the signs
// agree it is bit-equal too. s * A_r[j] is exact, so fma or not, each add
// rounds once. sign(0) = +1 and sign(NaN) = -1 follow from the plain `>=`
// (paper eq. 32). Never build with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;       // ring of row tiles, 16 KB each at most
constexpr int kMaxCols = 16;     // columns a thread keeps in registers
constexpr int kMinBlocksPerSM = 4;

// ---- PTX helpers: mbarrier, TMA bulk copy, cp.async -------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- the pieces both kernels share -------------------------------------------

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// The warp sums of R = 2**K values a lane, in R - 1 + 5 - K shuffles (20 for
// R = 4 the plain way): at offsets 16, 8, ... each lane keeps the half of its
// values picked by its lane bit and adds the partner's copy of that half; then
// a plain butterfly over the rest. Lane l ends with the sum of value
// row(l) = lane bits 4..5-K; the first lane of each group writes it to out.
template <int R>
__device__ __forceinline__ void warp_sums(float (&v)[R], int lane, float* out) {
  constexpr int K = log2i(R);
  int row = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int off = 16 >> i, half = R >> (i + 1);
    const bool upper = lane & off;
    row = 2 * row + upper;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? v[j] : v[j + half];
      const float keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 >> K; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  if ((lane & ((32 >> K) - 1)) == 0) out[row] = v[0];
}

// ---- d <= 256 * kMaxCols: row tiles in shared memory, g in registers ------------

template <int CPT>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
l1_chunk_kernel(const float* __restrict__ A, const float* __restrict__ X, long long x_row_stride,
                float* __restrict__ partial, int m, int d, int C, int use_tma) {
  constexpr int R = kMaxCols / CPT;  // rows a step: a tile holds R * d <= 4096 floats
  extern __shared__ __align__(128) float tiles[];  // [kStages][R * d]
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ float red[2][kWarps][R];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int w = blockIdx.y, c = blockIdx.x;
  const int row0 = c * C, rows = min(C, m - row0);
  const int steps = (rows + R - 1) / R;
  const float* a_rows = A + ((size_t)w * m + row0) * d;
  const float* x = X + (size_t)w * x_row_stride;
  const int tile_floats = R * d;

  float xr[CPT], g[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int j = tid + q * kThreads;
    xr[q] = j < d ? __ldg(x + j) : 0.f;
    g[q] = 0.f;
  }

  // Rows [R step, R step + R) of the chunk into tile step % kStages. The
  // cp.async path commits one group per step, empty past the last, so that
  // waiting for all but the newest kStages - 1 groups waits for this step's.
  auto issue = [&](int step) {
    const int n = step < steps ? min(R, rows - step * R) * d : 0;
    float* dst = tiles + (size_t)(step % kStages) * tile_floats;
    const float* src = a_rows + (size_t)step * R * d;
    if (use_tma) {
      if (tid == 0 && n > 0) {
        mbar_expect_tx(&bars[step % kStages], (uint32_t)n * 4u);
        bulk_load(dst, src, (uint32_t)n * 4u, &bars[step % kStages]);
      }
    } else {
      for (int i = tid; i < n; i += kThreads) cp_async4(dst + i, src + i);
      cp_async_commit();
    }
  };

  if (use_tma && tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);
  asm volatile("griddepcontrol.launch_dependents;");  // the sum pass may be scheduled now

  for (int step = 0; step < steps; ++step) {
    const int st = step % kStages;
    if (use_tma) {
      mbar_wait(&bars[st], (uint32_t)(step / kStages) & 1u);
    } else {
      cp_async_wait<kStages - 1>();
      __syncthreads();  // every thread's copies of the tile have landed
    }
    const float* tile = tiles + (size_t)st * tile_floats;
    const int nr = min(R, rows - step * R);
    float a[R][CPT], dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dot[r] = 0.f;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int j = tid + q * kThreads;
        a[r][q] = (r < nr && j < d) ? tile[r * d + j] : 0.f;
        dot[r] = fmaf(a[r][q], xr[q], dot[r]);
      }
    }
    warp_sums<R>(dot, lane, red[step & 1][warp]);
    __syncthreads();  // the partial dots are in; every thread is done with the tile
    issue(step + kStages);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) y += red[step & 1][k][r];
      const float s = y >= 0.f ? 1.f : -1.f;
#pragma unroll
      for (int q = 0; q < CPT; ++q) g[q] = fmaf(s, a[r][q], g[q]);
    }
  }

  float* prow = partial + ((size_t)w * gridDim.x + c) * d;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int j = tid + q * kThreads;
    if (j < d) prow[j] = g[q];
  }
}

// ---- d > 256 * kMaxCols: rows from device memory, g in the partial row -------------

__global__ void __launch_bounds__(kThreads)
l1_chunk_wide_kernel(const float* __restrict__ A, const float* __restrict__ X, long long x_row_stride,
                     float* __restrict__ partial, int m, int d, int C) {
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int w = blockIdx.y, c = blockIdx.x;
  const int row0 = c * C, rows = min(C, m - row0);
  const float* x = X + (size_t)w * x_row_stride;
  float* prow = partial + ((size_t)w * gridDim.x + c) * d;  // column j: thread j % 256 only
  asm volatile("griddepcontrol.launch_dependents;");  // the sum pass may be scheduled now
  for (int j = tid; j < d; j += kThreads) prow[j] = 0.f;
  for (int r = 0; r < rows; ++r) {
    const float* a = A + ((size_t)w * m + row0 + r) * d;
    float dot[1] = {0.f};
    for (int j = tid; j < d; j += kThreads) dot[0] = fmaf(__ldg(a + j), __ldg(x + j), dot[0]);
    warp_sums<1>(dot, lane, &red[r & 1][warp]);
    __syncthreads();
    float y = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) y += red[r & 1][k];
    const float s = y >= 0.f ? 1.f : -1.f;
    for (int j = tid; j < d; j += kThreads) prow[j] = fmaf(s, __ldg(a + j), prow[j]);
  }
}

// ---- the second pass: G[w, j] = (((0 + p_0) + p_1) + ...) over the chunks in order -----

__global__ void __launch_bounds__(kThreads)
l1_sum_kernel(const float* __restrict__ partial, float* __restrict__ G, int nchunks, int d) {
  constexpr int U = 16;  // loads in flight a thread
  // Launched as a programmatic dependent of the chunk pass: it may start
  // early, and waits here until that grid has finished and its writes are
  // visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int w = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const float* p = partial + (size_t)w * nchunks * d + j;
  float acc = 0.f;
  int c = 0;
  for (; c + U <= nchunks; c += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(p + (size_t)(c + u) * d);
#pragma unroll
    for (int u = 0; u < U; ++u) acc += v[u];
  }
  for (; c < nchunks; ++c) acc += __ldg(p + (size_t)c * d);
  G[(size_t)w * d + j] = acc;
}

template <int CPT>
int launch_chunks(const float* A, const float* X, long long x_row_stride, float* partial, dim3 grid,
                  int m, int d, int C, cudaStream_t s) {
  // Set at every launch, even below 48 KB: a launch of this kernel with
  // 48000 B of dynamic shared memory failed (invalid value) without it.
  const size_t smem = (size_t)kStages * (kMaxCols / CPT) * d * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(l1_chunk_kernel<CPT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int use_tma = reinterpret_cast<uintptr_t>(A) % 16 == 0 && d % 4 == 0;
  l1_chunk_kernel<CPT><<<grid, kThreads, smem, s>>>(A, X, x_row_stride, partial, m, d, C, use_tma);
  return (int)cudaGetLastError();
}

}  // namespace

// A: [n, m, d] f32 contiguous; X: row w at X + w * x_row_stride (0 = one point
// for all workers), unit inner stride; C: rows a chunk (ref.chunk_rows);
// partial: [n, ceil(m/C), d] scratch; G: [n, d]. Launches the chunk pass and
// the sum pass on `stream`, does not synchronise, returns cudaError_t.
extern "C" int l1_subgrad_f32(const float* A, const float* X, long long x_row_stride,
                              float* partial, float* G, int n, int m, int d, int C, void* stream) {
  if (n <= 0 || n > 65535 || m <= 0 || d <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + C - 1) / C, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (d <= 256) e = launch_chunks<1>(A, X, x_row_stride, partial, grid, m, d, C, s);
  else if (d <= 512) e = launch_chunks<2>(A, X, x_row_stride, partial, grid, m, d, C, s);
  else if (d <= 1024) e = launch_chunks<4>(A, X, x_row_stride, partial, grid, m, d, C, s);
  else if (d <= 2048) e = launch_chunks<8>(A, X, x_row_stride, partial, grid, m, d, C, s);
  else if (d <= 256 * kMaxCols) e = launch_chunks<16>(A, X, x_row_stride, partial, grid, m, d, C, s);
  else {
    l1_chunk_wide_kernel<<<grid, kThreads, 0, s>>>(A, X, x_row_stride, partial, m, d, C);
    e = (int)cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  // The sum pass may be scheduled while the chunk pass runs (programmatic
  // dependent launch); griddepcontrol.wait in it holds it until the end.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + kThreads - 1) / kThreads, n);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, l1_sum_kernel, (const float*)partial, G, (int)grid.x, d);
}
