// Fused L1 subgradient G[w] = A[w]^T sign(A[w] x_w) for every worker w, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/l1_subgrad.py::_l1_subgrad_kernel
// (pallas_call at l1_subgrad.py:46), which walks a sequential grid over 128-row
// blocks of one A_i and accumulates A_r^T sign(A_r x) into one output block.
// Here the kernel takes a leading worker axis (the port's subgrad_all form).
//
// Bound: device memory. A is read once (n*m*d*4 bytes, ~2 flops per byte
// for the two products), far below the card's ~20 flops/byte fp32 balance.
//
// Design: Hopper blocks run in no order, so the TPU's carried sum becomes two
// passes with a fixed summation order (no float atomics: a run is
// bit-reproducible).
//   pass 1, block (row block rb, worker w): stage R rows of A[w] in shared
//     memory (one read of A), y_r = A_r . x_w (one warp per row, shuffle tree),
//     s_r = (y_r >= 0 ? 1 : -1), partial[w, rb, :] = sum_r s_r A_r (r in order);
//   pass 2: G[w, j] = sum_rb partial[w, rb, j] in rb order.
// sign(0) = +1 and sign(NaN) = -1 follow from the plain `>=` compare (paper
// eq. 32; the reference's jnp.where(y >= 0, 1, -1)). Never build with
// --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
l1_partial_kernel(const float* __restrict__ A, const float* __restrict__ X,
                  long long x_row_stride, float* __restrict__ partial,
                  int m, int d, int R) {
  extern __shared__ float smem[];  // [R*d] tile, then [R] signs
  float* tile = smem;
  float* sgn = smem + (size_t)R * d;
  const int w = blockIdx.y;
  const int rb = blockIdx.x;
  const int row0 = rb * R;
  const int rows = min(R, m - row0);
  const float* a_rows = A + ((size_t)w * m + row0) * d;  // rows*d contiguous floats
  const float* x = X + (size_t)w * x_row_stride;

  // Stage the tile: kUnroll independent loads in flight per thread.
  const int total = rows * d;
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < total; i += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(a_rows + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) tile[i + u * kThreads] = v[u];
  }
  for (; i < total; i += kThreads) tile[i] = __ldg(a_rows + i);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const float* a = tile + (size_t)r * d;
    float acc = 0.f;
    for (int j = lane; j < d; j += 32) acc = fmaf(a[j], __ldg(x + j), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sgn[r] = (acc >= 0.f) ? 1.f : -1.f;
  }
  __syncthreads();

  float* out = partial + ((size_t)w * gridDim.x + rb) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float g = 0.f;
    for (int r = 0; r < rows; ++r) g += sgn[r] * tile[(size_t)r * d + j];  // s = +-1: exact product
    out[j] = g;
  }
}

__global__ void __launch_bounds__(kThreads)
l1_reduce_kernel(const float* __restrict__ partial, float* __restrict__ G, int nrb, int d) {
  const int w = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const float* p = partial + (size_t)w * nrb * d + j;
  float g = 0.f;
  for (int rb = 0; rb < nrb; ++rb) g += __ldg(p + (size_t)rb * d);
  G[(size_t)w * d + j] = g;
}

}  // namespace

// A: [n, m, d] f32 contiguous; X: row w at X + w * x_row_stride (0 = one point
// for all workers), unit inner stride; partial: [n, ceil(m/R), d] scratch;
// G: [n, d]. Launches on `stream`, does not synchronise, returns cudaError_t.
extern "C" int l1_subgrad_f32(const float* A, const float* X, long long x_row_stride,
                              float* partial, float* G, int n, int m, int d, int R,
                              void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const int nrb = (m + R - 1) / R;
  const size_t smem = ((size_t)R * d + R) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(l1_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  l1_partial_kernel<<<dim3(nrb, n), kThreads, smem, s>>>(A, X, x_row_stride, partial, m, d, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  l1_reduce_kernel<<<dim3((d + kThreads - 1) / kThreads, n), kThreads, 0, s>>>(partial, G, nrb, d);
  return (int)cudaGetLastError();
}
