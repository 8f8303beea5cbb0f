// RotK apply (the cyclic-partition PermK update) on Hopper, in fp32, fp16
// and bf16, for one replica (rotk_apply) or for the R replicas of a leaf in
// one launch (rotk_apply_rows).
//
// Replaces the Pallas TPU kernel repro/kernels/permk.py::_rotk_apply_kernel
// (pallas_call at permk.py:39):
//   out[j] = w[j] + (j mod n == (worker + r) mod n ? delta[j] * n : +0.0)
// with r a device int32 scalar, read here on the card (no host sync). The
// rows entry is the reference downlink's vmapped per-worker update
// (repro/train/downlink.py, q_one over the workers): row i of w and out is
// worker i's replica, and one launch reads delta once and each replica once.
//
// Exactness, as the reference computes it on XLA:
//   * (worker + r) mod n is a floor mod (r may be negative) of the int32 sum
//     (it wraps): C's % is truncated, so a negative remainder is moved up by n;
//   * delta * n is rounded, then added: __fmul_rn / __fadd_rn keep nvcc from
//     contracting the two into an FMA (which it does by default for a*b + c);
//     no packed half2 arithmetic, which would round once or treat NaNs apart;
//   * a coordinate not kept is w + (+0.0), which turns -0.0 into +0.0;
//   * fp16 / bf16: XLA computes each 16-bit operation in fp32 and rounds its
//     result, so the product is rounded to T before the sum:
//     q = T(f32(delta) * n), out = T(f32(w) + f32(q)). The widening is exact
//     (__half2float / bf16 bits << 16, as torch widens on the card); the
//     narrowing is on bit patterns (float_bits.cuh: nearest even, NaNs as
//     numpy / ml_dtypes make them), so that it equals ref.rotk_apply_ref's.
//
// Bound: bytes. One row reads w and delta and writes out: 12 bytes a value in
// fp32, 6 in fp16 / bf16; R rows read delta once, 2R + 1 values a column.
// Design:
//   * 16-byte vectors (4 fp32 or 8 fp16 / bf16 values) of w, delta and out,
//     kUnroll of them a thread per pass, loads streaming (ld.global.cs);
//     a grid of SMs x resident blocks strides over the vectors;
//   * a leaf with less than a block of vectors an SM runs one value a thread
//     (as many threads as values, up to the resident grid): there the
//     card's parallelism, not the access width, sets the time; one row
//     reads delta only where it is kept;
//   * vectors need w, delta and out at one offset mod 16 bytes (and row
//     strides of whole vectors): the columns before the first aligned one
//     (the head) and after the last whole vector (the tail), at most 14, are
//     done one by one with the same arithmetic by the first threads of block
//     0; a layout with no common alignment runs one value a thread;
//   * index arithmetic: r is read once a thread; each row's kept residue once
//     a pass; a vector's base residue j mod n is carried from vector to
//     vector by adds (three % a thread in all), and the vector's kept
//     lanes are a bit mask (bits 0, n, 2n, ... shifted to the first kept lane);
//   * rows: a pass loads its delta vectors once, rounds delta * n to T once
//     (kept packed, 16 bytes a vector, to spare registers), and walks the R
//     rows, loading and storing each row's vectors.
// Block map (rotk_apply_rows_map): the R rows hold one rank's block of a leaf
// split over a mesh axis, and block element t is leaf coordinate
//   j = offset + (t / chunk) * stride + t % chunk
// (a column block of an [.., a, b] leaf: chunk = b/M, stride = b, offset = m b/M;
// a row block of [reps, a, b]: chunk = (a/M) b, stride = a b, offset = m (a/M) b).
// The kept rule reads j, so the residue cannot be carried across a run's end:
// each vector computes its own from its column (one 64-bit division), a vector
// inside one run takes the lane mask as above, and a vector across a run's end
// (runs need not start on a 16-byte boundary) tests its lanes one by one. The
// contiguous map (chunk = stride = s, offset = 0) is the plain launch above.
// A second level (inner > 0) takes a block cut on two dims of a leaf (a rank's
// block under "data" and "model" at once, e.g. w_in [E, D, F] with D over
// "data" and F over "model"): the runs come in groups of `inner`, `stride`
// apart inside a group and the groups `ostride` apart,
//   j = offset + (u / inner) * ostride + (u % inner) * stride + t % chunk,  u = t / chunk;
// the runs' ends are the same, so only the coordinate differs. inner = 0 is the
// one-level map above, on the same code with the same bits.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_bits.cuh"

namespace {

constexpr int kThreads = 512;     // a block of the vector path
constexpr int kOneThreads = 256;  // a block of the one-value path
constexpr int kUnroll = 2;        // vectors a thread per pass

// Each type's values as their bit patterns U, widened to and narrowed from fp32.
struct F32 {
  using U = uint32_t;
  static __device__ __forceinline__ float widen(uint32_t v) { return __uint_as_float(v); }
  static __device__ __forceinline__ uint32_t narrow(float v) { return __float_as_uint(v); }
};

struct F16 {
  using U = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t v) { return __half2float(__ushort_as_half(v)); }
  static __device__ __forceinline__ uint16_t narrow(float v) {
    return (uint16_t)f32_to_f16_bits(__float_as_uint(v));
  }
};

struct BF16 {
  using U = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
  static __device__ __forceinline__ uint16_t narrow(float v) {
    return (uint16_t)f32_to_bf16_bits(__float_as_uint(v));
  }
};

// q = T(delta * n) widened back (exact for fp32: narrow and widen are bit copies)
template <typename V>
__device__ __forceinline__ float scaled(typename V::U d, float nf) {
  return V::widen(V::narrow(__fmul_rn(V::widen(d), nf)));
}

template <typename V>
__device__ __forceinline__ typename V::U apply(typename V::U w, float q) {
  return V::narrow(__fadd_rn(V::widen(w), q));
}

// lane k of a 16-byte word of U values (k is a constant once the loops are unrolled)
template <typename U>
__device__ __forceinline__ U lane_of(const uint4& u, int k) {
  constexpr int per = 4 / sizeof(U);  // values a 32-bit word
  const int q = k / per;
  const uint32_t x = q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w;
  return (U)(x >> (32 / per) * (k % per));
}

template <typename U, int VEC>
__device__ __forceinline__ uint4 pack_vec(const U (&v)[VEC]) {
  uint32_t x[4] = {0u, 0u, 0u, 0u};
  constexpr int per = 4 / sizeof(U);
#pragma unroll
  for (int k = 0; k < VEC; ++k) x[k / per] |= (uint32_t)v[k] << (32 / per) * (k % per);
  return make_uint4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ int floor_mod(int t, int n) {
  const int m = t % n;
  return m < 0 ? m + n : m;
}

// the kept residue of row i: (worker0 + i + r) mod n, the sum wrapping in int32 as XLA's add
__device__ __forceinline__ int kept_residue(int worker0, int i, int r, int n) {
  return floor_mod((int)((unsigned)worker0 + (unsigned)i + (unsigned)r), n);
}

// a mod n for a >= 0: a 32-bit remainder where a fits, which is far cheaper than a 64-bit one
__device__ __forceinline__ unsigned mod64(long long a, int n) {
  return a < (1ll << 32) ? (unsigned)a % (unsigned)n : (unsigned)(a % n);
}

// a + b mod n for a, b in [0, n)
__device__ __forceinline__ unsigned add_mod(unsigned a, unsigned b, unsigned n) {
  const unsigned s = a + b;
  return s >= n ? s - n : s;
}

// Block element t -> leaf coordinate offset + (t / chunk) * stride + t % chunk,
// or with a second level (inner > 0) the runs u = t / chunk in groups of inner:
// offset + (u / inner) * ostride + (u % inner) * stride + t % chunk.
struct BlockMap {
  long long chunk, stride, offset, inner, ostride;
};

__device__ __forceinline__ long long leaf_coord(long long t, const BlockMap& bm) {
  const long long u = t / bm.chunk;
  const long long run = bm.inner ? (u / bm.inner) * bm.ostride + (u % bm.inner) * bm.stride : u * bm.stride;
  return bm.offset + run + t % bm.chunk;
}

// the leaf coordinate of block column t, mod n (Map false: t itself)
template <bool Map>
__device__ __forceinline__ unsigned leaf_mod(long long t, const BlockMap& bm, int n) {
  if constexpr (Map) return mod64(leaf_coord(t, bm), n);
  else return mod64(t, n);
}

// Column j of rows i < R: out = w + Q_{worker0 + i}(delta), one value at a time.
template <typename V, bool Map>
__device__ __forceinline__ void rotk_column(const typename V::U* __restrict__ w, long long w_stride,
                                            const typename V::U* __restrict__ delta,
                                            typename V::U* __restrict__ out, long long out_stride,
                                            long long j, int rows, int n, int worker0, int r,
                                            const BlockMap& bm) {
  const int jm = (int)leaf_mod<Map>(j, bm, n);
  const float p = scaled<V>(delta[j], (float)n);
  for (int i = 0; i < rows; ++i) {
    const float q = jm == kept_residue(worker0, i, r, n) ? p : 0.0f;
    out[i * out_stride + j] = apply<V>(w[i * w_stride + j], q);
  }
}

// Rows i < R of out = w + Q_{worker0 + i}(delta) over columns [0, s), one value
// a thread: short leaves, and layouts with no common 16-byte alignment. Row i
// of w starts at w + i * w_stride (w_stride may be 0), of out at out + i * out_stride.
template <typename V, bool Map>
__global__ void __launch_bounds__(kOneThreads)
rotk_one_kernel(const typename V::U* __restrict__ w, long long w_stride,
                const typename V::U* __restrict__ delta, const int* __restrict__ rotation,
                typename V::U* __restrict__ out, long long out_stride, long long s, int rows, int n,
                int worker0, BlockMap bm) {
  const int r = __ldg(rotation);
  const int keep0 = kept_residue(worker0, 0, r, n);
  for (long long j = (long long)blockIdx.x * kOneThreads + threadIdx.x; j < s;
       j += (long long)gridDim.x * kOneThreads) {
    if (rows == 1)  // one replica: delta is read where it is kept only
      out[j] = apply<V>(w[j], (int)leaf_mod<Map>(j, bm, n) == keep0 ? scaled<V>(delta[j], (float)n) : 0.0f);
    else
      rotk_column<V, Map>(w, w_stride, delta, out, out_stride, j, rows, n, worker0, r, bm);
  }
}

// The same in 16-byte vectors of VEC values from column `head` on, where w,
// delta and out share an alignment; the head and the columns after the last
// whole vector go one by one.
template <typename V, bool Map>
__global__ void __launch_bounds__(kThreads)
rotk_vec_kernel(const typename V::U* __restrict__ w, long long w_stride,
                const typename V::U* __restrict__ delta, const int* __restrict__ rotation,
                typename V::U* __restrict__ out, long long out_stride, long long s, int rows,
                int n, int worker0, int head, BlockMap bm) {
  using U = typename V::U;
  constexpr int VEC = 16 / sizeof(U);
  const int r = __ldg(rotation);
  const float nf = (float)n;
  const long long nvec = (s - head) / VEC;
  const long long body_end = head + nvec * VEC;

  if (blockIdx.x == 0) {  // the head and the tail, one column a thread
    const int t = threadIdx.x;
    if (t < head + (s - body_end))
      rotk_column<V, Map>(w, w_stride, delta, out, out_stride, t < head ? t : body_end + (t - head), rows,
                          n, worker0, r, bm);
  }

  // a thread's vectors: v0 + u * stride_u in a pass, passes stride_u * kUnroll apart
  const long long stride_u = (long long)gridDim.x * kThreads;
  const unsigned un = (unsigned)n;
  unsigned period = 0u;  // lanes 0, n, 2n, ... of a vector
  for (int k = 0; k < VEC; k += n) period |= 1u << k;
  const unsigned full = (1u << VEC) - 1u;
  const unsigned step_u = mod64(stride_u * VEC, n);
  const unsigned step_pass = mod64(stride_u * kUnroll * VEC, n);
  const long long v0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned res_pass = mod64(head + v0 * VEC, n);  // base residue of the pass's first vector

  for (long long base = v0; base < nvec; base += stride_u * kUnroll) {
    long long col[kUnroll];
    unsigned res[kUnroll];
    bool ok[kUnroll], cross[kUnroll];
    uint4 dv[kUnroll], wv[kUnroll];
    unsigned rr = res_pass;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * stride_u;
      ok[u] = v < nvec;
      col[u] = head + v * VEC;
      res[u] = rr;
      cross[u] = false;
      if constexpr (Map) {  // the residue restarts at every run: computed, not carried
        res[u] = mod64(leaf_coord(col[u], bm), n);
        cross[u] = col[u] % bm.chunk + VEC > bm.chunk;
      }
      rr = add_mod(rr, step_u, un);
      dv[u] = wv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        dv[u] = __ldcs(reinterpret_cast<const uint4*>(delta + col[u]));
        wv[u] = __ldcs(reinterpret_cast<const uint4*>(w + col[u]));  // row 0
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // delta * n rounded to T, packed as delta was
      U q[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) q[k] = V::narrow(__fmul_rn(V::widen(lane_of<U>(dv[u], k)), nf));
      dv[u] = pack_vec<U, VEC>(q);
    }
    for (int i = 0;;) {
      const int keep = kept_residue(worker0, i, r, n);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        int off = keep - (int)res[u];  // the first kept lane, if < VEC
        if (off < 0) off += n;
        unsigned mask = off < VEC ? (period << off) & full : 0u;
        if (Map && cross[u]) {  // a vector across a run's end: lane by lane
          mask = 0u;
#pragma unroll
          for (int k = 0; k < VEC; ++k) mask |= ((int)leaf_mod<Map>(col[u] + k, bm, n) == keep ? 1u : 0u) << k;
        }
        U o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          o[k] = apply<V>(lane_of<U>(wv[u], k), (mask >> k) & 1u ? V::widen(lane_of<U>(dv[u], k)) : 0.0f);
        __stcs(reinterpret_cast<uint4*>(out + i * out_stride + col[u]), pack_vec<U, VEC>(o));
      }
      if (++i == rows) break;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) wv[u] = __ldcs(reinterpret_cast<const uint4*>(w + i * w_stride + col[u]));
    }
    res_pass = add_mod(res_pass, step_pass, un);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// blocks of the vector (Vec) or one-value kernel of V that an SM holds at once
// (the first call for each kernel asks the runtime)
template <typename V, bool Vec, bool Map>
long long resident_blocks() {
  static int resident = 0;
  if (resident == 0) {
    if constexpr (Vec)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, rotk_vec_kernel<V, Map>, kThreads, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, rotk_one_kernel<V, Map>, kOneThreads, 0);
    if (resident < 1) resident = 1;
  }
  return resident;
}

template <typename V, bool Map>
void launch(const void* w, long long w_stride, const void* delta, const void* rotation, void* out,
            long long out_stride, int rows, long long s, int n, int worker0, const BlockMap& bm,
            cudaStream_t stream) {
  using U = typename V::U;
  constexpr int VEC = 16 / sizeof(U);
  // vectors need one offset mod VEC values for delta, every row of w and of out
  auto lane = [](const void* p) { return (long long)((uintptr_t)p / sizeof(U) % VEC); };
  const long long m = lane(delta);
  const bool aligned = (uintptr_t)delta % sizeof(U) == 0 && (uintptr_t)w % sizeof(U) == 0 &&
                       (uintptr_t)out % sizeof(U) == 0 && lane(w) == m && lane(out) == m &&
                       (rows == 1 || (w_stride % VEC == 0 && out_stride % VEC == 0));
  const U* wp = static_cast<const U*>(w);
  const U* dp = static_cast<const U*>(delta);
  const int* rp = static_cast<const int*>(rotation);
  U* op = static_cast<U*>(out);
  const long long sms = sm_count();
  const long long head = (VEC - m) % VEC < s ? (VEC - m) % VEC : s;
  const long long nvec = (s - head) / VEC;
  if (aligned && nvec >= sms * kThreads) {  // a full block of vectors an SM at least
    const long long need = (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const long long cap = sms * resident_blocks<V, true, Map>();
    rotk_vec_kernel<V, Map><<<(int)(need < cap ? need : cap), kThreads, 0, stream>>>(
        wp, w_stride, dp, rp, op, out_stride, s, rows, n, worker0, (int)head, bm);
  } else {
    const long long need = (s + kOneThreads - 1) / kOneThreads;
    const long long cap = sms * resident_blocks<V, false, Map>();
    rotk_one_kernel<V, Map><<<(int)(need < cap ? need : cap), kOneThreads, 0, stream>>>(
        wp, w_stride, dp, rp, op, out_stride, s, rows, n, worker0, bm);
  }
}

template <bool Map>
void launch_dtype(const void* w, long long w_stride, const void* delta, const void* rotation, void* out,
                  long long out_stride, int dtype, int rows, long long s, int n, int worker0,
                  const BlockMap& bm, cudaStream_t st) {
  if (dtype == 0)
    launch<F32, Map>(w, w_stride, delta, rotation, out, out_stride, rows, s, n, worker0, bm, st);
  else if (dtype == 1)
    launch<F16, Map>(w, w_stride, delta, rotation, out, out_stride, rows, s, n, worker0, bm, st);
  else
    launch<BF16, Map>(w, w_stride, delta, rotation, out, out_stride, rows, s, n, worker0, bm, st);
}

int dispatch(const void* w, long long w_stride, const void* delta, const void* rotation, void* out,
             long long out_stride, int dtype, int rows, long long s, int n, int worker0, void* stream,
             BlockMap bm = BlockMap{0, 0, 0, 0, 0}) {
  if (s < 0 || rows < 0 || n < 1 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (s == 0 || rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool contiguous = bm.chunk == 0 || (bm.chunk == s && bm.stride == s && bm.offset == 0 && bm.inner == 0);
  if (contiguous)
    launch_dtype<false>(w, w_stride, delta, rotation, out, out_stride, dtype, rows, s, n, worker0, bm, st);
  else
    launch_dtype<true>(w, w_stride, delta, rotation, out, out_stride, dtype, rows, s, n, worker0, bm, st);
  return (int)cudaGetLastError();
}

}  // namespace

// w, delta, out: [d] contiguous, dtype 0 = f32, 1 = f16, 2 = bf16; rotation:
// one int32 on the card; n >= 1. Launches on `stream`, does not synchronise,
// returns cudaError_t.
extern "C" int rotk_apply(const void* w, const void* delta, const void* rotation, void* out,
                          int dtype, long long d, int n, int worker, void* stream) {
  return dispatch(w, 0, delta, rotation, out, 0, dtype, 1, d, n, worker, stream);
}

// w: [rows, s] with row stride w_stride (0: one row for all) and unit column
// stride; delta: [s] contiguous; out: [rows, s] with row stride out_stride
// and unit column stride, overlapping neither; strides in values. Row i is
// worker i's replica: out[i] = w[i] + Q_i(delta). rows <= n. Same dtypes,
// rotation and stream as rotk_apply.
extern "C" int rotk_apply_rows(const void* w, long long w_stride, const void* delta,
                               const void* rotation, void* out, long long out_stride, int dtype,
                               int rows, long long s, int n, void* stream) {
  if (rows > n) return (int)cudaErrorInvalidValue;
  return dispatch(w, w_stride, delta, rotation, out, out_stride, dtype, rows, s, n, 0, stream);
}

// rotk_apply_rows over one rank's block of a leaf: block column t is leaf
// coordinate offset + (t / chunk) * stride + t % chunk, and the kept rule
// reads that coordinate. 1 <= chunk <= stride, offset + chunk <= stride, s a
// multiple of chunk; chunk = stride = s with offset 0 is rotk_apply_rows.
// inner > 0: the second level, run u at offset + (u / inner) * ostride +
// (u % inner) * stride; then offset % stride + chunk <= stride, offset +
// (inner - 1) * stride + chunk <= ostride and s a multiple of chunk * inner.
extern "C" int rotk_apply_rows_map(const void* w, long long w_stride, const void* delta,
                                   const void* rotation, void* out, long long out_stride, int dtype,
                                   int rows, long long s, int n, long long chunk, long long stride,
                                   long long offset, long long inner, long long ostride, void* stream) {
  if (rows > n || chunk < 1 || stride < chunk || offset < 0 || inner < 0 || s % chunk)
    return (int)cudaErrorInvalidValue;
  if (inner == 0 ? offset + chunk > stride
                 : offset % stride + chunk > stride || offset + (inner - 1) * stride + chunk > ostride ||
                       s % (chunk * inner))
    return (int)cudaErrorInvalidValue;
  return dispatch(w, w_stride, delta, rotation, out, out_stride, dtype, rows, s, n, 0, stream,
                  BlockMap{chunk, stride, offset, inner, ostride});
}
