// The panel of the port's dense LU: partial pivoting down a tall panel, one CTA per matrix of the batch.
//
// Replaces no TPU kernel.  The JAX package solves its dense systems with jnp.linalg.solve, an LU with partial
// pivoting that XLA computes by itself.  The port's capturable route for 512 rows and more
// (pysdc_tpu_torch/ops/linalg.py) is LAPACK's blocked right-looking getrf, written in torch: the row swaps, the
// triangular solve for U12 and the trailing update are torch calls (a gather, cuBLAS's batched trsm and GEMM).
// What no library call gives inside the body of a CUDA graph's conditional WHILE node is the panel: cuSOLVER's
// getrf, which torch takes for a tall matrix or for 512 rows and more, is refused there when the graph is made,
// and cuBLAS's getrfBatched takes square matrices only.  This kernel factors the panel.
//
//   lu_panel(a, batch_stride, ld, m, w, perm)
//     a      the panel's first element in the first matrix; element (r, c) of matrix b at
//            a[b * batch_stride + r * ld + c] (a row-major view into the whole matrix), m rows, w <= m columns;
//     perm   (batch, m) int64: row r of the factored panel is row perm[r] of the panel given.
//   On return the panel holds L (unit lower, below the diagonal) and U (on and above it) of P A = L U, with the
//   pivots LAPACK's getf2 chooses: the first row of the largest |re| + |im| (|x| for a real type) in the column.
//   A zero pivot leaves its column unscaled, as getf2 does (the matrix is singular: the solve gives inf or NaN).
//
// Design: the panel lives in shared memory for the whole factorization, column-major with a leading dimension of
// m + 1 (a column's rows are consecutive, so a warp reads a column without bank conflicts; the odd padding spreads
// the coalesced row-wise load).  For each column: the pivot by a block reduction (warp shuffles, then one warp),
// the two rows swapped in shared memory, the column scaled by the pivot's reciprocal and the rest of the panel
// updated by its rank-1 product, each thread owning rows.  The panel is read once from device memory and written
// once.  Bound: the panel's bytes (m * w * sizeof(T) each way) against its w * m * w / 2 multiply-adds; at the
// widths the Python side picks (the panel fills at most 192 KiB of shared memory) it is latency-bound: about four
// barriers a column, one CTA an SM.  The trailing update, the bulk of the LU's operations, goes to cuBLAS's GEMM.
//
// C interface, loaded with ctypes; each function returns 0 or an error code (a CUDA error, or -1 for arguments).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCRATCH_BYTES = 384;  // the reduction's values (32 x 8 bytes) and indices (32 x 4 bytes)
constexpr int MAX_SMEM_BYTES = 232448;  // what one CTA of sm_90 may opt in to

template <typename R>
struct Cx {
  R re, im;
};

__device__ inline float abs1(float x) { return fabsf(x); }
__device__ inline double abs1(double x) { return fabs(x); }
template <typename R>
__device__ inline R abs1(Cx<R> x) { return fabs(x.re) + fabs(x.im); }

__device__ inline float mul(float a, float b) { return a * b; }
__device__ inline double mul(double a, double b) { return a * b; }
template <typename R>
__device__ inline Cx<R> mul(Cx<R> a, Cx<R> b) { return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re}; }

// a - b * c
__device__ inline float fms(float a, float b, float c) { return a - b * c; }
__device__ inline double fms(double a, double b, double c) { return a - b * c; }
template <typename R>
__device__ inline Cx<R> fms(Cx<R> a, Cx<R> b, Cx<R> c) {
  return {a.re - (b.re * c.re - b.im * c.im), a.im - (b.re * c.im + b.im * c.re)};
}

// 1 / x, and 1 for a zero pivot (getf2 leaves that column unscaled)
__device__ inline float recip(float x) { return x != 0.0f ? 1.0f / x : 1.0f; }
__device__ inline double recip(double x) { return x != 0.0 ? 1.0 / x : 1.0; }
template <typename R>
__device__ inline Cx<R> recip(Cx<R> x) {
  // Smith's algorithm for 1 / (re + i im): no overflow of re^2 + im^2
  if (x.re == R(0) && x.im == R(0)) return {R(1), R(0)};
  if (fabs(x.re) >= fabs(x.im)) {
    const R r = x.im / x.re, d = x.re + x.im * r;
    return {R(1) / d, -r / d};
  }
  const R r = x.re / x.im, d = x.re * r + x.im;
  return {r / d, R(-1) / d};
}

template <typename T>
__device__ inline void swap_values(T& a, T& b) {
  const T t = a;
  a = b;
  b = t;
}

size_t smem_bytes(int m, int w, int itemsize) {
  return SCRATCH_BYTES + static_cast<size_t>(w) * (m + 1) * itemsize + static_cast<size_t>(m) * sizeof(int);
}

template <typename T, typename R>
__global__ void __launch_bounds__(THREADS) lu_panel_kernel(T* __restrict__ a, long long batch_stride, int ld, int m,
                                                           int w, long long* __restrict__ perm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  R* red_val = reinterpret_cast<R*>(smem);
  int* red_idx = reinterpret_cast<int*>(smem + 32 * sizeof(double));
  T* p = reinterpret_cast<T*>(smem + SCRATCH_BYTES);
  const int sld = m + 1;
  int* perm = reinterpret_cast<int*>(p + static_cast<size_t>(w) * sld);
  __shared__ int pivot_row;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* A = a + static_cast<long long>(blockIdx.x) * batch_stride;
  for (int i = tid; i < m * w; i += THREADS) {
    const int r = i / w, c = i - r * w;
    p[c * sld + r] = A[static_cast<long long>(r) * ld + c];
  }
  for (int r = tid; r < m; r += THREADS) perm[r] = r;
  __syncthreads();

  for (int k = 0; k < w; ++k) {
    T* col = p + k * sld;
    // the pivot: the largest abs1 at or below row k, the first such row on a tie
    R best = R(-1);
    int at = m;
    for (int r = k + tid; r < m; r += THREADS) {
      const R v = abs1(col[r]);
      if (v > best) {
        best = v;
        at = r;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const R ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, at, off);
      if (ov > best || (ov == best && oi < at)) {
        best = ov;
        at = oi;
      }
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = at;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < WARPS ? red_val[lane] : R(-1);
      at = lane < WARPS ? red_idx[lane] : m;
      for (int off = 16; off > 0; off >>= 1) {
        const R ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, at, off);
        if (ov > best || (ov == best && oi < at)) {
          best = ov;
          at = oi;
        }
      }
      // a NaN column finds no row above -1: keep the diagonal, as LAPACK's i?amax does
      if (lane == 0) pivot_row = at < m ? at : k;
    }
    __syncthreads();
    const int pr = pivot_row;
    if (pr != k) {
      for (int c = tid; c < w; c += THREADS) swap_values(p[c * sld + k], p[c * sld + pr]);
      if (tid == 0) swap_values(perm[k], perm[pr]);
      __syncthreads();
    }
    const T inv = recip(col[k]);
    for (int r = k + 1 + tid; r < m; r += THREADS) {
      const T l = mul(col[r], inv);
      col[r] = l;
      for (int c = k + 1; c < w; ++c) p[c * sld + r] = fms(p[c * sld + r], l, p[c * sld + k]);
    }
    __syncthreads();
  }

  for (int i = tid; i < m * w; i += THREADS) {
    const int r = i / w, c = i - r * w;
    A[static_cast<long long>(r) * ld + c] = p[c * sld + r];
  }
  long long* out = perm_out + static_cast<long long>(blockIdx.x) * m;
  for (int r = tid; r < m; r += THREADS) out[r] = perm[r];
}

template <typename T, typename R>
int launch(void* a, long long batch_stride, int ld, int m, int w, int batch, void* perm, cudaStream_t stream) {
  const size_t bytes = smem_bytes(m, w, sizeof(T));
  auto kernel = lu_panel_kernel<T, R>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, THREADS, bytes, stream>>>(static_cast<T*>(a), batch_stride, ld, m, w, static_cast<long long*>(perm));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// What the Python side checks its panel widths against.
int dense_lu_threads() { return THREADS; }
int dense_lu_max_smem_bytes() { return MAX_SMEM_BYTES; }
long long dense_lu_smem_bytes(int m, int w, int itemsize) { return static_cast<long long>(smem_bytes(m, w, itemsize)); }

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  a: the first panel element of the first matrix on the
// current device; perm: contiguous (batch, m) int64.  1 <= w <= m; the panel must fit shared memory.
int dense_lu_panel(int dtype, void* a, long long batch_stride, int ld, int m, int w, int batch, void* perm,
                   void* stream) {
  static const int itemsize[4] = {4, 8, 8, 16};
  if (dtype < 0 || dtype > 3 || w < 1 || w > m || ld < w || batch < 1 || batch_stride < 0) return -1;
  if (smem_bytes(m, w, itemsize[dtype]) > MAX_SMEM_BYTES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float>(a, batch_stride, ld, m, w, batch, perm, s);
    case 1: return launch<double, double>(a, batch_stride, ld, m, w, batch, perm, s);
    case 2: return launch<Cx<float>, float>(a, batch_stride, ld, m, w, batch, perm, s);
    default: return launch<Cx<double>, double>(a, batch_stride, ld, m, w, batch, perm, s);
  }
}

}  // extern "C"
