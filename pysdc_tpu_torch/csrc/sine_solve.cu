// Kernels SINE: the exact shifted solve of a 2D operator whose two axes are each the order-2 Dirichlet second
// difference on a uniform grid (the PCG preconditioner of VarCoeffDiffusion2D, HeatND's order-2 Dirichlet
// Laplacian), for a batch of right-hand sides, one shift f for each:
//
//     (I - f (cx D_x + A_y)) x = r,     D_x = tridiag(1, -2, 1) along x,  A_y = cy tridiag(1, -2, 1) along y
//
// The y axis (last, contiguous) is diagonalised by the DST-I, sin(pi j k / M) with M = ny + 1, whose eigenvalues
// lam_k = -4 cy sin^2(pi k / 2M) come from the host.  The DST-I of a row is read from a complex FFT of length M
// (cuFFT, between these kernels) of the row's odd extension.  In the sine basis each mode k is a tridiagonal system
// along x with constant diagonals, 1 - f (lam_k - 2 cx) and -f cx, solved by the Thomas recurrence.  No TPU kernel
// is replaced: the JAX package solves by dense eigen products (pysdc_tpu/ops/linop.py).  Three kernels:
//
//   sine_extend: r (rows, ny) -> v (rows, 2M), the odd extension (0, r_1..r_ny, 0, -r_ny..-r_1).  Its interleaved
//       pairs are the complex sequence z_m = v_2m + i v_2m+1 of length M that the FFT takes;
//   sine_thomas: Z = FFT(z), a row at a time -> the DST-I coefficients (the split of the real FFT of length 2M into
//       its even and odd halves, fused), the Thomas sweep along x of each (batch, k), and the odd extension of the
//       result, written over v for the second FFT;
//   sine_post:   the second FFT -> the DST-I coefficients of each row, times 2 / M: the solution.
//
// Why: the DST-I of length ny = 1024 goes through a length M = 1025 = 5^2 41, where cuFFT's radix-41 stage is the
// slow part.  Four such transforms (both axes, both ways) cost 0.69 ms at (4, 1024, 1024) float32 on an H100; the
// sweep takes the place of the two transforms along x, and the split, the odd extension, the shift and the scales
// ride in the kernels' one pass each instead of separate passes.
//
// Bound: bytes.  The least traffic reads r once and writes x once, 2 rows ny itemsize (33.6 MB, 10 us at
// (4, 1024, 1024) float32).  These kernels move about seven such passes between them (v and Z are twice the field);
// the two FFTs about eight more.  The sweep is a recurrence along x: each mode's rows follow one another, with a
// reciprocal on each row's path forward.  Design of the sweep: a block takes 32 modes of one batch entry (nb ny / 32
// blocks); its warp 0 runs their recurrences, one lane a mode, from shared memory, while four more warps stage the
// next tile of rows (coalesced loads, many in flight), so that the loads' latency hides behind the recurrence.  The
// forward sweep keeps its two recurrences, dp and the multipliers cp, in the two halves of v; the backward sweep
// reads them back through the same staging and has only its substitution on its path.
//
// C interface, loaded with ctypes; each launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};

// the sweep's block: warp 0's lanes run the recurrences of 32 sine modes, the other SWEEP_LOADERS warps stage the
// next tile of rows in shared memory meanwhile; a tile's rows: two buffers of two arrays of them fit the 48 KB of
// static shared memory
constexpr int SWEEP_LOADERS = 4;
constexpr int SWEEP_THREADS = 32 * (SWEEP_LOADERS + 1);

template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 4 ? 64 : 32;
}

__device__ __forceinline__ float reciprocal(float y) { return __frcp_rn(y); }
__device__ __forceinline__ double reciprocal(double y) { return __drcp_rn(y); }

// X_k = sum_{j=1}^{M-1} x_j sin(pi j k / M), k = 1..M-1, of the real row x whose odd extension's interleaved FFT
// row is zr (M complex values): with a = Z_k, b = Z_{M-k} and (c, s) = (cos, sin)(pi k / M),
// X_k = ((a.re - b.re) c + (a.im + b.im) s - (a.im - b.im)) / 4.
template <typename T>
__device__ __forceinline__ T dst_coefficient(const typename Complex<T>::type* __restrict__ zr, int k, int M, T c,
                                             T s) {
  const auto a = zr[k];
  const auto b = zr[M - k];
  return T(0.25) * ((a.x - b.x) * c + (a.y + b.y) * s - (a.y - b.y));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sine_extend_kernel(const T* __restrict__ x, T* __restrict__ v, int rows, int n) {
  const int M = n + 1;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * M) return;
  const long long r = idx / M;
  const int j = static_cast<int>(idx - r * M);
  const T* xr = x + r * n;
  T* vr = v + r * 2 * M;
  vr[j] = j ? xr[j - 1] : T(0);
  vr[M + j] = j ? -xr[n - j] : T(0);
}

// One block: batch entry b, the 32 sine modes k0 + 1 .. k0 + 32 (warp 0's lanes), all rows.  Forward: the loaders
// put tile t + 1's DST-I coefficients in shared memory while warp 0 runs tile t's recurrence
//     m = 1 / (diag - off cp),  cp = off m,  dp = (d - off dp) m
// and stores dp and cp in v (at k and at 2M - k, the two halves the odd extension fills later); backward: the loaders
// bring tile t - 1's dp and cp back while warp 0 substitutes tile t, x = dp - cp x, writing x and -x into v.  The
// reciprocal is rounded to nearest, as 1 / y.  A __syncthreads() between tiles orders the two buffers' turns, and
// makes warp 0's stores visible to the loaders.
template <typename T>
__device__ __forceinline__ void stage_coefficients(T (*tile)[32], const typename Complex<T>::type* __restrict__ Zb,
                                                   int t, int warp, int lane, bool active, int k, int M, int nx, T c,
                                                   T s) {
  constexpr int R = tile_rows<T>();
#pragma unroll
  for (int j = 0; j < R / SWEEP_LOADERS; ++j) {  // unrolled: a thread's loads are all in flight at once
    const int u = warp - 1 + j * SWEEP_LOADERS;
    const int i = t * R + u;
    if (active && i < nx) tile[u][lane] = dst_coefficient<T>(Zb + static_cast<long long>(i) * M, k, M, c, s);
  }
}

template <typename T>
__device__ __forceinline__ void stage_rows(T (*dps)[32], T (*cps)[32], const T* vb, long long row, int t, int warp,
                                           int lane, bool active, int k, int nx) {
  constexpr int R = tile_rows<T>();
#pragma unroll
  for (int j = 0; j < R / SWEEP_LOADERS; ++j) {
    const int u = warp - 1 + j * SWEEP_LOADERS;
    const int i = t * R + u;
    if (active && i < nx) {
      const T* vi = vb + static_cast<long long>(i) * row;
      dps[u][lane] = vi[k];
      cps[u][lane] = vi[row - k];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS)
sine_thomas_kernel(const typename Complex<T>::type* __restrict__ Z, T* __restrict__ v, const T* __restrict__ lam,
                   const T* __restrict__ cs, const T* __restrict__ sn, const T* __restrict__ fac, T fac0, T scale,
                   T cx, int nb, int nx, int ny) {
  constexpr int R = tile_rows<T>();
  __shared__ T dps[2][R][32];  // forward: the DST-I coefficients; backward: dp
  __shared__ T cps[2][R][32];  // backward: cp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (ny + 31) / 32;
  const int b = blockIdx.x / groups;
  const int k = (blockIdx.x - b * groups) * 32 + lane + 1;  // the sine mode, 1..ny where active
  const bool active = k <= ny;
  const int M = ny + 1;
  const long long row = 2LL * M;  // a row of v
  const int tiles = (nx + R - 1) / R;
  const auto* Zb = Z + static_cast<long long>(b) * nx * M;
  T* vb = v + static_cast<long long>(b) * nx * row;
  T c = T(0), s = T(0), diag = T(1), off = T(0);
  if (active) {
    const T f = (fac != nullptr ? fac[b] : fac0) * scale;
    off = -f * cx;
    diag = T(1) - f * (lam[k - 1] - T(2) * cx);
    c = cs[k - 1];
    s = sn[k - 1];
  }

  if (warp > 0) stage_coefficients<T>(dps[0], Zb, 0, warp, lane, active, k, M, nx, c, s);
  __syncthreads();
  T cp = T(0), dp = T(0);
  for (int t = 0; t < tiles; ++t) {
    if (warp == 0) {
      if (active) {
        const int rows = min(R, nx - t * R);
#pragma unroll 4
        for (int u = 0; u < rows; ++u) {
          const T m = reciprocal(diag - off * cp);
          cp = off * m;
          dp = (dps[t & 1][u][lane] - off * dp) * m;
          T* vi = vb + static_cast<long long>(t * R + u) * row;
          vi[k] = dp;
          vi[row - k] = cp;
          if (k == 1) {
            vi[0] = T(0);
            vi[M] = T(0);
          }
        }
      }
    } else if (t + 1 < tiles) {
      stage_coefficients<T>(dps[(t + 1) & 1], Zb, t + 1, warp, lane, active, k, M, nx, c, s);
    }
    __syncthreads();
  }

  if (warp > 0) stage_rows<T>(dps[(tiles - 1) & 1], cps[(tiles - 1) & 1], vb, row, tiles - 1, warp, lane, active, k, nx);
  __syncthreads();
  T x = T(0);
  for (int t = tiles - 1; t >= 0; --t) {
    if (warp == 0) {
      if (active) {
        const int rows = min(R, nx - t * R);
#pragma unroll 4
        for (int u = rows - 1; u >= 0; --u) {
          x = dps[t & 1][u][lane] - cps[t & 1][u][lane] * x;
          T* vi = vb + static_cast<long long>(t * R + u) * row;
          vi[k] = x;
          vi[row - k] = -x;
        }
      }
    } else if (t > 0) {
      stage_rows<T>(dps[(t - 1) & 1], cps[(t - 1) & 1], vb, row, t - 1, warp, lane, active, k, nx);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sine_post_kernel(const typename Complex<T>::type* __restrict__ Z, T* __restrict__ x, const T* __restrict__ cs,
                 const T* __restrict__ sn, T scale, int rows, int n) {
  const int M = n + 1;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * n) return;
  const long long r = idx / n;
  const int k = static_cast<int>(idx - r * n) + 1;
  x[idx] = scale * dst_coefficient<T>(Z + r * M, k, M, cs[k - 1], sn[k - 1]);
}

int blocks_for(long long threads, int per_block) {
  const long long blocks = (threads + per_block - 1) / per_block;
  return blocks > 0x7fffffffLL ? -1 : static_cast<int>(blocks);
}

template <typename T>
int extend(const void* x, void* v, int rows, int n, cudaStream_t stream) {
  const int blocks = blocks_for(static_cast<long long>(rows) * (n + 1), THREADS);
  if (blocks < 0) return -1;
  sine_extend_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(v), rows, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int thomas(const void* Z, void* v, const void* lam, const void* cs, const void* sn, const void* fac, double fac0,
           double scale, double cx, int nb, int nx, int ny, cudaStream_t stream) {
  const int blocks = blocks_for(static_cast<long long>(nb) * ((ny + 31) / 32), 1);
  if (blocks < 0) return -1;
  sine_thomas_kernel<T><<<blocks, SWEEP_THREADS, 0, stream>>>(
      static_cast<const typename Complex<T>::type*>(Z), static_cast<T*>(v), static_cast<const T*>(lam),
      static_cast<const T*>(cs), static_cast<const T*>(sn), static_cast<const T*>(fac), static_cast<T>(fac0),
      static_cast<T>(scale), static_cast<T>(cx), nb, nx, ny);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int post(const void* Z, void* x, const void* cs, const void* sn, double scale, int rows, int n,
         cudaStream_t stream) {
  const int blocks = blocks_for(static_cast<long long>(rows) * n, THREADS);
  if (blocks < 0) return -1;
  sine_post_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const typename Complex<T>::type*>(Z),
                                                      static_cast<T*>(x), static_cast<const T*>(cs),
                                                      static_cast<const T*>(sn), static_cast<T>(scale), rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: contiguous (rows, n); v: contiguous (rows, 2 (n + 1)).
int sine_extend_launch(int dtype, const void* x, void* v, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0 || n >= 0x3fffffff) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return extend<float>(x, v, rows, n, s);
  if (dtype == 1) return extend<double>(x, v, rows, n, s);
  return -1;
}

// Z: contiguous complex (nb nx, ny + 1); v: contiguous (nb nx, 2 (ny + 1)), written whole; lam, cs, sn: (ny,);
// fac: (nb,) or null (then fac0 for all).
int sine_thomas_launch(int dtype, const void* Z, void* v, const void* lam, const void* cs, const void* sn,
                       const void* fac, double fac0, double scale, double cx, int nb, int nx, int ny, void* stream) {
  if (nb <= 0 || nx <= 0 || ny <= 0 || static_cast<long long>(nb) * ((ny + 31) / 32) > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return thomas<float>(Z, v, lam, cs, sn, fac, fac0, scale, cx, nb, nx, ny, s);
  if (dtype == 1) return thomas<double>(Z, v, lam, cs, sn, fac, fac0, scale, cx, nb, nx, ny, s);
  return -1;
}

// Z: contiguous complex (rows, n + 1); x: contiguous (rows, n); cs, sn: (n,).
int sine_post_launch(int dtype, const void* Z, void* x, const void* cs, const void* sn, double scale, int rows, int n,
                     void* stream) {
  if (rows <= 0 || n <= 0 || n >= 0x3fffffff) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return post<float>(Z, x, cs, sn, scale, rows, n, s);
  if (dtype == 1) return post<double>(Z, x, cs, sn, scale, rows, n, s);
  return -1;
}

}  // extern "C"
