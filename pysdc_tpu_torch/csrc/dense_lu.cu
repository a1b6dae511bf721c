// The port's dense LU from 512 rows: two kernels for one block of BLOCK (64) columns of LAPACK's blocked
// right-looking getrf, one CTA per matrix of the batch (lu_panel) or per matrix and tile of columns (lu_swap_trsm).
//
// Replaces no TPU kernel.  The JAX package solves its dense systems with jnp.linalg.solve, an LU with partial
// pivoting that XLA computes by itself.  The port's capturable route for 512 rows and more
// (pysdc_tpu_torch/ops/linalg.py:_getrf) runs, for each block of 64 columns: lu_panel on the block's columns down
// the whole remaining height, lu_swap_trsm on the rest of the block's rows, and cuBLAS's batched GEMM for the
// trailing matrix.  No library call factors a tall panel inside the body of a CUDA graph's conditional WHILE node
// (cuSOLVER's getrf is refused there when the graph is made, cuBLAS's getrfBatched takes square matrices only).
//
//   lu_panel(a, batch_stride, ld, m, w, ws, perm)
//     a      the panel's first element in the first matrix; element (r, c) of matrix b at
//            a[b * batch_stride + r * ld + c] (a row-major view into the whole matrix), m rows, w <= min(m, 64)
//            columns;
//     ws     the sub-panel width: ws columns of m rows fit shared memory (a power of two; ws <= 32 when ws < w);
//     perm   (batch, m) int64: row r of the factored panel is row perm[r] of the panel given.
//   On return the panel holds L (unit lower, below the diagonal) and U (on and above it) of P A = L U, with the
//   pivots LAPACK's getf2 chooses: the first row of the largest |re| + |im| (|x| for a real type) in the column.
//   A zero pivot leaves its column unscaled, as getf2 does (the matrix is singular: the solve gives inf or NaN).
//
//   lu_swap_trsm(a, batch_stride, ld, m, w, j, jb, perm)
//     a      element (0, 0) of the first matrix, (batch, m, w) row-major with row stride ld;
//     j, jb  the block's first column and width; perm (batch, m - j) int64, what lu_panel returned for the panel
//            (rows j.. of columns j .. j + jb).
//   Applies the panel's row interchanges to rows j.. of every column outside the panel (LAPACK's laswp) and solves
//   L11 U12 = A12 in place for the columns right of it (trsm; L11 the panel's unit lower jb x jb top).
//
// Design of lu_panel: left-looking over sub-panels of ws columns.  The CTA keeps the permutation in shared memory
// and never moves a row in device memory while it factors: logical row r lives at physical row perm[r], whose
// earlier columns carry their L entries with it, so a later interchange reaches them as LAPACK's laswp would.
// For sub-panel s the CTA loads its ws columns (logical order) into shared memory and applies the earlier
// sub-panels, L read back from where the kernel wrote it: their rows of this sub-panel by blocks (a ws x ws unit
// lower solve, a warp a column, then a rank-ws product for the rows below up to the sub-panel), then every lower
// row by one product with all earlier columns.  The products take the FP64 tensor cores (mma.sync m8n8k4, four
// real products a complex one) for float64 and complex128, the CUDA cores for the float types.  The sub-panel is
// then factored in shared memory with one barrier a column: every warp reduces the warps' pivot candidates
// itself, a swap is a swap of two entries of a row map (no row is copied, and the pivot row is read while the
// others update), and the rank-1 update finds the next column's candidates.  At the end the rows that the
// permutation moves (at most 2 w, a closed set) are staged through shared memory and written to their places.  The
// panel is read once and written once; the products read L back, sum_s m * s * ws entries.  Bound: those bytes
// against w * m * w / 2 multiply-adds.  Measured (lu_probe.py timing): at 512 rows complex128 (ws 16, one CTA an
// SM, two waves at a batch of 256) the CTA is latency-bound, about 1.5 us a column on the pivot's path.
//
// Design of lu_swap_trsm: one CTA per (matrix, tile of 64 columns).  The moved rows form a closed set (the
// permutation is a bijection) of at most 2 jb rows: the CTA finds them, stages their old values (16 columns at a
// time) in shared memory and writes them to their new places; it owns its columns, so it writes in place.  Right
// of the panel it loads L11 once (64 KB at jb 64 complex128) and substitutes down its tile: each warp owns 8
// columns, each lane two rows, the solved entry passed by a warp shuffle.  Bound, each byte once: the moved rows
// read and written left of the panel, the union of the moved rows and the top jb rows read and written right of it,
// L11's strict lower triangle once a matrix, against jb^2 / 2 multiply-adds a column right of the panel.  The
// kernel moves more: every CTA right of the panel reads all of L11, and the top rows again after the swaps.
//
// Both launch on the caller's stream, allocate nothing, read nothing on the host and use no cluster, so a CUDA
// graph holds them inside a conditional WHILE body.  C interface, loaded with ctypes; each function returns 0 or
// an error code (a CUDA error, or -1 for arguments).

#include <cuda_runtime.h>

#include <cstdint>

// Timing marks, compiled in only with -DDENSE_LU_TIMING (lu_probe.py timing): the card's global timer at each mark
// of the first CTA, its SM clock at the start and the end, and each CTA's start and end.  The library's build leaves
// the marks empty.
#ifdef DENSE_LU_TIMING
__device__ unsigned long long dl_marks[128];
__device__ unsigned long long dl_cta[2 * 8192];
__device__ long long dl_clock[2];
__device__ inline unsigned long long dl_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define DL_FIRST (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
#define DL_CTA (blockIdx.y * gridDim.x + blockIdx.x)
#define DL_START                               \
  const unsigned long long dl_t0 = dl_now(); \
  int dl_n = 0;                              \
  if (DL_FIRST) {                            \
    dl_marks[dl_n++] = dl_t0;                \
    dl_clock[0] = clock64();                 \
  }
#define DL_MARK \
  if (DL_FIRST && dl_n < 128) dl_marks[dl_n++] = dl_now();
#define DL_MARK_IF(c) \
  if (c) {            \
    DL_MARK           \
  }
#define DL_END                                  \
  if (threadIdx.x == 0 && DL_CTA < 8192) {      \
    dl_cta[2 * DL_CTA] = dl_t0;                 \
    dl_cta[2 * DL_CTA + 1] = dl_now();          \
  }                                             \
  if (DL_FIRST) dl_clock[1] = clock64();        \
  DL_MARK
extern "C" int dl_read(void* marks, void* ctas, void* clocks) {
  if (cudaMemcpyFromSymbol(clocks, dl_clock, sizeof(dl_clock)) != cudaSuccess) return 3;
  if (cudaMemcpyFromSymbol(marks, dl_marks, sizeof(dl_marks)) != cudaSuccess) return 1;
  return cudaMemcpyFromSymbol(ctas, dl_cta, sizeof(dl_cta)) != cudaSuccess ? 2 : 0;
}
extern "C" int dl_clear() {
  static unsigned long long zero[2 * 8192] = {0};
  if (cudaMemcpyToSymbol(dl_marks, zero, sizeof(dl_marks)) != cudaSuccess) return 1;
  return cudaMemcpyToSymbol(dl_cta, zero, sizeof(dl_cta)) != cudaSuccess ? 2 : 0;
}
#else
#define DL_START
#define DL_MARK
#define DL_MARK_IF(c)
#define DL_END
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCRATCH_BYTES = 384;      // two columns' pivot candidates and diagonals, the moved-row counter
constexpr int MAX_SMEM_BYTES = 232448;  // what one CTA of sm_90 may opt in to
constexpr int MAX_WIDTH = 64;           // the widest panel (the route's BLOCK)
constexpr int LCHUNK = 8;               // L entries a thread loads at a time (products on the CUDA cores)
constexpr int ROW_COLS = 16;            // columns of a row a thread holds in registers there
constexpr int DMMA_KSTEPS = MAX_WIDTH / 4;  // k-steps of 4 of a product on the tensor cores, at most
constexpr int DMMA_NTILES = 4;          // its 8-column tiles, at most (a sub-panel of 32 columns)
constexpr int SWAP_TILE = 64;           // columns a CTA of lu_swap_trsm owns
constexpr int SWAP_COLS = SWAP_TILE / WARPS;  // columns a warp substitutes
constexpr int SWAP_CHUNK = 16;          // columns staged at a time for the row interchanges
constexpr int IN_FLIGHT = 16;           // loads a thread issues before it stores the first (device memory latency)

// aligned to its size, so that a value moves in one 16-byte (complex128) or 8-byte access
template <typename R>
struct alignas(2 * sizeof(R)) Cx {
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

// a - b * c, a complex one as four fused multiply-adds
__device__ inline float fms(float a, float b, float c) { return fmaf(-b, c, a); }
__device__ inline double fms(double a, double b, double c) { return fma(-b, c, a); }
template <typename R>
__device__ inline Cx<R> fms(Cx<R> a, Cx<R> b, Cx<R> c) {
  return {fms(fms(a.re, -b.im, c.im), b.re, c.re), fms(fms(a.im, b.im, c.re), b.re, c.im)};
}

// 1 / x, and 1 for a zero pivot (getf2 leaves that column unscaled)
__device__ inline float recip(float x) { return x != 0.0f ? 1.0f / x : 1.0f; }
__device__ inline double recip(double x) { return x != 0.0 ? 1.0 / x : 1.0; }
__device__ inline int exponent(float x) { return ilogbf(x); }
__device__ inline int exponent(double x) { return ilogb(x); }
__device__ inline float times_two_to(float x, int e) { return scalbnf(x, e); }
__device__ inline double times_two_to(double x, int e) { return scalbn(x, e); }
template <typename R>
__device__ inline Cx<R> recip(Cx<R> x) {
  // conj(x) / |x|^2 with x scaled by a power of two first (exactly), so that |x|^2 neither overflows nor
  // underflows: one reciprocal on the pivot's path where Smith's algorithm takes two divisions
  if (x.re == R(0) && x.im == R(0)) return {R(1), R(0)};
  const int e = exponent(fabs(x.re) >= fabs(x.im) ? fabs(x.re) : fabs(x.im));
  const R re = times_two_to(x.re, -e), im = times_two_to(x.im, -e);
  const R d = R(1) / (re * re + im * im);
  return {times_two_to(re * d, -e), times_two_to(-im * d, -e)};
}

__device__ inline double re(double x) { return x; }
__device__ inline double im(double) { return 0.0; }
__device__ inline double re(Cx<double> x) { return x.re; }
__device__ inline double im(Cx<double> x) { return x.im; }
__device__ inline void set(double& x, double r, double) { x = r; }
__device__ inline void set(Cx<double>& x, double r, double i) { x = {r, i}; }

// d += a b on the FP64 tensor cores, an 8 x 4 by 4 x 8 product a warp: lane l holds a = A[l / 4][l % 4],
// b = B[l % 4][l / 4] and d = D[l / 4][2 (l % 4) .. + 2]
__device__ inline void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// the value of lane src of the warp
__device__ inline float shfl(float x, int src) { return __shfl_sync(0xffffffffu, x, src); }
__device__ inline double shfl(double x, int src) { return __shfl_sync(0xffffffffu, x, src); }
template <typename R>
__device__ inline Cx<R> shfl(Cx<R> x, int src) { return {shfl(x.re, src), shfl(x.im, src)}; }

// (best, at, where) of two candidates: the larger value, the first row on a tie
template <typename R>
__device__ inline void keep_better(R& best, int& at, int& where, R v, int r, int s) {
  if (v > best || (v == best && r < at)) {
    best = v;
    at = r;
    where = s;
  }
}

// dst(i, src(i)) for i < n over the CTA's threads, IN_FLIGHT loads a thread in flight before their stores: a loop
// that stores each value before it loads the next waits out the device memory's latency at every element
template <typename T, typename Src, typename Dst>
__device__ inline void move(int n, Src src, Dst dst) {
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * IN_FLIGHT) {
    T v[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) v[u] = src(i);
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) dst(i, v[u]);
    }
  }
}

size_t panel_smem_bytes(int m, int ws, int itemsize) {
  return SCRATCH_BYTES + static_cast<size_t>(ws) * (m + 1) * itemsize + 2 * static_cast<size_t>(m) * sizeof(int);
}

__host__ __device__ inline int moved_cap(int rows, int width) { return rows < 2 * width ? rows : 2 * width; }

size_t swap_smem_bytes(int rows, int jb, int itemsize) {
  const size_t cap = moved_cap(rows, jb);
  return 16 + static_cast<size_t>(jb) * (jb + 1) * itemsize + cap * SWAP_CHUNK * itemsize + cap * sizeof(int);
}

// p's rows r_lo .. r_hi (columns 0 .. wc <= 32) minus L's columns k0 .. k0 + kn (kn <= 64) of those rows times
// p's rows k0 .. k0 + kn, L's row r at A's row perm[r]: float64 and complex128 on the FP64 tensor cores, a warp an
// 8-row tile at a time, a complex product as four real ones (re -= Lre Xre - Lim Xim, im -= Lre Xim + Lim Xre)
template <typename T>
__device__ void product_dmma(T* p, int sld, const T* A, int ld, const int* perm, int k0, int kn, int r_lo, int r_hi,
                             int wc) {
  constexpr bool complex = sizeof(T) == 2 * sizeof(double);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, gk = lane & 3;
  const int tiles = (wc + 7) / 8, steps = (kn + 3) / 4;
  for (int r0 = r_lo + 8 * warp; r0 < r_hi; r0 += 8 * WARPS) {
    const int ra = r0 + gr;
    const T* L = A + static_cast<long long>(perm[min(ra, r_hi - 1)]) * ld + k0;
    T la[DMMA_KSTEPS];
#pragma unroll
    for (int s = 0; s < DMMA_KSTEPS; ++s) la[s] = s < steps && ra < r_hi && 4 * s + gk < kn ? L[4 * s + gk] : T{};
    double cre[DMMA_NTILES][2], cim[DMMA_NTILES][2];
#pragma unroll
    for (int t = 0; t < DMMA_NTILES; ++t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = 8 * t + 2 * gk + i;
        const T v = t < tiles && ra < r_hi && c < wc ? p[c * sld + ra] : T{};
        cre[t][i] = re(v);
        cim[t][i] = im(v);
      }
    }
#pragma unroll
    for (int s = 0; s < DMMA_KSTEPS; ++s) {
      if (s < steps) {
        const int k = 4 * s + gk;  // B's row: p's row k0 + k
        const double lre = re(la[s]), lim = im(la[s]);
#pragma unroll
        for (int t = 0; t < DMMA_NTILES; ++t) {
          if (t < tiles) {
            const int c = 8 * t + gr;
            const T x = k < kn && c < wc ? p[c * sld + k0 + k] : T{};
            dmma(cre[t], -lre, re(x));
            if (complex) {
              dmma(cre[t], lim, im(x));
              dmma(cim[t], -lre, im(x));
              dmma(cim[t], -lim, re(x));
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < DMMA_NTILES; ++t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = 8 * t + 2 * gk + i;
        if (t < tiles && ra < r_hi && c < wc) set(p[c * sld + ra], cre[t][i], cim[t][i]);
      }
    }
  }
}

// product_dmma for the float types, on the CUDA cores: a thread a row, ROW_COLS of its columns and LCHUNK of its L
// entries in registers (the next LCHUNK loaded while these are used)
template <typename T>
__device__ void product_scalar(T* p, int sld, const T* A, int ld, const int* perm, int k0, int kn, int r_lo,
                               int r_hi, int wc) {
  for (int r = r_lo + threadIdx.x; r < r_hi; r += THREADS) {
    const T* L = A + static_cast<long long>(perm[r]) * ld + k0;
    for (int c = 0; c < wc; c += ROW_COLS) {
      const int cn = min(ROW_COLS, wc - c);
      T acc[ROW_COLS], lk[LCHUNK], next[LCHUNK];
#pragma unroll
      for (int u = 0; u < ROW_COLS; ++u) acc[u] = u < cn ? p[(c + u) * sld + r] : T{};
#pragma unroll
      for (int q = 0; q < LCHUNK; ++q) lk[q] = q < kn ? L[q] : T{};
      for (int k = 0; k < kn; k += LCHUNK) {
#pragma unroll
        for (int q = 0; q < LCHUNK; ++q) next[q] = k + LCHUNK + q < kn ? L[k + LCHUNK + q] : T{};
#pragma unroll
        for (int q = 0; q < LCHUNK; ++q) {
          if (k + q < kn) {
#pragma unroll
            for (int u = 0; u < ROW_COLS; ++u) {
              // the same address across the warp: a broadcast
              if (u < cn) acc[u] = fms(acc[u], lk[q], p[(c + u) * sld + k0 + k + q]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < LCHUNK; ++q) lk[q] = next[q];
      }
#pragma unroll
      for (int u = 0; u < ROW_COLS; ++u) {
        if (u < cn) p[(c + u) * sld + r] = acc[u];
      }
    }
  }
}

// the product of product_dmma: on the FP64 tensor cores for float64 and complex128 (real type R double)
template <typename T, typename R>
__device__ inline void product(T* p, int sld, const T* A, int ld, const int* perm, int k0, int kn, int r_lo, int r_hi,
                               int wc) {
  if constexpr (sizeof(R) == sizeof(double)) {
    product_dmma(p, sld, A, ld, perm, k0, kn, r_lo, r_hi, wc);
  } else {
    product_scalar(p, sld, A, ld, perm, k0, kn, r_lo, r_hi, wc);
  }
}

template <typename T, typename R>
__global__ void __launch_bounds__(THREADS) lu_panel_kernel(T* __restrict__ a, long long batch_stride, int ld, int m,
                                                           int w, int ws, long long* __restrict__ perm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the pivot candidates of two columns, one per warp: [2][WARPS] values, rows, places in p
  R* red_val = reinterpret_cast<R*>(smem);
  int* red_row = reinterpret_cast<int*>(smem + 2 * WARPS * sizeof(double));
  int* red_slot = red_row + 2 * WARPS;
  int* diag = red_slot + 2 * WARPS;  // [2]: the place in p of the diagonal's row, of two columns
  int* moved_count = diag + 2;
  T* p = reinterpret_cast<T*>(smem + SCRATCH_BYTES);  // the sub-panel, column-major, m + 1 a column
  const int sld = m + 1;
  int* perm = reinterpret_cast<int*>(p + static_cast<size_t>(ws) * sld);  // logical row -> physical row
  int* slot = perm + m;                                                    // logical row -> row of p

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's pivot candidate (the largest abs1, its row, its place in p), the warp's best into buffer b
  auto publish = [&](R best, int at, int where, int b) {
    for (int off = 16; off > 0; off >>= 1) {
      const R ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, at, off);
      const int os = __shfl_down_sync(0xffffffffu, where, off);
      keep_better(best, at, where, ov, oi, os);
    }
    if (lane == 0) {
      red_val[b * WARPS + warp] = best;
      red_row[b * WARPS + warp] = at;
      red_slot[b * WARPS + warp] = where;
    }
  };
  T* A = a + static_cast<long long>(blockIdx.x) * batch_stride;
  DL_START
  for (int r = tid; r < m; r += THREADS) perm[r] = r;
  if (tid == 0) *moved_count = 0;
  __syncthreads();

  for (int c0 = 0; c0 < w; c0 += ws) {
    const int wc = min(ws, w - c0);
    move<T>(
        m * wc, [&](int i) { return A[static_cast<long long>(perm[i / wc]) * ld + c0 + i % wc]; },
        [&](int i, T v) { p[(i % wc) * sld + i / wc] = v; });
    for (int r = tid; r < m; r += THREADS) slot[r] = r;
    __syncthreads();
    DL_MARK

    // the earlier sub-panels [t0, t0 + ws): the rows t0.. t0 + ws of this one by L_tt's unit lower solve (ws <= 32
    // here: a warp a column, a lane a row), the rows below them up to c0 by the rank-ws product with L's columns
    // t0.., then every row from c0 on by one product with L's columns 0..c0
    for (int t0 = 0; t0 < c0; t0 += ws) {
      const T* Lrow = A + static_cast<long long>(perm[t0 + min(lane, ws - 1)]) * ld + t0;
      for (int c = warp; c < wc; c += WARPS) {
        T x = lane < ws ? p[c * sld + t0 + lane] : T{};
        for (int k0 = 0; k0 < ws - 1; k0 += 8) {
          T lk[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) lk[q] = lane > k0 + q && lane < ws ? Lrow[k0 + q] : T{};
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (k0 + q < ws - 1) {
              const T xk = shfl(x, k0 + q);
              if (lane > k0 + q && lane < ws) x = fms(x, lk[q], xk);
            }
          }
        }
        if (lane < ws) p[c * sld + t0 + lane] = x;
      }
      __syncthreads();
      DL_MARK
      product<T, R>(p, sld, A, ld, perm, t0, ws, t0 + ws, c0, wc);
      __syncthreads();
    }
    if (c0 > 0) {
      product<T, R>(p, sld, A, ld, perm, 0, c0, c0, m, wc);
      __syncthreads();
    }

    // factor the sub-panel's rows c0.. in shared memory, one barrier a column: each warp reduces the warps' pivot
    // candidates itself, a swap is a swap of two entries of slot[] (no row is copied, and the pivot row is read
    // while the others update), and the rank-1 update finds the next column's candidates
    DL_MARK
    {  // the first column's candidates
      R best = R(-1);
      int at = m, where = 0;
      for (int r = c0 + tid; r < m; r += THREADS) keep_better(best, at, where, abs1(p[slot[r]]), r, slot[r]);
      publish(best, at, where, 0);
      if (tid == 0) diag[0] = slot[c0];
      __syncthreads();
    }
    for (int k = 0; k < wc; ++k) {
      const int kr = c0 + k, b = k & 1;
      T* col = p + k * sld;
      R best = red_val[b * WARPS];
      int at = red_row[b * WARPS], where = red_slot[b * WARPS];
      for (int q = 1; q < WARPS; ++q) {
        keep_better(best, at, where, red_val[b * WARPS + q], red_row[b * WARPS + q], red_slot[b * WARPS + q]);
      }
      const int slot_k = diag[b];
      DL_MARK_IF(k < 2)
      // a NaN column finds no row above -1: keep the diagonal, as LAPACK's i?amax does
      const int pr = at < m ? at : kr;
      const int sp = at < m ? where : slot_k;  // the pivot row's place in p: row kr once swapped
      const T inv = recip(col[sp]);
      const bool next = k + 1 < wc;
      R next_best = R(-1);
      int next_at = m, next_where = 0;
      for (int r = kr + 1 + tid; r < m; r += THREADS) {
        const int s = r == pr ? slot_k : slot[r];  // logical row r after the swap
        const T l = mul(col[s], inv);
        col[s] = l;
        for (int c = k + 1; c < wc; ++c) p[c * sld + s] = fms(p[c * sld + s], l, p[c * sld + sp]);
        if (next) keep_better(next_best, next_at, next_where, abs1(p[(k + 1) * sld + s]), r, s);
      }
      if (next) publish(next_best, next_at, next_where, b ^ 1);
      if (tid == 0) {
        if (pr != kr) {
          slot[kr] = sp;
          slot[pr] = slot_k;
          const int t = perm[kr];
          perm[kr] = perm[pr];
          perm[pr] = t;
        }
        if (next) diag[b ^ 1] = slot[kr + 1];
      }
      __syncthreads();
      DL_MARK_IF(k < 2)
    }

    DL_MARK
    for (int i = tid; i < m * wc; i += THREADS) {
      const int r = i / wc, c = i - r * wc;
      A[static_cast<long long>(perm[r]) * ld + c0 + c] = p[c * sld + slot[r]];
    }
    __syncthreads();
  }

  // the rows the permutation moves, to their places: staged through p, `chunk` columns at a time
  const int cap = moved_cap(m, w);
  int* moved = slot;
  for (int r = tid; r < m; r += THREADS) {
    if (perm[r] != r) {
      const int q = atomicAdd(moved_count, 1);
      if (q < cap) moved[q] = r;
    }
  }
  __syncthreads();
  const int n_moved = min(*moved_count, cap);
  const int chunk = min(w, static_cast<int>(static_cast<size_t>(ws) * sld / cap));
  for (int cs = 0; cs < w; cs += chunk) {
    const int cn = min(chunk, w - cs);
    move<T>(
        n_moved * cn, [&](int i) { return A[static_cast<long long>(perm[moved[i / cn]]) * ld + cs + i % cn]; },
        [&](int i, T v) { p[i] = v; });
    __syncthreads();
    DL_MARK
    for (int i = tid; i < n_moved * cn; i += THREADS) {
      const int q = i / cn, c = i - q * cn;
      A[static_cast<long long>(moved[q]) * ld + cs + c] = p[i];
    }
    __syncthreads();
  }
  long long* out = perm_out + static_cast<long long>(blockIdx.x) * m;
  for (int r = tid; r < m; r += THREADS) out[r] = perm[r];
  DL_END
}

template <typename T, typename R>
__global__ void __launch_bounds__(THREADS) lu_swap_trsm_kernel(T* __restrict__ a, long long batch_stride, int ld,
                                                               int m, int w, int j, int jb,
                                                               const long long* __restrict__ perm, int left_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* count = reinterpret_cast<int*>(smem);
  T* Ls = reinterpret_cast<T*>(smem + 16);  // L11, column-major, jb + 1 a column
  const int lld = jb + 1;
  const int rows = m - j;
  const int cap = moved_cap(rows, jb);
  T* stage = Ls + jb * lld;
  int* moved = reinterpret_cast<int*>(stage + cap * SWAP_CHUNK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* top = a + static_cast<long long>(blockIdx.y) * batch_stride + static_cast<long long>(j) * ld;  // row j
  const long long* P = perm + static_cast<long long>(blockIdx.y) * rows;
  DL_START
  const bool right = static_cast<int>(blockIdx.x) >= left_tiles;
  const int c_lo = right ? j + jb + (blockIdx.x - left_tiles) * SWAP_TILE : blockIdx.x * SWAP_TILE;
  const int c_hi = min(right ? w : j, c_lo + SWAP_TILE);
  if (tid == 0) *count = 0;
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) {
    if (P[r] != r) {
      const int q = atomicAdd(count, 1);
      if (q < cap) moved[q] = r;
    }
  }
  if (right) {
    move<T>(
        jb * jb, [&](int i) { return top[static_cast<long long>(i / jb) * ld + j + i % jb]; },
        [&](int i, T v) { Ls[(i % jb) * lld + i / jb] = v; });
  }
  __syncthreads();
  const int n_moved = min(*count, cap);
  DL_MARK
  for (int cs = c_lo; cs < c_hi; cs += SWAP_CHUNK) {
    const int cn = min(SWAP_CHUNK, c_hi - cs);
    move<T>(
        n_moved * cn, [&](int i) { return top[P[moved[i / cn]] * ld + cs + i % cn]; },
        [&](int i, T v) { stage[(i / cn) * SWAP_CHUNK + i % cn] = v; });
    __syncthreads();
    for (int i = tid; i < n_moved * cn; i += THREADS) {
      const int q = i / cn, c = i - q * cn;
      top[static_cast<long long>(moved[q]) * ld + cs + c] = stage[q * SWAP_CHUNK + c];
    }
    __syncthreads();
  }
  if (!right) return;
  DL_MARK

  // U12 = L11^-1 A12 on the tile: warp w owns columns c_lo + 8 w .. + 8, lane l rows l and l + 32 (jb <= 64)
  const int cw = c_lo + warp * SWAP_COLS;
  T x[SWAP_COLS][2];
#pragma unroll
  for (int g = 0; g < SWAP_COLS; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      x[g][h] = r < jb && cw + g < c_hi ? top[static_cast<long long>(r) * ld + cw + g] : T{};
    }
  }
  // the first 32 rows' entries solve both halves, the others the second half only
  for (int k = 0; k < min(jb - 1, 32); ++k) {
    const bool below0 = lane > k && lane < jb, below1 = lane + 32 < jb;
    const T l0 = below0 ? Ls[k * lld + lane] : T{};
    const T l1 = below1 ? Ls[k * lld + lane + 32] : T{};
#pragma unroll
    for (int g = 0; g < SWAP_COLS; ++g) {
      const T xk = shfl(x[g][0], k);
      if (below0) x[g][0] = fms(x[g][0], l0, xk);
      if (below1) x[g][1] = fms(x[g][1], l1, xk);
    }
  }
  for (int k = 32; k < jb - 1; ++k) {
    const bool below1 = lane + 32 > k && lane + 32 < jb;
    const T l1 = below1 ? Ls[k * lld + lane + 32] : T{};
#pragma unroll
    for (int g = 0; g < SWAP_COLS; ++g) {
      const T xk = shfl(x[g][1], k - 32);
      if (below1) x[g][1] = fms(x[g][1], l1, xk);
    }
  }
#pragma unroll
  for (int g = 0; g < SWAP_COLS; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r < jb && cw + g < c_hi) top[static_cast<long long>(r) * ld + cw + g] = x[g][h];
    }
  }
  DL_END
}

// dynamic shared memory above 48 KiB for `kernel`
template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, typename R>
int launch_panel(void* a, long long batch_stride, int ld, int m, int w, int ws, int batch, void* perm,
                 cudaStream_t stream) {
  const size_t bytes = panel_smem_bytes(m, ws, sizeof(T));
  auto kernel = lu_panel_kernel<T, R>;
  const int err = opt_in(kernel, bytes);
  if (err != 0) return err;
  kernel<<<batch, THREADS, bytes, stream>>>(static_cast<T*>(a), batch_stride, ld, m, w, ws,
                                            static_cast<long long*>(perm));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R>
int launch_swap(void* a, long long batch_stride, int ld, int m, int w, int j, int jb, int batch, const void* perm,
                cudaStream_t stream) {
  const int left = (j + SWAP_TILE - 1) / SWAP_TILE, right = (w - j - jb + SWAP_TILE - 1) / SWAP_TILE;
  if (left + right == 0) return 0;
  const size_t bytes = swap_smem_bytes(m - j, jb, sizeof(T));
  auto kernel = lu_swap_trsm_kernel<T, R>;
  const int err = opt_in(kernel, bytes);
  if (err != 0) return err;
  kernel<<<dim3(left + right, batch), THREADS, bytes, stream>>>(static_cast<T*>(a), batch_stride, ld, m, w, j, jb,
                                                                 static_cast<const long long*>(perm), left);
  return static_cast<int>(cudaGetLastError());
}

const int ITEMSIZE[4] = {4, 8, 8, 16};

}  // namespace

extern "C" {

// What the Python side checks its widths and limits against.
int dense_lu_threads() { return THREADS; }
int dense_lu_max_smem_bytes() { return MAX_SMEM_BYTES; }
int dense_lu_max_width() { return MAX_WIDTH; }
int dense_lu_swap_tile() { return SWAP_TILE; }
long long dense_lu_smem_bytes(int m, int ws, int itemsize) {
  return static_cast<long long>(panel_smem_bytes(m, ws, itemsize));
}
long long dense_lu_swap_smem_bytes(int rows, int jb, int itemsize) {
  return static_cast<long long>(swap_smem_bytes(rows, jb, itemsize));
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.  a: the first panel element of the first matrix on the
// current device; perm: contiguous (batch, m) int64.  1 <= w <= min(m, 64); 1 <= ws <= w, ws <= 32 where ws < w;
// the sub-panel must fit shared memory and hold the moved rows of one staged column.
int dense_lu_panel(int dtype, void* a, long long batch_stride, int ld, int m, int w, int ws, int batch, void* perm,
                   void* stream) {
  if (dtype < 0 || dtype > 3 || w < 1 || w > m || w > MAX_WIDTH || ws < 1 || ws > w || (ws < w && ws > 32) ||
      ld < w || batch < 1 || batch_stride < 0)
    return -1;
  if (panel_smem_bytes(m, ws, ITEMSIZE[dtype]) > MAX_SMEM_BYTES ||
      static_cast<size_t>(moved_cap(m, w)) > static_cast<size_t>(ws) * (m + 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_panel<float, float>(a, batch_stride, ld, m, w, ws, batch, perm, s);
    case 1: return launch_panel<double, double>(a, batch_stride, ld, m, w, ws, batch, perm, s);
    case 2: return launch_panel<Cx<float>, float>(a, batch_stride, ld, m, w, ws, batch, perm, s);
    default: return launch_panel<Cx<double>, double>(a, batch_stride, ld, m, w, ws, batch, perm, s);
  }
}

// a: element (0, 0) of the first matrix, (batch, m, w) with row stride ld; perm: contiguous (batch, m - j) int64.
// 0 <= j, 1 <= jb <= 64, j + jb <= min(m, w); batch < 65536.  Launches nothing when no column lies outside the panel.
int dense_lu_swap_trsm(int dtype, void* a, long long batch_stride, int ld, int m, int w, int j, int jb, int batch,
                       const void* perm, void* stream) {
  if (dtype < 0 || dtype > 3 || j < 0 || jb < 1 || jb > MAX_WIDTH || j + jb > m || j + jb > w || ld < w ||
      batch < 1 || batch > 65535 || batch_stride < 0)
    return -1;
  if (swap_smem_bytes(m - j, jb, ITEMSIZE[dtype]) > MAX_SMEM_BYTES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_swap<float, float>(a, batch_stride, ld, m, w, j, jb, batch, perm, s);
    case 1: return launch_swap<double, double>(a, batch_stride, ld, m, w, j, jb, batch, perm, s);
    case 2: return launch_swap<Cx<float>, float>(a, batch_stride, ld, m, w, j, jb, batch, perm, s);
    default: return launch_swap<Cx<double>, double>(a, batch_stride, ld, m, w, j, jb, batch, perm, s);
  }
}

}  // extern "C"
