// The port's dense LU from 512 rows: two kernels for one block of BLOCK (64) columns of LAPACK's blocked
// right-looking getrf, one CTA per matrix of the batch (lu_panel) or per matrix and range of tiles of columns
// (lu_swap_trsm).
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
//   lu_swap_trsm(a, batch_stride, ld, m, w, j, jb, per_cta, perm)
//     a      element (0, 0) of the first matrix, (batch, m, w) row-major with row stride ld;
//     j, jb  the block's first column and width; perm (batch, m - j) int64, what lu_panel returned for the panel
//            (rows j.. of columns j .. j + jb);
//     per_cta  tiles of SWAP_TILE columns a CTA owns (ops/kernels/dense_lu.py:swap_grid chooses it).
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
// Design of lu_swap_trsm: one CTA per matrix and range of per_cta tiles of SWAP_TILE (32) columns outside the
// panel, chosen on the host so that the grid fills the card (one CTA a matrix at a batch of 256 and 512 rows).  The
// rows a tile must rewrite form a closed set (the permutation is a bijection): left of the panel the moved rows,
// right of it the top jb rows and the moved rows below them, at most 2 jb.  The CTA lists the moved rows once (a
// ballot, in ascending order), then, for each tile, copies each such row's final value straight from its source row
// (final row r <- row P[r]) into shared memory with cp.async, all before any write: each byte is read once.  Right of
// the panel the top jb rows solve L11 U12 = A12 where they landed, and every row of the set is written once to its
// place.  L11 is loaded once per CTA (cp.async), by blocks of 8 x 8 in the order of the tensor cores' A operand
// (36 KB at jb 64 complex128): each unit lower diagonal block L_ee replaced by its inverse, each strict lower block
// L_ed by L_ee^-1 L_ed.  The substitution is blocked: rows 8 e .. 8 e + 8 of U12 are
// L_ee^-1 A12_e - sum_{d < e} (L_ee^-1 L_ed) U12_d, one sum of products a block, on the FP64 tensor cores for float64
// and complex128 (mma.sync m8n8k4, four real products a complex one, each into a sum of its own), on the CUDA cores
// with operands broadcast from shared memory for the float types; a warp owns 8 columns and needs no shuffle and no
// barrier of the CTA.  Only L11's diagonal blocks are inverted (8 x 8 unit lower triangles), never L11 itself.
// Warps are specialised: 4 substitute a tile while the other 4 write the tile before and load the next into a
// second buffer, so the copies are in flight while a tile solves.
// Bound, each byte once: the moved rows read and written left of the panel, the union of the moved rows and the top
// jb rows read and written right of it, L11's strict lower triangle once a matrix, against jb^2 / 2 multiply-adds a
// column right of the panel.  At a batch of 256 and 512 rows the kernel reads L11 once a matrix and each row once;
// where a matrix takes more than one CTA (small batches), each of them reads L11.  Measured (lu_probe.py timing): at
// 512 rows complex128 the CTAs take two waves and move their rows at about 2.4 TB/s; L11's prologue and the second
// wave's tail are most of what is left.
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
constexpr int IN_FLIGHT = 16;           // loads a thread issues before it stores the first (device memory latency)
constexpr int SWAP_TILE = 32;           // columns of a tile of lu_swap_trsm
constexpr int SOLVE_WARPS = SWAP_TILE / 8;  // its warps that substitute, 8 columns each; the others move rows
constexpr int MOVE_WARPS = WARPS - SOLVE_WARPS;
static_assert(SWAP_TILE == 32, "lu_swap_trsm moves a tile's row with a warp, a lane a column");

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

// lu_swap_trsm's shared memory: the header and the row lists (ints), L11 by blocks of 8 x 8 (the blocks on and
// below the diagonal, 64 entries each), two buffers of cap rows of a tile (swap_ld entries a row: 32 bytes of
// padding, so that the tensor cores' operand reads meet no bank twice)
__host__ __device__ inline int swap_ld(int itemsize) { return SWAP_TILE + 32 / itemsize; }
__host__ __device__ inline int l_blocks(int jb) { return (jb + 7) / 8 * ((jb + 7) / 8 + 1) / 2; }
__host__ __device__ inline int swap_int_bytes(int cap) {
  return ((16 + 2 * cap + MAX_WIDTH) * static_cast<int>(sizeof(int)) + 15) / 16 * 16;
}
size_t swap_smem_bytes(int rows, int jb, int itemsize) {
  const size_t cap = moved_cap(rows, jb);
  return swap_int_bytes(static_cast<int>(cap)) + static_cast<size_t>(l_blocks(jb)) * 64 * itemsize +
         2 * cap * swap_ld(itemsize) * itemsize;
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

// a 16-, 8- or 4-byte copy from device memory to shared memory that the thread does not wait for (cp.async; the
// 16-byte one past L1)
template <int N>
__device__ inline void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(N) : "memory");
  }
}
// wait for every copy_async of this thread
__device__ inline void wait_copies() { asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory"); }
// barriers of lu_swap_trsm's two kinds of warps (barrier 0 is __syncthreads)
__device__ inline void sync_movers() { asm volatile("bar.sync 1, %0;" ::"n"(MOVE_WARPS * 32) : "memory"); }
__device__ inline void sync_solvers() { asm volatile("bar.sync 2, %0;" ::"n"(SOLVE_WARPS * 32) : "memory"); }

// a + b * c, a complex one as four fused multiply-adds
__device__ inline float madd(float a, float b, float c) { return fmaf(b, c, a); }
__device__ inline double madd(double a, double b, double c) { return fma(b, c, a); }
template <typename R>
__device__ inline Cx<R> madd(Cx<R> a, Cx<R> b, Cx<R> c) {
  return {madd(madd(a.re, -b.im, c.im), b.re, c.re), madd(madd(a.im, b.im, c.re), b.re, c.im)};
}
__device__ inline void set_one(float& x) { x = 1.0f; }
__device__ inline void set_one(double& x) { x = 1.0; }
template <typename R>
__device__ inline void set_one(Cx<R>& x) { x = {R(1), R(0)}; }

// L11 (rows and columns 0 .. jb of `top`, from column j) into Lf by blocks of 8 x 8: block (e, d <= e) at
// e (e + 1) / 2 + d, in the order of the tensor cores' A operand (entry s * 32 + l is the block's element
// (l / 4, 4 s + l % 4)).  Diagonal block e holds the inverse of its unit lower triangle (an identity row past jb),
// block (e, d < e) that inverse times L's block: then U_e = L_ee^-1 X_e - sum_d (L_ee^-1 L_ed) U_d, one sum a block
// of 8 rows.  Run by the SOLVE_WARPS warps.
template <typename T>
__device__ void load_l11(T* Lf, const T* top, int ld, int j, int jb) {
  constexpr int SOLVE_THREADS = SOLVE_WARPS * 32;
  const int tid = threadIdx.x, nb = (jb + 7) / 8;
  for (int i = tid; i < l_blocks(jb) * 64; i += SOLVE_THREADS) {
    const int blk = i >> 6, l = i & 31, s = (i >> 5) & 1;
    int e = 0;
    while ((e + 1) * (e + 2) / 2 <= blk) ++e;
    const int r = 8 * e + (l >> 2), c = 8 * (blk - e * (e + 1) / 2) + 4 * s + (l & 3);
    if (c < r && r < jb) {
      copy_async<sizeof(T)>(Lf + i, top + static_cast<long long>(r) * ld + j + c);
    } else {
      T v{};
      if (c == r) set_one(v);
      Lf[i] = v;
    }
  }
  wait_copies();
  sync_solvers();
  // column c of diagonal block e's inverse, by substitution down the block
  {
    const int e = tid >> 3, c = tid & 7;
    T* D = Lf + (e < nb ? e * (e + 1) / 2 + e : 0) * 64;
    T x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = T{};
      if (i == c) set_one(x[i]);
#pragma unroll
      for (int k = 0; k < i; ++k) {
        if (e < nb && k >= c) x[i] = fms(x[i], D[(k >> 2) * 32 + 4 * i + (k & 3)], x[k]);
      }
    }
    sync_solvers();
    if (e < nb) {
#pragma unroll
      for (int i = 0; i < 8; ++i) D[(c >> 2) * 32 + 4 * i + (c & 3)] = x[i];
    }
    sync_solvers();
  }
  // column c of strict lower block o = e (e - 1) / 2 + d, times the inverse of diagonal block e
  for (int i = tid; i < (l_blocks(jb) - nb) * 8; i += SOLVE_THREADS) {
    const int o = i >> 3, c = i & 7;
    int e = 1;
    while (e * (e + 1) / 2 <= o) ++e;
    T* B = Lf + (e * (e + 1) / 2 + o - e * (e - 1) / 2) * 64;
    const T* D = Lf + (e * (e + 1) / 2 + e) * 64;
    T col[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) col[q] = B[(c >> 2) * 32 + 4 * q + (c & 3)];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      T v{};
#pragma unroll
      for (int q = 0; q <= r; ++q) v = madd(v, D[(q >> 2) * 32 + 4 * r + (q & 3)], col[q]);
      B[(c >> 2) * 32 + 4 * r + (c & 3)] = v;
    }
  }
}

// U12 = L11^-1 X in place on this warp's 8 columns of a tile (X the tile's top jb rows, row stride sld), a block of 8
// rows at a time: U_e = L_ee^-1 X_e - sum_{d < e} (L_ee^-1 L_ed) U_d with Lf as load_l11 leaves it.  FP64 tensor
// cores, an 8 x 4 by 4 x 8 product a step; a complex product as four real ones, each k-step and term into a sum of its
// own (8), so that no product waits for the one before it.  Rows past jb read as 0 and are not written.
template <typename T>
__device__ void solve_dmma(T* X, int sld, const T* Lf, int jb) {
  constexpr bool complex = sizeof(T) == 2 * sizeof(double);
  const int lane = threadIdx.x & 31, gr = lane >> 2, gk = lane & 3, nb = (jb + 7) / 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (e < nb) {
      const T* Le = Lf + e * (e + 1) / 2 * 64;
      double acc[2][4][2];  // [k-step][re += a x, re -= b y, im += a y, im += b x][the lane's two columns]
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[s][t][0] = acc[s][t][1] = 0.0;
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const T l = Le[(2 * e + s) * 32 + lane];
        const int k = 8 * e + 4 * s + gk;
        const T x = k < jb ? X[k * sld + gr] : T{};
        dmma(acc[s][0], re(l), re(x));
        if (complex) {
          dmma(acc[s][1], -im(l), im(x));
          dmma(acc[s][2], re(l), im(x));
          dmma(acc[s][3], im(l), re(x));
        }
      }
#pragma unroll
      for (int d = 0; d < e; ++d) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const T l = Le[(2 * d + s) * 32 + lane];
          const T x = X[(8 * d + 4 * s + gk) * sld + gr];
          dmma(acc[s][0], -re(l), re(x));
          if (complex) {
            dmma(acc[s][1], im(l), im(x));
            dmma(acc[s][2], -re(l), im(x));
            dmma(acc[s][3], -im(l), re(x));
          }
        }
      }
      __syncwarp();  // every lane has read X_e before U_e overwrites it
      const int r = 8 * e + gr;
      if (r < jb) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          set(X[r * sld + 2 * gk + i], (acc[0][0][i] + acc[1][0][i]) + (acc[0][1][i] + acc[1][1][i]),
              (acc[0][2][i] + acc[1][2][i]) + (acc[0][3][i] + acc[1][3][i]));
        }
      }
      __syncwarp();
    }
  }
}

// solve_dmma for the float types, on the CUDA cores: lane l takes column l % 8 and rows l / 8 and l / 8 + 4 of a
// block, each X entry it reads broadcast to the four lanes of its column
template <typename T>
__device__ void solve_scalar(T* X, int sld, const T* Lf, int jb) {
  const int lane = threadIdx.x & 31, c = lane & 7, i0 = lane >> 3, nb = (jb + 7) / 8;
  for (int e = 0; e < nb; ++e) {
    const T* Le = Lf + e * (e + 1) / 2 * 64;
    T acc[2] = {T{}, T{}};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const T x = 8 * e + k < jb ? X[(8 * e + k) * sld + c] : T{};
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[h] = madd(acc[h], Le[(2 * e + (k >> 2)) * 32 + 4 * (i0 + 4 * h) + (k & 3)], x);
    }
    for (int d = 0; d < e; ++d) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const T x = X[(8 * d + k) * sld + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) acc[h] = fms(acc[h], Le[(2 * d + (k >> 2)) * 32 + 4 * (i0 + 4 * h) + (k & 3)], x);
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (8 * e + i0 + 4 * h < jb) X[(8 * e + i0 + 4 * h) * sld + c] = acc[h];
    }
    __syncwarp();
  }
}

template <typename T, typename R>
__global__ void __launch_bounds__(THREADS) lu_swap_trsm_kernel(T* __restrict__ a, long long batch_stride, int ld,
                                                               int m, int w, int j, int jb,
                                                               const long long* __restrict__ perm, int left_tiles,
                                                               int tiles, int per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = m - j, cap = moved_cap(rows, jb), sld = swap_ld(sizeof(T)), buffer = cap * sld;
  int* counts = reinterpret_cast<int*>(smem);  // [1]: the moved rows above jb; [8 + v]: warp v's in a chunk
  int* moved = counts + 16;                     // the moved rows, ascending
  int* moved_src = moved + cap;                 // their sources P[moved[q]]
  int* top_src = moved_src + cap;               // P[r] of the top rows r < jb
  T* Lf = reinterpret_cast<T*>(smem + swap_int_bytes(cap));
  T* stage = Lf + l_blocks(jb) * 64;  // two buffers of cap rows of a tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* top = a + static_cast<long long>(blockIdx.y) * batch_stride + static_cast<long long>(j) * ld;  // row j
  const long long* P = perm + static_cast<long long>(blockIdx.y) * rows;
  const int t_lo = blockIdx.x * per_cta, t_hi = min(tiles, t_lo + per_cta);
  DL_START

  // the moved rows in ascending order, by a ballot a warp and chunk of THREADS rows (the same list at every call)
  int n_moved = 0;
  for (int base = 0; base < rows; base += THREADS) {
    const int r = base + tid;
    const long long src = r < rows ? P[r] : r;
    const bool mv = src != r;
    const unsigned ballot = __ballot_sync(0xffffffffu, mv);
    if (lane == 0) counts[8 + warp] = __popc(ballot);
    if (r < jb) top_src[r] = static_cast<int>(src);
    __syncthreads();
    int q = n_moved + __popc(ballot & ((1u << lane) - 1));
    for (int v = 0; v < WARPS; ++v) {
      if (v < warp) q += counts[8 + v];
      n_moved += counts[8 + v];
    }
    if (mv && q < cap) {
      moved[q] = r;
      moved_src[q] = static_cast<int>(src);
    }
    if (r == jb) counts[1] = q;
    __syncthreads();
  }
  n_moved = min(n_moved, cap);
  const int n_top = jb < rows ? min(counts[1], n_moved) : n_moved;
  DL_MARK

  // tile t: columns c_lo .. c_lo + wc left or right of the panel, and its n rows (a closed set): right of the panel
  // the top jb rows, then the moved rows below them; left of it the moved rows
  auto geometry = [&](int t, int& c_lo, int& wc, int& n) {
    const bool right = t >= left_tiles;
    c_lo = right ? j + jb + (t - left_tiles) * SWAP_TILE : t * SWAP_TILE;
    wc = min(right ? w : j, c_lo + SWAP_TILE) - c_lo;
    n = right ? min(cap, jb + n_moved - n_top) : n_moved;
    return right;
  };
  // row q of a tile's set: its source row, returned, and its final row dst (both from row j)
  auto row_of = [&](bool right, int q, int& dst) {
    if (right && q < jb) {
      dst = q;
      return top_src[q];
    }
    const int p = right ? n_top + q - jb : q;
    dst = moved[p];
    return moved_src[p];
  };
  // tile t's rows from their sources into buf, or from buf to their places, by warps first .. first + nwarps (the
  // calling warp among them), a warp a row and a lane a column (SWAP_TILE is 32)
  auto load = [&](int t, T* buf, int first, int nwarps) {
    int c_lo, wc, n, dst;
    const bool right = geometry(t, c_lo, wc, n);
    for (int q = warp - first; q < n; q += nwarps) {
      const T* from = top + static_cast<long long>(row_of(right, q, dst)) * ld + c_lo;
      if (lane < wc) copy_async<sizeof(T)>(buf + q * sld + lane, from + lane);
    }
  };
  auto store = [&](int t, const T* buf, int first, int nwarps) {
    int c_lo, wc, n, dst;
    const bool right = geometry(t, c_lo, wc, n);
    for (int q0 = warp - first; q0 < n; q0 += 4 * nwarps) {  // four rows' loads before their stores
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * nwarps;
        if (q < n && lane < wc) v[u] = buf[q * sld + lane];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * nwarps;
        if (q < n && lane < wc) {
          row_of(right, q, dst);
          top[static_cast<long long>(dst) * ld + c_lo + lane] = v[u];
        }
      }
    }
  };

  // the first SOLVE_WARPS warps substitute tile t in one buffer while the others write tile t - 1 from the other
  // buffer and load tile t + 1 into it
  const bool mover = warp >= SOLVE_WARPS;
  if (t_lo < t_hi) {
    if (mover) {
      load(t_lo, stage, SOLVE_WARPS, MOVE_WARPS);
      wait_copies();
    } else if (t_hi > left_tiles) {
      load_l11(Lf, top, ld, j, jb);
    }
  }
  __syncthreads();
  DL_MARK
  for (int t = t_lo; t < t_hi; ++t) {
    T* cur = stage + ((t - t_lo) & 1) * buffer;
    T* other = stage + ((t - t_lo + 1) & 1) * buffer;
    if (!mover) {
      int c_lo, wc, n;
      if (geometry(t, c_lo, wc, n) && 8 * warp < wc) {
        if constexpr (sizeof(R) == sizeof(double)) {
          solve_dmma(cur + 8 * warp, sld, Lf, jb);
        } else {
          solve_scalar(cur + 8 * warp, sld, Lf, jb);
        }
      }
      DL_MARK
    } else {
      if (t > t_lo) store(t - 1, other, SOLVE_WARPS, MOVE_WARPS);
      sync_movers();
      if (t + 1 < t_hi) load(t + 1, other, SOLVE_WARPS, MOVE_WARPS);
      wait_copies();
    }
    __syncthreads();
    DL_MARK
  }
  if (t_lo < t_hi) store(t_hi - 1, stage + ((t_hi - 1 - t_lo) & 1) * buffer, 0, WARPS);
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
int launch_swap(void* a, long long batch_stride, int ld, int m, int w, int j, int jb, int batch, int per_cta,
                const void* perm, cudaStream_t stream) {
  const int left = (j + SWAP_TILE - 1) / SWAP_TILE, tiles = left + (w - j - jb + SWAP_TILE - 1) / SWAP_TILE;
  if (tiles == 0) return 0;
  const size_t bytes = swap_smem_bytes(m - j, jb, sizeof(T));
  auto kernel = lu_swap_trsm_kernel<T, R>;
  const int err = opt_in(kernel, bytes);
  if (err != 0) return err;
  kernel<<<dim3((tiles + per_cta - 1) / per_cta, batch), THREADS, bytes, stream>>>(
      static_cast<T*>(a), batch_stride, ld, m, w, j, jb, static_cast<const long long*>(perm), left, tiles, per_cta);
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
// 0 <= j, 1 <= jb <= 64, j + jb <= min(m, w); batch < 65536; per_cta >= 1 tiles of SWAP_TILE columns a CTA.  Launches
// nothing when no column lies outside the panel.
int dense_lu_swap_trsm(int dtype, void* a, long long batch_stride, int ld, int m, int w, int j, int jb, int batch,
                       int per_cta, const void* perm, void* stream) {
  if (dtype < 0 || dtype > 3 || j < 0 || jb < 1 || jb > MAX_WIDTH || j + jb > m || j + jb > w || ld < w ||
      batch < 1 || batch > 65535 || batch_stride < 0 || per_cta < 1)
    return -1;
  if (swap_smem_bytes(m - j, jb, ITEMSIZE[dtype]) > MAX_SMEM_BYTES) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_swap<float, float>(a, batch_stride, ld, m, w, j, jb, batch, per_cta, perm, s);
    case 1: return launch_swap<double, double>(a, batch_stride, ld, m, w, j, jb, batch, per_cta, perm, s);
    case 2: return launch_swap<Cx<float>, float>(a, batch_stride, ld, m, w, j, jb, batch, per_cta, perm, s);
    default: return launch_swap<Cx<double>, double>(a, batch_stride, ld, m, w, j, jb, batch, per_cta, perm, s);
  }
}

}  // extern "C"
