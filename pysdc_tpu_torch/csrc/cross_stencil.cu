// Kernel K1: periodic cross stencil on the last two axes of a batch of 2D fields:
//
//     out[b, i, j] = sum_k cx[k] * u[b, (i + ox[k]) mod nx, j]
//                  + sum_k cy[k] * u[b, i, (j + oy[k]) mod ny]
//
// i.e. y = sum_axis sum_s c_s * roll(u, -s, axis), the matrix-free apply of a
// 2D all-periodic separable FD operator with its scale folded into the taps.
//
// Replaces the Pallas TPU kernels of pysdc_tpu/ops/pallas/stencil.py:
// _cross2d_rows_db_kernel (row bands with double-buffered halo DMAs, the
// path the 2048^2 headline takes) and _cross2d_kernel (tile + halo window).
// Both compute this one function.
//
// Bound: bytes.  Each output reads 2*ntaps inputs but only one new value, so
// the least traffic is one read and one write of u: at 2048^2 float32 that is
// 33.5 MB, about 10 us at the 3.35 TB/s of an H100 SXM, against about 1 us of
// float32 arithmetic for the five-point Laplacian.  What a kernel can win is
// the share of that rate it sees: bytes in flight on every SM, 16-byte
// accesses, and no row read twice.
//
// Two paths; the wrapper (ops/kernels/stencil.py) picks one from the shape, the
// taps and the alignment alone:
//
// * bands (cross_stencil_bands_kernel) - the path of the package's centred
//   tables (offsets -r..r on each axis, r = 1, 2, 3: orders 2, 4, 6 of
//   ops/fd.py) on grids whose rows are a multiple of 16 bytes and at least one
//   band wide.  A warp owns a band of 32 lanes x 16 bytes of columns (128
//   float32, 64 float64) and band_rows rows and marches down it:
//     - rows arrive by cp.async (16 bytes a lane, the 2 ry columns beyond the
//       band's edges by a few 4- or 8-byte copies with the periodic wrap) into
//       a ring of row buffers in shared memory, PREFETCH rows ahead of the row
//       being consumed, so each warp keeps PREFETCH x 512 bytes in flight
//       whatever the compiler does with the arithmetic;
//     - the x taps (other rows, same columns) read a rolling window of
//       2 rx + 1 rows that each lane keeps in registers, so a row is read from
//       device memory once per band (overhead 2 rx / band_rows) and from
//       shared memory once;
//     - the y taps (same row, other columns) read the neighbouring lanes'
//       16-byte vectors of the centre row from its row buffer;
//     - tap counts are template parameters and the coefficients travel in the
//       kernel's own type, so the loops unroll and the taps are FMA operands;
//     - one 16-byte store a lane and row.  Only the row index of a band's
//       first row and the halo columns take a modulo.
//   Warps are independent (no block-wide barrier); a block holds BAND_WARPS of
//   them.  The summation order is the plain version's: x taps, then y taps.
//
// * general (cross_stencil_kernel) - every other case: rows that are not a
//   multiple of 16 bytes ((17, 33)), grids narrower than a band ((16, 16)),
//   radii beyond 3, tap tables that are not centred.  A block stages its
//   (TILE_R + 2 rx) x (TILE_C + 2 ry) window in shared memory, wrapping by
//   modular indexing, and every tap of every output in the tile reads shared
//   memory; taps travel in a by-value struct with runtime counts.
//
// C interface, loaded with ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// general path
// ---------------------------------------------------------------------------
constexpr int TILE_R = 32;    // rows of outputs per block
constexpr int TILE_C = 32;    // columns of outputs per block (one warp wide)
constexpr int BLOCK_Y = 8;    // threads per block: 32 x 8, each does 4 rows
constexpr int MAX_TAPS = 64;  // per axis; the tap table travels as a kernel argument

struct Taps {
  int nx_taps, ny_taps, rx, ry;
  int ox[MAX_TAPS];
  int oy[MAX_TAPS];
  double cx[MAX_TAPS];
  double cy[MAX_TAPS];
};

__device__ __forceinline__ int wrap(int g, int n) {
  if (g >= 0 && g < n) return g;
  g %= n;
  return g < 0 ? g + n : g;
}

template <typename T>
__global__ void __launch_bounds__(TILE_C * BLOCK_Y)
cross_stencil_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, Taps taps) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);

  const int rx = taps.rx, ry = taps.ry;
  const int wrows = TILE_R + 2 * rx;
  const int wcols = TILE_C + 2 * ry;
  const int row0 = blockIdx.y * TILE_R;
  const int col0 = blockIdx.x * TILE_C;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const T* ub = u + blockIdx.z * plane;
  T* ob = out + blockIdx.z * plane;

  // stage the window: each input of the tile and its halo is read once
  for (int r = threadIdx.y; r < wrows; r += BLOCK_Y) {
    const T* src = ub + static_cast<size_t>(wrap(row0 - rx + r, nx)) * ny;
    T* dst = tile + r * wcols;
    for (int c = threadIdx.x; c < wcols; c += TILE_C) dst[c] = src[wrap(col0 - ry + c, ny)];
  }
  __syncthreads();

  const int j = col0 + threadIdx.x;
  if (j >= ny) return;
  for (int r = threadIdx.y; r < TILE_R; r += BLOCK_Y) {
    const int i = row0 + r;
    if (i >= nx) break;
    const T* center = tile + (r + rx) * wcols + threadIdx.x + ry;
    // same summation order as the plain version: x taps, then y taps
    T acc = T(0);
    for (int k = 0; k < taps.nx_taps; ++k) acc += static_cast<T>(taps.cx[k]) * center[taps.ox[k] * wcols];
    for (int k = 0; k < taps.ny_taps; ++k) acc += static_cast<T>(taps.cy[k]) * center[taps.oy[k]];
    ob[static_cast<size_t>(i) * ny + j] = acc;
  }
}

template <typename T>
int launch(const void* u, void* out, int nb, int nx, int ny, const Taps& taps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TILE_R + 2 * taps.rx) * (TILE_C + 2 * taps.ry) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cross_stencil_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((ny + TILE_C - 1) / TILE_C, (nx + TILE_R - 1) / TILE_R, nb);
  const dim3 block(TILE_C, BLOCK_Y);
  cross_stencil_kernel<T><<<grid, block, smem, stream>>>(static_cast<const T*>(u), static_cast<T*>(out), nx, ny,
                                                          taps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bands path
// ---------------------------------------------------------------------------
constexpr int BAND_WARPS = 4;   // independent bands (warps) per thread block
constexpr int PREFETCH = 8;     // rows in flight ahead of the row being consumed
constexpr int MAX_RADIUS = 3;   // centred tables of 3, 5 and 7 taps an axis

template <typename T, int N>
struct alignas(16) Pack {
  T e[N];
};

template <typename T, int RX, int RY>
struct BandCoeffs {
  T cx[2 * RX + 1];
  T cy[2 * RY + 1];
};

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

// one element: 4 bytes (float) or 8 bytes (double)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem_dst, const T* gmem_src);

template <>
__device__ __forceinline__ void cp_async_elem<float>(float* smem_dst, const float* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

template <>
__device__ __forceinline__ void cp_async_elem<double>(double* smem_dst, const double* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int RX, int RY>
struct BandShape {
  static constexpr int VEC = 16 / sizeof(T);          // elements a lane moves at once
  static constexpr int CW = 32 * VEC;                 // columns of a full band
  static constexpr int NV = (RY + VEC - 1) / VEC;     // neighbour vectors a side for the y taps
  static constexpr int HP = NV * VEC;                 // halo room a side in a row buffer
  static constexpr int SLOT = HP + CW + HP;           // elements of one row buffer
  static constexpr int NS = PREFETCH + RX + 1;        // row buffers in a warp's ring
  static constexpr size_t SMEM = static_cast<size_t>(BAND_WARPS) * NS * SLOT * sizeof(T);
};

template <typename T, int RX, int RY>
__global__ void __launch_bounds__(BAND_WARPS * 32)
cross_stencil_bands_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int band_rows, int nrb,
                           int ncb, long long items, BandCoeffs<T, RX, RY> coef) {
  using S = BandShape<T, RX, RY>;
  constexpr int VEC = S::VEC, CW = S::CW, NV = S::NV, HP = S::HP, SLOT = S::SLOT, NS = S::NS;
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char band_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * BAND_WARPS + warp;
  if (item >= items) return;  // the whole warp leaves: no block-wide barrier below
  T* ring = reinterpret_cast<T*>(band_smem) + static_cast<size_t>(warp) * NS * SLOT;

  // item -> (plane b, row band rb, column band cb), column bands fastest
  const int cb = static_cast<int>(item % ncb);
  const long long rest = item / ncb;
  const int rb = static_cast<int>(rest % nrb);
  const long long b = rest / nrb;
  const int col0 = cb * CW;
  const int cw = min(CW, ny - col0);  // a multiple of VEC
  const int row0 = rb * band_rows;
  const int rows = min(band_rows, nx - row0);
  const size_t plane = static_cast<size_t>(nx) * ny;
  const T* ub = u + b * plane;
  const bool active = lane * VEC < cw;

  // the 2 RY columns beyond the band's edges: lane h < RY brings column
  // col0 - 1 - h, lane RY + h column col0 + cw + h, both modulo ny
  int hcol = 0, hpos = 0;
  if (lane < RY) {
    hcol = col0 - 1 - lane;
    hpos = HP - 1 - lane;
  } else if (lane < 2 * RY) {
    hcol = col0 + cw + (lane - RY);
    hpos = HP + cw + (lane - RY);
  }
  hcol %= ny;
  if (hcol < 0) hcol += ny;

  // rows row0 - RX .. row0 + rows - 1 + RX, modulo nx, arrive in this order
  const int total = rows + 2 * RX;
  int g = (row0 - RX) % nx;
  if (g < 0) g += nx;
  int started = 0, slot_in = 0;
  auto start_row = [&]() {
    if (started < total) {
      const T* src = ub + static_cast<size_t>(g) * ny;
      T* dst = ring + slot_in * SLOT;
      if (active) cp_async_16(dst + HP + lane * VEC, src + col0 + lane * VEC);
      if (lane < 2 * RY) cp_async_elem<T>(dst + hpos, src + hcol);
      if (++g == nx) g = 0;
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
    ++started;
    if (++slot_in == NS) slot_in = 0;
  };
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p) start_row();

  P w[2 * RX + 1];  // rolling window: rows c - 2 RX .. c of this lane's columns
#pragma unroll
  for (int k = 0; k <= 2 * RX; ++k) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[k].e[e] = T(0);
  }
  int slot_c = 0;          // buffer of row c
  int slot_mid = NS - RX;  // buffer of row c - RX, the centre row of the output
  T* orow = out + b * plane + static_cast<size_t>(row0) * ny + col0 + lane * VEC;

  for (int c = 0; c < total; ++c) {
    cp_async_wait<PREFETCH - 1>();  // row c has arrived (this lane's copies)
    __syncwarp();                   // ... and every other lane's; row c - RX - 1 is no longer read
    start_row();                    // row c + PREFETCH takes the buffer of row c - RX - 1
#pragma unroll
    for (int k = 0; k < 2 * RX; ++k) w[k] = w[k + 1];
    w[2 * RX] = *reinterpret_cast<const P*>(ring + slot_c * SLOT + HP + lane * VEC);
    if (c >= 2 * RX) {
      // v: the centre row from column lane*VEC - HP to lane*VEC + VEC + HP
      const T* mid = ring + slot_mid * SLOT + lane * VEC;
      T v[(2 * NV + 1) * VEC];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const P left = *reinterpret_cast<const P*>(mid + n * VEC);
        const P right = *reinterpret_cast<const P*>(mid + HP + VEC + n * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[n * VEC + e] = left.e[e];
          v[HP + VEC + n * VEC + e] = right.e[e];
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[HP + e] = w[RX].e[e];
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // same summation order as the plain version: x taps, then y taps
        T acc = T(0);
#pragma unroll
        for (int k = 0; k <= 2 * RX; ++k) acc += coef.cx[k] * w[k].e[e];
#pragma unroll
        for (int k = 0; k <= 2 * RY; ++k) acc += coef.cy[k] * v[HP + e + k - RY];
        o.e[e] = acc;
      }
      if (active) *reinterpret_cast<P*>(orow) = o;
      orow += ny;
    }
    if (++slot_c == NS) slot_c = 0;
    if (++slot_mid == NS) slot_mid = 0;
  }
}

template <typename T, int RX, int RY>
int launch_bands(const void* u, void* out, int nb, int nx, int ny, const double* cx, const double* cy, int band_rows,
                 cudaStream_t stream) {
  using S = BandShape<T, RX, RY>;
  BandCoeffs<T, RX, RY> coef;
  for (int k = 0; k <= 2 * RX; ++k) coef.cx[k] = static_cast<T>(cx[k]);
  for (int k = 0; k <= 2 * RY; ++k) coef.cy[k] = static_cast<T>(cy[k]);
  const int nrb = (nx + band_rows - 1) / band_rows;
  const int ncb = (ny + S::CW - 1) / S::CW;
  const long long items = static_cast<long long>(nb) * nrb * ncb;
  const long long blocks = (items + BAND_WARPS - 1) / BAND_WARPS;
  if (blocks > 0x7fffffffLL) return -1;
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  cross_stencil_bands_kernel<T, RX, RY><<<static_cast<unsigned int>(blocks), BAND_WARPS * 32, S::SMEM, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nx, ny, band_rows, nrb, ncb, items, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RX>
int launch_bands_ry(const void* u, void* out, int nb, int nx, int ny, const double* cx, int ry, const double* cy,
                    int band_rows, cudaStream_t stream) {
  switch (ry) {
    case 1: return launch_bands<T, RX, 1>(u, out, nb, nx, ny, cx, cy, band_rows, stream);
    case 2: return launch_bands<T, RX, 2>(u, out, nb, nx, ny, cx, cy, band_rows, stream);
    case 3: return launch_bands<T, RX, 3>(u, out, nb, nx, ny, cx, cy, band_rows, stream);
    default: return -1;
  }
}

template <typename T>
int launch_bands_rx(const void* u, void* out, int nb, int nx, int ny, int rx, const double* cx, int ry,
                    const double* cy, int band_rows, cudaStream_t stream) {
  switch (rx) {
    case 1: return launch_bands_ry<T, 1>(u, out, nb, nx, ny, cx, ry, cy, band_rows, stream);
    case 2: return launch_bands_ry<T, 2>(u, out, nb, nx, ny, cx, ry, cy, band_rows, stream);
    case 3: return launch_bands_ry<T, 3>(u, out, nb, nx, ny, cx, ry, cy, band_rows, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Constants the Python wrapper checks its arguments (and its own copies of
// the band geometry) against.
int cross_stencil_tile_rows() { return TILE_R; }
int cross_stencil_tile_cols() { return TILE_C; }
int cross_stencil_max_taps() { return MAX_TAPS; }
int cross_stencil_band_bytes() { return 32 * 16; }
int cross_stencil_band_max_radius() { return MAX_RADIUS; }
int cross_stencil_band_prefetch() { return PREFETCH; }

// Largest dynamic shared memory a block may opt into on the current device.
int cross_stencil_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

// General path.  dtype: 0 = float32, 1 = float64.  u, out: contiguous
// (nb, nx, ny) on the current device.  Offsets and coefficients are host arrays.
int cross_stencil_launch(int dtype, const void* u, void* out, int nb, int nx, int ny, int nx_taps, const int* ox,
                         const double* cx, int ny_taps, const int* oy, const double* cy, void* stream) {
  if (nx_taps < 0 || ny_taps < 0 || nx_taps > MAX_TAPS || ny_taps > MAX_TAPS) return -1;
  Taps taps{};
  taps.nx_taps = nx_taps;
  taps.ny_taps = ny_taps;
  for (int k = 0; k < nx_taps; ++k) {
    taps.ox[k] = ox[k];
    taps.cx[k] = cx[k];
    taps.rx = std::max(taps.rx, std::abs(ox[k]));
  }
  for (int k = 0; k < ny_taps; ++k) {
    taps.oy[k] = oy[k];
    taps.cy[k] = cy[k];
    taps.ry = std::max(taps.ry, std::abs(oy[k]));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, out, nb, nx, ny, taps, s);
  if (dtype == 1) return launch<double>(u, out, nb, nx, ny, taps, s);
  return -1;
}

// Bands path.  The taps of axis x are cx[0 .. 2 rx] at offsets -rx .. rx, those
// of axis y cy[0 .. 2 ry] at -ry .. ry (host arrays).  u, out: contiguous
// (nb, nx, ny), 16-byte aligned, ny * itemsize a multiple of 16 and at least
// one band (512 bytes); band_rows >= 1 rows a warp marches over.
int cross_stencil_bands_launch(int dtype, const void* u, void* out, int nb, int nx, int ny, int rx, const double* cx,
                               int ry, const double* cy, int band_rows, void* stream) {
  if (nb <= 0 || nx <= 0 || ny <= 0 || band_rows <= 0) return -1;
  if ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(out)) & 15) return -1;
  const int itemsize = dtype == 0 ? 4 : 8;
  if ((static_cast<long long>(ny) * itemsize) % 16 != 0 || ny * itemsize < 32 * 16) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bands_rx<float>(u, out, nb, nx, ny, rx, cx, ry, cy, band_rows, s);
  if (dtype == 1) return launch_bands_rx<double>(u, out, nb, nx, ny, rx, cx, ry, cy, band_rows, s);
  return -1;
}

}  // extern "C"
