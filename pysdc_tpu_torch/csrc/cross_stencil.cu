// Periodic cross stencil on the last two axes of a batch of 2D fields:
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
// Both compute this one function; this kernel serves every grid size (odd
// sizes, 16x16 coarse levels, 1 x n) and any stencil radius, where the TPU
// kernels needed (8, 128)-aligned grids.
//
// Bound: bytes.  Each output reads 2*ntaps inputs but only one new value, so
// the least traffic is one read and one write of u: at 2048^2 float32 that is
// 33.5 MB, about 10 us at the 3.35 TB/s of an H100 SXM, against about 1 us of
// float32 arithmetic for the five-point Laplacian.  The design moves each
// input once from device memory: a block stages its (TILE_R + 2 rx) x
// (TILE_C + 2 ry) window in shared memory, wrapping periodically by modular
// indexing, and every tap of every output in the tile reads shared memory.
// The halo is re-read by the neighbouring block (2 rx / TILE_R + 2 ry /
// TILE_C extra, 1/8 for the five-point stencil, mostly served by L2).
// Consecutive threads load and store consecutive columns (coalesced).
//
// C interface, loaded with ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdlib>
#include <algorithm>

namespace {

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

}  // namespace

extern "C" {

// Constants the Python wrapper checks its arguments against.
int cross_stencil_tile_rows() { return TILE_R; }
int cross_stencil_tile_cols() { return TILE_C; }
int cross_stencil_max_taps() { return MAX_TAPS; }

// Largest dynamic shared memory a block may opt into on the current device.
int cross_stencil_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

// dtype: 0 = float32, 1 = float64.  u, out: contiguous (nb, nx, ny) on the
// current device.  Offsets and coefficients are host arrays.
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

}  // extern "C"
