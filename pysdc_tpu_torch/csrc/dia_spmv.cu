// Kernel K2: sparse matrix times vector in diagonal (DIA) storage, over a
// batch of vectors:
//
//     y[b, i] = sum_j data[j, i] * u[b, i + off[j]]      for 0 <= i + off[j] < n
//
// data (k, n) holds the k diagonals of an FD matrix (data[j, i] = A[i, i + off[j]],
// zero where the entry does not exist); u and y are (nbatch, n), row-major.
//
// Replaces the Pallas TPU kernels of pysdc_tpu/ops/pallas/dia.py: dia_spmv with
// _dia_kernel_v2 (one grid step per output tile over a shared (i-1, i, i+1)
// window plus tile pairs for wrap diagonals) and _dia_kernel (grid (tiles, k)
// with scalar-prefetched whole-tile shifts).  Both compute this one function.
// The TPU blocking (128-lane tiles, window/wrap-pair split, padding to >= 3
// tiles) is not carried over: a read that would leave [0, n) is skipped, which
// equals the plain version's roll because the coefficient there is zero (a
// stored entry A[i, i + o] implies 0 <= i + o < n).
//
// Bound: bytes.  The least traffic reads the k diagonals and u once and writes
// y once, (k + 2 nbatch) * n * itemsize: at 1024^2, k = 5, float32 that is
// 29 MB at nbatch = 1 (8.8 us at 3.35 TB/s) against 10 n flops (0.16 us).
// Design: one thread per output index i, looping over the batch rows, so each
// coefficient is read from device memory once for the whole node batch and
// kept in registers (the number of diagonals is a template parameter).  Neighbouring threads read neighbouring i of every
// diagonal and of every shifted u (coalesced); the k shifted reads of u hit
// the same or nearby lines, served by L1/L2.  Offsets travel as a by-value
// argument struct, as K1's taps do.
//
// C interface, loaded with ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIAGS = 24;  // the JAX package's DIA.from_csr default max_diags
constexpr int THREADS = 256;

struct Offsets {
  int k;
  int off[MAX_DIAGS];
};

// K, the number of diagonals, is a template parameter: the coefficients of a
// row then live in K registers and the offsets' loop unrolls exactly.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
dia_spmv_kernel(const T* __restrict__ data, const T* __restrict__ u, T* __restrict__ y, int n, int nbatch,
                Offsets offs) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  // coefficients of row i, read once for all batch rows
  T d[K];
#pragma unroll
  for (int j = 0; j < K; ++j) d[j] = data[static_cast<long long>(j) * n + i];
  for (int b = 0; b < nbatch; ++b) {
    const T* ub = u + static_cast<long long>(b) * n;
    // same summation order as the plain version: diagonals in offset order
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = i + offs.off[j];
      if (c >= 0 && c < n) acc += d[j] * ub[c];
    }
    y[static_cast<long long>(b) * n + i] = acc;
  }
}

// launches the instantiation whose K equals offs.k (one per K in 1..MAX_DIAGS)
template <typename T, int K>
int launch_k(const void* data, const void* u, void* y, int n, int nbatch, const Offsets& offs, cudaStream_t stream) {
  if (offs.k == K) {
    const int blocks = (n + THREADS - 1) / THREADS;
    dia_spmv_kernel<T, K><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(data), static_cast<const T*>(u),
                                                           static_cast<T*>(y), n, nbatch, offs);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (K < MAX_DIAGS) {
    return launch_k<T, K + 1>(data, u, y, n, nbatch, offs, stream);
  } else {
    return -1;
  }
}

template <typename T>
int launch(const void* data, const void* u, void* y, int n, int nbatch, const Offsets& offs, cudaStream_t stream) {
  return launch_k<T, 1>(data, u, y, n, nbatch, offs, stream);
}

}  // namespace

extern "C" {

// Constant the Python wrapper checks its arguments against.
int dia_spmv_max_diags() { return MAX_DIAGS; }

// dtype: 0 = float32, 1 = float64.  data: contiguous (k, n); u, y: contiguous
// (nbatch, n), all on the current device.  off: host array of k offsets, each
// in (-n, n), so that i + off never overflows an int.
int dia_spmv_launch(int dtype, const void* data, const void* u, void* y, int n, int nbatch, int k, const int* off,
                    void* stream) {
  if (k < 1 || k > MAX_DIAGS || n <= 0 || n > 0x7fffffff - THREADS || nbatch <= 0) return -1;
  Offsets offs{};
  offs.k = k;
  for (int j = 0; j < k; ++j) {
    if (off[j] <= -n || off[j] >= n) return -1;
    offs.off[j] = off[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(data, u, y, n, nbatch, offs, s);
  if (dtype == 1) return launch<double>(data, u, y, n, nbatch, offs, s);
  return -1;
}

}  // extern "C"
