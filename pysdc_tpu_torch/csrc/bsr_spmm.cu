// Kernel K3: block-sparse matrix (BSR with contiguous column segments) times a
// block of dense vectors:
//
//     Y[i*br + r, b] = sum_j sum_c blocks[i, j, r, c] * U[seg[i, j] + c, b]
//
// blocks (nb, kb, br, bc): the dense blocks of block row i; seg (nb, kb): the
// element offset of each block's column segment (padding blocks are zero);
// U (N, B) and Y (nb*br, B) row-major, B the collocation-node batch.
//
// Replaces the Pallas TPU kernel of pysdc_tpu/ops/pallas/spmv.py: bsr_spmm with
// _bsr_kernel (grid (nb, kb), the output block resident in VMEM while each
// (br, bc) x (bc, B) product runs on the MXU).  The segment starts are element
// offsets here; the TPU kernel divided them by bc for Mosaic's alignment proof.
//
// Bound: bytes.  The blocks dominate the traffic: nb*kb*br*bc*itemsize plus
// (N + N_rows)*B*itemsize for U and Y.  At the design point of bench.py
// (N = 65536, br = bc = 256, kb = 3, B = 4, float32) that is 201 MB, about
// 60 us at 3.35 TB/s, against 403 MFLOP (6 us at 67 TFLOP/s float32).  So the
// products run on the CUDA cores in float32 or float64 FMAs (no tensor cores,
// no TF32), and the design streams each block once, coalesced:
//   - a thread block takes ROWS rows of one block row and a chunk of up to
//     CHUNK batch columns; it first stages the kb column segments of U for
//     that chunk in shared memory (kb*bc values per column, padded to an odd
//     row pitch against bank conflicts);
//   - each warp takes one block row r at a time: its lanes read consecutive
//     entries blocks[i, j, r, c] (128-byte coalesced lines), multiply them
//     with the staged segment and keep the B partial sums in registers; a warp
//     shuffle reduces them and lane 0 writes Y[i*br + r, :].
// The block rows split into ceil(br / ROWS) thread blocks so that enough
// warps are in flight (at the design point: 1024 thread blocks on 132 SMs).
//
// C interface, loaded with ctypes; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;           // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;               // rows of a block row per thread block
constexpr int CHUNK = 8;               // batch columns per thread block

__host__ __device__ inline int pitch(int cols) { return cols | 1; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ seg, const T* __restrict__ U,
                T* __restrict__ Y, int kb, int br, int bc, int B, int groups) {
  extern __shared__ unsigned char smem_raw[];
  T* useg = reinterpret_cast<T*>(smem_raw);

  const int i = blockIdx.x / groups;           // block row
  const int r0 = (blockIdx.x % groups) * ROWS;  // first row of this thread block
  const int b0 = blockIdx.y * CHUNK;            // first batch column
  const int cols = min(CHUNK, B - b0);
  const int ld = pitch(cols);

  // stage the kb column segments of U for this column chunk:
  // useg[(j*bc + c)*ld + bb] = U[seg[i, j] + c, b0 + bb]
  const int per_block = bc * cols;
  for (int idx = threadIdx.x; idx < kb * per_block; idx += THREADS) {
    const int j = idx / per_block;
    const int rem = idx - j * per_block;
    const int c = rem / cols;
    const int bb = rem - c * cols;
    const long long row = static_cast<long long>(seg[static_cast<long long>(i) * kb + j]) + c;
    useg[(j * bc + c) * ld + bb] = U[row * B + b0 + bb];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r_end = min(r0 + ROWS, br);
  for (int r = r0 + warp; r < r_end; r += WARPS) {
    T acc[CHUNK];
#pragma unroll
    for (int bb = 0; bb < CHUNK; ++bb) acc[bb] = T(0);
    for (int j = 0; j < kb; ++j) {
      const T* brow = blocks + ((static_cast<long long>(i) * kb + j) * br + r) * bc;
      const T* us = useg + j * bc * ld;
      for (int c = lane; c < bc; c += 32) {
        const T a = brow[c];
        const T* uc = us + c * ld;
#pragma unroll
        for (int bb = 0; bb < CHUNK; ++bb) {
          if (bb < cols) acc[bb] += a * uc[bb];
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < CHUNK; ++bb) {
      T v = acc[bb];
      for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
      acc[bb] = v;
    }
    if (lane == 0) {
      T* yrow = Y + (static_cast<long long>(i) * br + r) * B + b0;
#pragma unroll
      for (int bb = 0; bb < CHUNK; ++bb) {
        if (bb < cols) yrow[bb] = acc[bb];
      }
    }
  }
}

template <typename T>
size_t smem_bytes(int kb, int bc, int B) {
  const int cols = B < CHUNK ? B : CHUNK;
  return static_cast<size_t>(kb) * bc * pitch(cols) * sizeof(T);
}

template <typename T>
int launch(const void* blocks, const int* seg, const void* U, void* Y, int nb, int kb, int br, int bc, int B,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(kb, bc, B);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bsr_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = (br + ROWS - 1) / ROWS;
  const dim3 grid(static_cast<unsigned int>(nb) * groups, (B + CHUNK - 1) / CHUNK);
  bsr_spmm_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(blocks), seg,
                                                      static_cast<const T*>(U), static_cast<T*>(Y), kb, br, bc,
                                                      B, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one thread block asks for (dtype: 0 = float32, 1 = float64).
long long bsr_spmm_smem_bytes(int dtype, int kb, int bc, int B) {
  if (dtype == 0) return static_cast<long long>(smem_bytes<float>(kb, bc, B));
  if (dtype == 1) return static_cast<long long>(smem_bytes<double>(kb, bc, B));
  return -1;
}

// Largest dynamic shared memory a block may opt into on the current device.
int bsr_spmm_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

// dtype: 0 = float32, 1 = float64.  blocks: contiguous (nb, kb, br, bc);
// seg: contiguous int32 (nb, kb); U: contiguous (N, B); Y: contiguous
// (nb*br, B); all on the current device.
int bsr_spmm_launch(int dtype, const void* blocks, const void* seg, const void* U, void* Y, int nb, int kb, int br,
                    int bc, int B, void* stream) {
  if (nb <= 0 || kb <= 0 || br <= 0 || bc <= 0 || B <= 0) return -1;
  if (static_cast<long long>(nb) * ((br + ROWS - 1) / ROWS) > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* segp = static_cast<const int*>(seg);
  if (dtype == 0) return launch<float>(blocks, segp, U, Y, nb, kb, br, bc, B, s);
  if (dtype == 1) return launch<double>(blocks, segp, U, Y, nb, kb, br, bc, B, s);
  return -1;
}

}  // extern "C"
