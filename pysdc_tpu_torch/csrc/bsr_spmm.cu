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
// no TF32), and what a kernel can win is the share of the memory rate it sees:
// a fixed, large amount of the block stream in flight on every SM.
//
// Two paths; the wrapper (ops/kernels/bsr.py) picks one from the shapes and the
// alignment alone:
//
// * stream (bsr_stream_kernel) - blocks whose rows are a multiple of 16 bytes,
//   16-byte aligned, with room for at least two slabs in shared memory.
//     - Persistent thread blocks, one per SM, each walking a contiguous range
//       of work items (block row i, group of R rows) in order, so one item's
//       reduction and store overlap the next items' copies and the U segments
//       are staged once per block row, not once per row group.
//     - blocks[i, j, r0:r0+R, :] is R*bc contiguous elements: one producer
//       thread brings each such slab with one cp.async.bulk (no tensor map)
//       into a ring of `stages` slabs; completion lands on an mbarrier (full),
//       and the consumer warps hand a slab back through a second one (empty).
//       With R*bc*itemsize = 32 KB and 4 stages, 128 KB are in flight per SM.
//     - Eight consumer warps take RW rows each (R = 8 RW; RW = 4 for float32,
//       2 for float64).  A lane reads 16 bytes of each of its rows and 16 bytes
//       of each batch column of the staged segment (kept transposed,
//       useg[b][j*bc + c], rows padded by 16 bytes, so both reads are free of
//       bank conflicts); every U vector serves RW rows.
//     - The batch chunk BT (1, 2, 4, 8) is a template parameter: RW*BT
//       accumulators a lane, no predicated FMAs.  B > 8 runs in chunks of 8
//       on grid.y, each streaming the blocks once.
//     - After the kb slabs of an item: butterfly shuffles, then lane
//       rr*BT + bb stores Y[row rr, column bb] (contiguous when B = BT).
//
// * general (bsr_spmm_kernel) - every other shape (bc*itemsize not a multiple
//   of 16, a misaligned base, slabs beyond shared memory).  A thread block
//   takes ROWS rows of one block row and a chunk of up to CHUNK batch columns,
//   stages the kb column segments of U for that chunk in shared memory (odd
//   row pitch against bank conflicts); each warp streams one row at a time with
//   coalesced 4- or 8-byte loads, keeps the partial sums in registers, reduces
//   them with shuffles and lane 0 writes Y[i*br + r, :].
//
// C interface, loaded with ctypes; each launcher returns cudaGetLastError().

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


// ---------------------------------------------------------------------------
// stream path
// ---------------------------------------------------------------------------
constexpr int S_WARPS = 8;                      // consumer warps
constexpr int S_THREADS = (S_WARPS + 1) * 32;   // plus the producer's warp
constexpr int S_MAX_STAGES = 4;                 // slabs in the ring, at most
constexpr int S_HEADER = 128;                   // bytes in front of the ring: the mbarriers

template <typename T, int N>
struct alignas(16) Pack {
  T e[N];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory to 16-byte
// aligned shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* gmem_src, uint32_t bytes, uint64_t* bar) {
  const uint64_t src = static_cast<uint64_t>(__cvta_generic_to_global(gmem_src));
  const uint32_t dst = smem_u32(smem_dst), mbar = smem_u32(bar);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :
               : "r"(dst), "l"(src), "r"(bytes), "r"(mbar)
               : "memory");
}

// barrier 1 over the consumer warps only (the producer's warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(S_WARPS * 32) : "memory");
}

template <typename T, int BT, int RW>
__global__ void __launch_bounds__(S_THREADS, 1)
bsr_stream_kernel(const T* __restrict__ blocks, const int* __restrict__ seg, const T* __restrict__ U,
                  T* __restrict__ Y, int kb, int br, int bc, int B, int groups, long long items, int stages) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = S_WARPS * RW;  // rows of a slab
  using P = Pack<T, VEC>;
  extern __shared__ __align__(128) unsigned char stream_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(stream_smem);
  uint64_t* empty = full + S_MAX_STAGES;
  T* slabs = reinterpret_cast<T*>(stream_smem + S_HEADER);
  const size_t slab_elems = static_cast<size_t>(R) * bc;
  const int K = kb * bc;
  const int Kp = K + VEC;  // 16 bytes of padding: batch column b starts 4 banks after column b - 1
  T* useg = slabs + stages * slab_elems;  // useg[bb * Kp + j * bc + c]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * CHUNK;
  const int cols = min(BT, B - b0);
  // this block's contiguous range of work items (block row i, row group g)
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, S_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == S_WARPS) {
    // producer: one thread keeps up to `stages` slabs in flight
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long item = first; item < last; ++item) {
        const long long i = item / groups;
        const int r0 = static_cast<int>(item % groups) * R;
        const uint32_t bytes = static_cast<uint32_t>(min(R, br - r0)) * bc * sizeof(T);
        for (int j = 0; j < kb; ++j) {
          mbar_wait(empty + stage, phase ^ 1u);  // passes at once on the first round
          mbar_expect_tx(full + stage, bytes);
          bulk_copy(slabs + stage * slab_elems, blocks + ((i * kb + j) * br + r0) * bc, bytes, full + stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  int stage = 0;
  uint32_t phase = 0;
  long long staged_row = -1;
  for (long long item = first; item < last; ++item) {
    const long long i = item / groups;
    const int r0 = static_cast<int>(item % groups) * R;
    if (i != staged_row) {
      // a new block row: stage its kb column segments of U, transposed and
      // zero-padded to BT columns
      consumer_sync();  // every warp is done with the previous segments
      for (int idx = threadIdx.x; idx < K * BT; idx += S_WARPS * 32) {
        const int jc = idx / BT, bb = idx - jc * BT;
        const int j = jc / bc, c = jc - j * bc;
        T val = T(0);
        if (bb < cols) val = U[(static_cast<long long>(seg[i * kb + j]) + c) * B + b0 + bb];
        useg[bb * Kp + jc] = val;
      }
      consumer_sync();
      staged_row = i;
    }

    T acc[RW][BT];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) acc[rr][bb] = T(0);
    }
    for (int j = 0; j < kb; ++j) {
      mbar_wait(full + stage, phase);
      const T* rows = slabs + stage * slab_elems + static_cast<size_t>(warp) * RW * bc;
      const T* us = useg + j * bc;
      for (int c = lane * VEC; c < bc; c += 32 * VEC) {
        P uv[BT];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) uv[bb] = *reinterpret_cast<const P*>(us + bb * Kp + c);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const P av = *reinterpret_cast<const P*>(rows + rr * bc + c);
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[rr][bb] += av.e[e] * uv[bb].e[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the slab
      if (++stage == stages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    // every lane gets the sums; lane rr*BT + bb keeps and stores Y[row rr, column bb]
    T mine = T(0);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        T v = acc[rr][bb];
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        if (lane == rr * BT + bb) mine = v;
      }
    }
    if (lane < RW * BT) {
      const int rr = lane / BT, bb = lane - rr * BT;
      const int r = r0 + warp * RW + rr;  // rows past br of a last, short slab hold stale data: not stored
      if (r < br && bb < cols) Y[(i * br + r) * B + b0 + bb] = mine;
    }
  }
}

template <typename T>
constexpr int stream_rw() {
  return sizeof(T) == 4 ? 4 : 2;
}

template <typename T, int BT>
int launch_stream_bt(const void* blocks, const int* seg, const void* U, void* Y, int nb, int kb, int br, int bc, int B,
                     int stages, int grid_x, cudaStream_t stream) {
  constexpr int RW = stream_rw<T>();
  constexpr int R = S_WARPS * RW;
  const int groups = (br + R - 1) / R;
  const long long items = static_cast<long long>(nb) * groups;
  const size_t smem = S_HEADER + static_cast<size_t>(stages) * R * bc * sizeof(T) +
                      static_cast<size_t>(BT) * (static_cast<size_t>(kb) * bc + 16 / sizeof(T)) * sizeof(T);
  auto kernel = bsr_stream_kernel<T, BT, RW>;
  // opt in to the shared memory once per device and size, not on every launch
  constexpr int MAX_DEVICES = 64;
  static size_t configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || configured[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) configured[dev] = smem;
  }
  const dim3 grid(static_cast<unsigned int>(grid_x), (B + CHUNK - 1) / CHUNK);
  kernel<<<grid, S_THREADS, smem, stream>>>(static_cast<const T*>(blocks), seg, static_cast<const T*>(U),
                                            static_cast<T*>(Y), kb, br, bc, B, groups, items, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stream(const void* blocks, const int* seg, const void* U, void* Y, int nb, int kb, int br, int bc, int B,
                  int stages, int grid_x, cudaStream_t stream) {
  const int widest = B < CHUNK ? B : CHUNK;  // the widest chunk of this launch
  if (widest <= 1) return launch_stream_bt<T, 1>(blocks, seg, U, Y, nb, kb, br, bc, B, stages, grid_x, stream);
  if (widest <= 2) return launch_stream_bt<T, 2>(blocks, seg, U, Y, nb, kb, br, bc, B, stages, grid_x, stream);
  if (widest <= 4) return launch_stream_bt<T, 4>(blocks, seg, U, Y, nb, kb, br, bc, B, stages, grid_x, stream);
  return launch_stream_bt<T, 8>(blocks, seg, U, Y, nb, kb, br, bc, B, stages, grid_x, stream);
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

// General path.  dtype: 0 = float32, 1 = float64.  blocks: contiguous (nb, kb, br, bc);
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

// Constants of the stream path, which the Python wrapper checks its own copies against.
int bsr_spmm_stream_warps() { return S_WARPS; }
int bsr_spmm_stream_max_stages() { return S_MAX_STAGES; }
int bsr_spmm_stream_header() { return S_HEADER; }
int bsr_spmm_chunk() { return CHUNK; }

// Streaming multiprocessors of the current device.
int bsr_spmm_sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  return count;
}

// Stream path.  As bsr_spmm_launch, with blocks 16-byte aligned and
// bc * itemsize a multiple of 16; `stages` slabs (2 .. 4) of 32 rows (float32)
// or 16 rows (float64) in the ring, `grid_x` persistent thread blocks.
int bsr_spmm_stream_launch(int dtype, const void* blocks, const void* seg, const void* U, void* Y, int nb, int kb,
                           int br, int bc, int B, int stages, int grid_x, void* stream) {
  if (nb <= 0 || kb <= 0 || br <= 0 || bc <= 0 || B <= 0 || grid_x <= 0) return -1;
  if (stages < 2 || stages > S_MAX_STAGES) return -1;
  const int itemsize = dtype == 0 ? 4 : 8;
  if ((reinterpret_cast<uintptr_t>(blocks) & 15) || (static_cast<long long>(bc) * itemsize) % 16 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* segp = static_cast<const int*>(seg);
  if (dtype == 0) return launch_stream<float>(blocks, segp, U, Y, nb, kb, br, bc, B, stages, grid_x, s);
  if (dtype == 1) return launch_stream<double>(blocks, segp, U, Y, nb, kb, br, bc, B, stages, grid_x, s);
  return -1;
}

}  // extern "C"
