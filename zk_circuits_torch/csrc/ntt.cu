// The Goldilocks NTT, INTT and coset LDE (K4) for Hopper.
//
// Replaces zk_circuits_tpu/ntt/ntt_mxu.py:167 (ntt_mxu, whose DFT-128
// steps run as exact bf16 limb matmuls, :122 _gf_dot_matrix), which the JAX
// package reaches through ntt/ntt.py:172 (_use_mxu) and :198 (ntt); it is
// no Pallas kernel.  Hopper multiplies u64 natively (four IMAD.WIDE.U32 a
// 64x64 product, csrc/goldilocks.cuh), so a matmul form has no reason here,
// and every NTT that ntt/ntt.py runs on a CUDA tensor is one call of K4
// (ntt.cuh gives the formula, its modes, the index maps and the rounds).
//
// Launches: the row path (n <= 2^13; the wrapper sends it up to 2^12) is
// one launch, a block a tile of whole rows; the four-step (n up to 2^26,
// factors chosen by the wrapper) is two, pass A then pass B, through a
// (rows, n2, n1) scratch tensor.
// The wrapper sizes the tiles so that a pass launches four blocks an SM
// where the call has the columns (ntt_cuda.tiles, from the card's SM
// count), the four-step's tiles at least 4 columns wide.
// A thread holds 16 values in registers; a pass of 2^l points runs in
// ceil(l / 4) rounds, each a radix-16 DFT (one of them whatever radix is
// left) as radix-2 stages in registers, with one exchange through shared
// memory between rounds; a kernel a pass length, so that every index into
// a thread's values is a constant.  The coset scaling and the LDE's zeros
// fuse into the first round's loads (whose stages over zeros are
// skipped), the four-step twiddle and an INTT's n^-1 into pass A's store
// (running powers from two small tables), the inverse's reversal and the
// coset INTT's scaling into the last store.  Values stay in [0, 2^64) between stages; the store
// canonicalises.  Shared memory: 8 bytes a value and a slot in 16, up to
// 36 KB a block at the main path's shapes (71 KB at most, after the
// per-launch opt-in below).
//
// Bound on the H100: bytes (the input read once, the output written
// once) or operations: the products of this radix-16 decomposition (the
// inter-round and four-step twiddles that are not 1, the scalings; a
// product by a power of w_16 is a shift and counts nothing), at 8 32-bit
// multiplies each (chip_smoke.py's k4_work and k4_time give both for each
// shape; at every shape of the main path the bytes bound).  What the
// design does about it: every global load and store has neighbouring
// threads on neighbouring addresses (pass B's last round runs over
// columns, so that its stores fill whole sectors), the intermediate
// values cross shared memory once a round (not once a stage), and no
// stage, product or canonicalisation is spent on the LDE's zeros or
// between stages.  Measured, pass A is bound by integer instructions,
// pass B by its memory traffic below HBM's rate, a pass of few rows by
// latency (PERF.md).
#include <cuda_runtime.h>

#include "ntt.cuh"

// One thread of a block: its 16 values in registers, the block's tile and
// shared memory (k4_block runs the phases).
struct K4Thread {
  const K4Call& c;
  int pass;
  K4Tile t;
  uint64_t* sm;
  uint64_t v[K4_V];

  template <int B>
  __device__ __forceinline__ void begin() {
    k4_begin_r<B>(c, pass, t, v, threadIdx.x, blockDim.x);
  }
  template <int B>
  __device__ __forceinline__ void put(int r) {
    k4_put_r<B>(c, pass, t, sm, r, v, threadIdx.x, blockDim.x);
  }
  template <int B>
  __device__ __forceinline__ void get(int r) {
    k4_get_r<B>(c, pass, t, sm, r, v, threadIdx.x, blockDim.x);
  }
  template <int B>
  __device__ __forceinline__ void store() {
    k4_store_r<B>(c, pass, t, sm, v, threadIdx.x, blockDim.x);
  }
  __device__ __forceinline__ void flush() {
    k4_flush(c, pass, t, sm, v, threadIdx.x, blockDim.x);
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

// Blocks of 256 threads an SM that the kernel of a pass of 2^L points is
// built for, which caps its registers at 65536 / (256 blocks): four (64
// registers, some 80 bytes spilled) where the passes of the large LDEs
// need the warps for their instruction rate; three (up to 80, no spill)
// for the short passes of the 2^13 transforms (L <= 7), one wave of a few
// warps an SM that waits on each thread's own latency; one column of 2^13
// in 512 threads.
GL_HD constexpr int k4_min_blocks(int l) { return l > K4_TILE_MAX_LOG ? 1 : l <= 7 ? 3 : 4; }

// A pass of 2^L points, a block a tile: 256 threads at most, or one
// column of 2^13 in 512.
template <int L>
__global__ void __launch_bounds__(L > K4_TILE_MAX_LOG ? K4_MAX_THREADS : 256, k4_min_blocks(L))
    k4_kernel(const __grid_constant__ K4Call c, int pass) {
  extern __shared__ __align__(16) uint64_t k4_smem[];
  K4Thread th{c, pass, k4_tile(c, pass, blockIdx.x), k4_smem, {}};
  th.t.l = L;   // constants for the compiler from here on
  th.t.rounds = k4_rounds(L);
  k4_block<L>(th);
}

// Above 48 KB of shared memory only after opting in, which holds for the
// current device alone: set it before each such launch, on whichever card
// this one runs.
template <int L>
static cudaError_t k4_opt_in(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k4_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(K4_SMEM_MAX_ELEMS * sizeof(uint64_t)));
}

template <int L>
static void k4_launch(const K4Call& c, int pass, long long blocks, int smem,
                      cudaStream_t stream, cudaError_t* err) {
  *err = k4_opt_in<L>(smem);
  if (*err != cudaSuccess) return;
  k4_kernel<L><<<(unsigned)blocks, k4_threads(L, c.log_cols[pass]), smem, stream>>>(c, pass);
  *err = cudaGetLastError();
}

static int k4_pass(const K4Call& c, int pass, cudaStream_t stream) {
  const long long blocks = k4_blocks(c, pass), elems = k4_smem_elems(c, pass);
  if (blocks >= (1LL << 31) || elems > K4_SMEM_MAX_ELEMS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  K4_BY_LEN(k4_log_len(c, pass), k4_launch, c, pass, blocks,
            (int)(elems * sizeof(uint64_t)), stream, &err)
  return (int)err;
}

// Launches one call on `stream` of `device`: the row pass, or passes A
// and B.  Returns 0 or the CUDA error code (cudaErrorInvalidValue for a
// call the kernel does not take).
extern "C" int k4_ntt(int device, const K4Call* call, void* stream_ptr) {
  const K4Call& c = *call;
  if (!k4_valid(c)) return (int)cudaErrorInvalidValue;
  if (c.rows == 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  int err;
  if (c.log_n1 == 0) {
    err = k4_pass(c, K4_PASS_ROW, stream);
  } else {
    err = k4_pass(c, K4_PASS_A, stream);
    if (!err) err = k4_pass(c, K4_PASS_B, stream);
  }
  cudaSetDevice(prev);
  return err;
}

// The size of the K4Call the library was built with (the wrapper checks
// its ctypes mirror against it).
extern "C" int k4_call_size(void) { return (int)sizeof(K4Call); }

// The card's streaming multiprocessors (the wrapper's tile plan), or -1.
extern "C" int k4_sm_count(int device) {
  int n = 0;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess ? n
                                                                                          : -1;
}

template <int L>
static void k4_blocks_per_sm(int threads, int smem, int* n) {
  if (k4_opt_in<L>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, k4_kernel<L>, threads, smem) !=
          cudaSuccess)
    *n = -1;
}

// Blocks of `threads` threads and `smem` bytes of shared memory that one
// SM of `device` holds at once for a pass of 2^l points (chip_smoke.py
// prints it), or -1.
extern "C" int k4_occupancy(int device, int l, int threads, int smem) {
  int prev = 0, n = -1;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  if (l >= 0 && l <= K4_PASS_MAX_LOG) K4_BY_LEN(l, k4_blocks_per_sm, threads, smem, &n)
  cudaSetDevice(prev);
  return n;
}
