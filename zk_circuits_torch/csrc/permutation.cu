// The permutation argument's products over H (K6) for Hopper.
//
// Replaces the XLA program that the JAX package jits for the Z and
// partial-product values (zk_circuits_tpu/plonk/prover.py:266
// _zs_coeffs_body, jitted at :349); it is no Pallas kernel.  Eager torch
// ran its loop as ~15k launches a proof.  Here it is two kernels, two
// launches for a proof or a batch (permutation.cuh gives the formula),
// each a block a tile of 32 to 128 points of a proof (the proof on the
// grid's y; the wrapper sizes the tiles from the SM count: 256 blocks of
// 32 points at one wormhole proof, of 128 at B = 4):
//   k6_point_kernel: 10 warps, lane l on a run's point l, split the
//     (chunk, run of 32 points) pairs: every challenge's chunk products
//     into shared memory; then a thread a (point, challenge): one batch
//     inversion of the point's chunk denominators (Montgomery's trick with
//     zeros put as 1 and masked back), the running ratios into the
//     partial-product rows, the total into Z's row; the tile's product of
//     totals a challenge into the call's scratch;
//   k6_scan_kernel: a block of K6_SCAN_THREADS threads a tile: the earlier
//     tiles' product (each thread a strided share, then a tree), the
//     tile's scan, Z and the partial-product rows times Z in place, the
//     closing product from the last tile.
//
// Bound on the H100: bytes at one proof, the 32-bit multiply rate at B = 4
// (chip_smoke.py's k6_work: ~800 64x64 products a wormhole point for two
// challenges, 4 a routed wire a challenge and its 20 chunk denominators
// inverted as one batch with zeros masked, against ~1.4 KB of input and
// output).  The kernel inverts a (point, challenge)'s 10 as one batch, an
// inverse a challenge (~850 products a point).  The chunk products, 600 of
// them, take most of the point kernel's time, so a warp takes a chunk; the
// inverse chain of 73 dependent products about a sixth
// (scripts/k6_variants.py); a tile grows with the batch until the block's
// threads run all its chains at once.  The parent design (a thread a
// point, a Fermat inverse a chunk, and a scan block a proof and challenge:
// 2 blocks at one proof) took 0.216 ms a wormhole proof (PERF.md).
#include <cuda_runtime.h>

#include "permutation.cuh"

constexpr int K6_POINT_THREADS = 320;   // a warp a chunk of a 32-point tile
constexpr int K6_SCAN_THREADS = 256;

// The block's threads in the block functions' terms.
template <int T>
struct K6Block {
  __device__ __forceinline__ int threads() const { return T; }
  template <class F>
  __device__ __forceinline__ void each(F f) const { f((int)threadIdx.x); }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// Two blocks an SM (at most 102 registers).
template <int NC>
__global__ void __launch_bounds__(K6_POINT_THREADS, 2) k6_point_kernel(const K6Call c) {
  extern __shared__ uint64_t k6_smem[];
  K6Block<K6_POINT_THREADS> blk;
  k6_point_block<NC>(blk, c, blockIdx.y, blockIdx.x, k6_smem);
}

__global__ void __launch_bounds__(K6_SCAN_THREADS) k6_scan_kernel(const K6Call c) {
  __shared__ uint64_t sm[K6_MAX_CH * (K6_SCAN_THREADS + 3 * K6_MAX_TILE)];
  K6Block<K6_SCAN_THREADS> blk;
  k6_scan_block(blk, c, blockIdx.y, blockIdx.x, sm);
}

// Above 48 KB of shared memory only after opting in (for the current
// device: set before each such launch).
template <int NC>
static cudaError_t k6_launch_points(const K6Call& c, cudaStream_t stream) {
  const int smem = (int)(k6_point_smem(k6_chunks(c), NC, c.tile) * sizeof(uint64_t));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k6_point_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k6_point_kernel<NC><<<dim3((unsigned)k6_tiles(c), (unsigned)c.batch), K6_POINT_THREADS,
                        smem, stream>>>(c);
  return cudaGetLastError();
}

extern "C" {

// Launches the point kernel (step 0) or the scan (step 1) of one call on
// `stream` of `device`; returns 0 or the CUDA error code
// (cudaErrorInvalidValue for a call the kernels do not take).
int k6_products(int device, const K6Call* call, int step, void* stream_ptr) {
  const K6Call& c = *call;
  if (k6_valid(c) || K6_POINT_THREADS % k6_lanes(c.tile) || k6_tiles(c) >= (1LL << 31) ||
      step < 0 || step > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  cudaError_t err;
  if (step == 1) {
    k6_scan_kernel<<<dim3((unsigned)k6_tiles(c), (unsigned)c.batch), K6_SCAN_THREADS, 0,
                     stream>>>(c);
    err = cudaGetLastError();
  } else {
    switch (c.nc) {
      case 1: err = k6_launch_points<1>(c, stream); break;
      case 2: err = k6_launch_points<2>(c, stream); break;
      case 3: err = k6_launch_points<3>(c, stream); break;
      default: err = k6_launch_points<4>(c, stream); break;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}

// The size of the K6Call the library was built with.
int k6_call_size(void) { return (int)sizeof(K6Call); }

// The challenges a launch for `routed` wires in chunks of q at tiles of
// `tile` points (k6_max_ch), the point block's threads, and the SMs of
// `device` (the tiles are sized from these), or -1.
int k6_challenges(int routed, int q, int tile) { return k6_max_ch(routed, q, tile); }

// The point block's threads.
int k6_point_threads(void) { return K6_POINT_THREADS; }

int k6_sm_count(int device) {
  int sms = -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return sms;
}

}  // extern "C"
