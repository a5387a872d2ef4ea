// The permutation argument's products over H (K6) for Hopper.
//
// Replaces the XLA program that the JAX package jits for the Z and
// partial-product values (zk_circuits_tpu/plonk/prover.py:266
// _zs_coeffs_body, jitted at :349); it is no Pallas kernel.  Eager torch
// ran its loop as ~15k launches a proof.  Here it is two kernels, two
// launches for a proof or a batch (permutation.cuh gives the formula):
//   k6_point_kernel: a thread a point of H of a proof (the proof on the
//     grid's y): every challenge's numerators and denominators from the
//     routed wires' values, sigmas and beta k_j x, the chunk products, a
//     Fermat inverse a chunk, the running ratios into the partial-product
//     rows and the total into Z's row;
//   k6_scan_kernel: a block of 1024 threads a (challenge, proof): the
//     exclusive prefix product of the totals over H (8 points a thread,
//     then a Hillis-Steele scan of the threads' products in shared
//     memory, tile by tile with a carry), Z in place, the partial-product
//     rows times Z, and the closing product.
//
// Bound on the H100: bytes.  The function needs ~800 64x64 products a
// wormhole point for two challenges (4 a routed wire a challenge, and
// its 20 chunk denominators inverted as one batch with zeros masked: 3
// products each and one 73-product chain) against ~1.4 KB of input and
// output (chip_smoke.py's k6_work).  This kernel spends a Fermat inverse
// (73 products) on each chunk instead, ~2.1k products a point: its own
// design cost, which keeps 1/0 = 0 without a mask.  The scan's blocks are
// few (B nc) and short; they are latency, not throughput.
#include <cuda_runtime.h>

#include "permutation.cuh"

constexpr int K6_POINT_THREADS = 128;
constexpr int K6_SCAN_THREADS = 1024;

template <int NC>
__global__ void __launch_bounds__(K6_POINT_THREADS) k6_point_kernel(const K6Call c) {
  __shared__ uint64_t bk[NC * PERM_MAX_ROUTED];
  perm_bk_table<NC>(c.kis, c.routed, c.betas, c.batch, blockIdx.y, bk, threadIdx.x,
                    K6_POINT_THREADS);
  __syncthreads();
  const long long i = (long long)blockIdx.x * K6_POINT_THREADS + threadIdx.x;
  if (i < c.n) k6_point<NC>(c, blockIdx.y, i, bk);
}

// The block's threads in k6_scan_block's terms.
struct K6Block {
  __device__ __forceinline__ int threads() const { return K6_SCAN_THREADS; }
  template <class F>
  __device__ __forceinline__ void each(F f) const { f((int)threadIdx.x); }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

__global__ void __launch_bounds__(K6_SCAN_THREADS) k6_scan_kernel(const K6Call c) {
  __shared__ uint64_t buf[2 * K6_SCAN_THREADS];
  K6Block blk;
  k6_scan_block(blk, c, blockIdx.y, blockIdx.x, buf);
}

template <int NC>
static cudaError_t k6_launch_points(const K6Call& c, cudaStream_t stream) {
  dim3 grid((unsigned)((c.n + K6_POINT_THREADS - 1) / K6_POINT_THREADS), (unsigned)c.batch);
  k6_point_kernel<NC><<<grid, K6_POINT_THREADS, 0, stream>>>(c);
  return cudaGetLastError();
}

extern "C" {

// Launches the point kernel (step 0) or the scan (step 1) of one call on
// `stream` of `device`; returns 0 or the CUDA error code
// (cudaErrorInvalidValue for a call the kernels do not take).
int k6_products(int device, const K6Call* call, int step, void* stream_ptr) {
  const K6Call& c = *call;
  if (k6_valid(c) || step < 0 || step > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  cudaError_t err;
  if (step == 1) {
    k6_scan_kernel<<<dim3((unsigned)c.nc, (unsigned)c.batch), K6_SCAN_THREADS, 0, stream>>>(c);
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

}  // extern "C"
