// The vanishing polynomial over the LDE coset (K5) for Hopper.
//
// Replaces the XLA program that the JAX package jits for the quotient
// (zk_circuits_tpu/plonk/prover.py:186 _quotient_commit_body, jitted at
// :230, over plonk/vanishing.py:161 eval_vanishing, :118
// _eval_permutation_terms_device and each gate's eval_device); it is no
// Pallas kernel.  Eager torch ran it as ~37k launches a proof, one a field
// operation.  Here it is one launch: a thread a coset point of a proof
// (the proof on the grid's y) evaluates the L1 term, the permutation
// argument's chunk terms and every gate type's constraints (quotient.cuh),
// reduces them by each challenge's alpha and multiplies by 1/Z_H(x).  It
// reads the commits' column-major LDE values where they lie (neighbouring
// threads on neighbouring points, no transpose) and writes (nc, B, points)
// in the layout the coset INTT takes, one launch a group of at most
// K5_MAX_CH challenges.  A block first builds its proof's powers of alpha
// and beta k_j in shared memory and copies the Poseidon round constants
// there (a block's threads read the same one at once).
//
// Bound on the H100: operations.  A wormhole point costs ~1.6k 64x64
// products (the Poseidon gate's 118 S-boxes, the permutation argument's
// 80 x 2 products a challenge, two a constraint a challenge for the fold)
// against ~2 KB of input and output, about 1.2 bytes a product, where the
// card's balance point is ~1.6 (3.35 TB/s against 2.1e12 products a
// second at 8 32-bit multiplies each; chip_smoke.py's k5_work).  What
// holds it below that bound is the latency of its dependent chains at 16
// warps an SM (quotient.cuh).  So the design spends no product it can
// avoid and keeps chains short: a chunk's first factor starts its
// product and its factors pair up, beta k_j is a table, powers of alpha
// are a table, the constraints go into unreduced sums of products with
// those powers, the MDS layer is the frequency-domain form (shifts and
// adds), and every value stays lazily reduced until the store; blocks of
// 256 threads at most 128 registers (__launch_bounds__(256, 2)).
#include <cuda_runtime.h>

#include "quotient.cuh"

__constant__ uint64_t K5_RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;

constexpr int K5_THREADS = 256;

// The first launch: the permutation argument, few registers (at most 85,
// three blocks an SM) so that many points' product chains are in flight.
template <int NC>
__global__ void __launch_bounds__(K5_THREADS, 3) k5_perm_kernel(const K5Call c) {
  __shared__ uint64_t am[NC];
  __shared__ uint64_t bk[NC * PERM_MAX_ROUTED];
  k5_perm_tables<NC>(c, blockIdx.y, am, bk, threadIdx.x, K5_THREADS);
  __syncthreads();
  const long long i = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
  if (i < c.points) k5_perm_point<NC>(c, blockIdx.y, i, am, bk);
}

// The second launch: the gates, at most 128 registers (two blocks an SM).
template <int NC>
__global__ void __launch_bounds__(K5_THREADS, 2) k5_gate_kernel(const K5Call c) {
  __shared__ uint64_t apow[NC * K5_MAX_POW];
  __shared__ uint64_t rc[POSEIDON_WIDTH * POSEIDON_ROUNDS];
  for (int k = threadIdx.x; k < POSEIDON_WIDTH * POSEIDON_ROUNDS; k += K5_THREADS)
    rc[k] = K5_RC[k];
  k5_alpha_table<NC>(c, blockIdx.y, apow, threadIdx.x, K5_THREADS);
  __syncthreads();
  const long long i = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
  if (i < c.points) k5_gate_point<NC>(c, blockIdx.y, i, apow, rc);
}

template <int NC>
static cudaError_t k5_launch(const K5Call& c, cudaStream_t stream) {
  dim3 grid((unsigned)((c.points + K5_THREADS - 1) / K5_THREADS), (unsigned)c.batch);
  k5_perm_kernel<NC><<<grid, K5_THREADS, 0, stream>>>(c);
  k5_gate_kernel<NC><<<grid, K5_THREADS, 0, stream>>>(c);
  return cudaGetLastError();
}

extern "C" {

// Launches one call (both kernels) on `stream` of `device`; returns 0 or
// the CUDA error code (cudaErrorInvalidValue for a call the kernels do not
// take).
int k5_vanishing(int device, const K5Call* call, void* stream_ptr) {
  const K5Call& c = *call;
  if (k5_valid(c)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  cudaError_t err;
  switch (c.nc) {
    case 1: err = k5_launch<1>(c, stream); break;
    case 2: err = k5_launch<2>(c, stream); break;
    case 3: err = k5_launch<3>(c, stream); break;
    default: err = k5_launch<4>(c, stream); break;
  }
  cudaSetDevice(prev);
  return (int)err;
}

// The size of the K5Call the library was built with (the wrapper checks
// its ctypes mirror against it).
int k5_call_size(void) { return (int)sizeof(K5Call); }

}  // extern "C"
