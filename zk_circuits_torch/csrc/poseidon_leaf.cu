// Poseidon leaf sponge (hash_no_pad of every row) for Hopper.
//
// Replaces zk_circuits_tpu/hash/poseidon_pallas.py::_leaf_hash_kernel.
// One thread hashes one leaf row: the 12-lane state lives in registers as
// native u64 (no 2x32-bit limbs), the 360 round constants in __constant__
// memory (every thread reads the same one: a broadcast), and the MDS
// coefficients are compile-time immediates.  The input is addressed through
// (row_stride, col_stride): column-major LDE output (cols, n) has
// row_stride 1, so neighbouring threads read neighbouring addresses and the
// load is coalesced without a transpose; row-major (n, cols) leaves (FRI
// fold trees, PoW grind, Merkle compress levels) have row_stride = cols.
// Rows past n are masked, so any n is accepted.
//
// Bound: integer multiplies.  A row of c columns costs ceil(c/8)
// permutations of 118 S-boxes (4 full 64x64->128 products each) and 30 MDS
// layers, against 8c + 32 bytes of traffic, so the kernel sits far on the
// operations side of the roofline; the design spends no instructions on
// data movement beyond one load per input element and one store per digest
// element.
#include <cuda_runtime.h>

#include "poseidon.cuh"

__constant__ uint64_t POSEIDON_RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;

__global__ void __launch_bounds__(128)
poseidon_leaf_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                     long long n, int cols, long long row_stride, long long col_stride) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t* row = in + i * row_stride;
  uint64_t s[POSEIDON_WIDTH];
#pragma unroll
  for (int j = 0; j < POSEIDON_WIDTH; j++) s[j] = 0;
  for (int off = 0; off < cols; off += POSEIDON_RATE) {
    int chunk = cols - off < POSEIDON_RATE ? cols - off : POSEIDON_RATE;
#pragma unroll
    for (int j = 0; j < POSEIDON_RATE; j++)
      if (j < chunk) s[j] = __ldg(row + (long long)(off + j) * col_stride);
    poseidon_permute(s, POSEIDON_RC);
  }
#pragma unroll
  for (int j = 0; j < 4; j++) out[i * 4 + j] = gl_canon(s[j]);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int poseidon_leaf_hash(const uint64_t* in, uint64_t* out, long long n,
                                  int cols, long long row_stride, long long col_stride,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  poseidon_leaf_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, n, cols, row_stride, col_stride);
  return (int)cudaGetLastError();
}
