// The witness schedule (K3) for Hopper.
//
// Replaces the XLA program of zk_circuits_tpu/iop/witness_device.py::
// _witness_body, which the JAX package runs in place of a Pallas kernel:
// the circuit's static schedule (iop/witness.py) run batch by batch over a
// table of representative values, then the wire cells and public inputs
// gathered from it.  Three kernels, each with the proof on the grid's y
// axis (values (B, R), wires (B, W, n) column-major per proof):
//   k3_ops:      one thread an op of one schedule batch (const, arith,
//                arith_ext, eq_inv, ext_inv, base_sum, random_access), one
//                launch a batch;
//   k3_poseidon: one thread a PoseidonGate of a batch: the swap deltas, the
//                permutation with its trace written into the gate's row,
//                the 12 outputs to their reps;
//   k3_cells:    the (cell, rep) scatter into the wire matrix (every wire
//                output of the schedule and every routed cell) and the
//                public inputs' gather.
//
// Bound: neither bytes nor multiplies (a wormhole witness moves ~10 MB and
// runs ~4e5 field products a proof: microseconds of either), but depth:
// the schedule's batches depend on each other, one launch each, and a
// Poseidon level is one permutation's 30 dependent rounds on a few dozen
// threads.  This first design keeps that shape (a launch a batch, one
// thread a gate); iop/witness_cuda.py times it against that depth.
#include <cuda_runtime.h>

#include "witness.cuh"

__constant__ uint64_t POSEIDON_RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;

constexpr int K3_THREADS = 256;
constexpr int K3_POSEIDON_THREADS = 64;

__global__ void __launch_bounds__(K3_THREADS)
k3_ops_kernel(int kind, long long m, const int64_t* in, int k_in, const int64_t* out,
              int k_out, const uint64_t* consts, int nbits, uint64_t* values,
              long long vstride) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m)
    k3_op(kind, m, i, in, k_in, out, k_out, consts, nbits, values + blockIdx.y * vstride);
}

__global__ void __launch_bounds__(K3_POSEIDON_THREADS)
k3_poseidon_kernel(long long m, const int64_t* in, const int64_t* out, const int64_t* rows,
                   uint64_t* values, long long vstride, uint64_t* wires, long long n,
                   int num_wires) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m)
    k3_poseidon_gate(i, in, out, rows, values + blockIdx.y * vstride,
                     wires + blockIdx.y * (long long)num_wires * n, n, POSEIDON_RC);
}

__global__ void __launch_bounds__(K3_THREADS)
k3_cells_kernel(long long ncells, const int64_t* cell_pos, const int64_t* cell_rep,
                long long npis, const int64_t* pi_rep, const uint64_t* values,
                long long vstride, uint64_t* wires, long long wstride, uint64_t* pis) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  k3_cell(t, ncells, cell_pos, cell_rep, npis, pi_rep, values + blockIdx.y * vstride,
          wires + blockIdx.y * wstride, pis + blockIdx.y * npis);
}

static dim3 k3_grid(long long work, int threads, int batch) {
  return dim3((unsigned)((work + threads - 1) / threads), (unsigned)batch);
}

extern "C" {

// Every function launches on `stream` and returns cudaGetLastError().

int k3_ops(int kind, long long m, const void* in, int k_in, const void* out, int k_out,
           const void* consts, int nbits, void* values, long long vstride, int batch,
           void* stream) {
  k3_ops_kernel<<<k3_grid(m, K3_THREADS, batch), K3_THREADS, 0, (cudaStream_t)stream>>>(
      kind, m, (const int64_t*)in, k_in, (const int64_t*)out, k_out, (const uint64_t*)consts,
      nbits, (uint64_t*)values, vstride);
  return (int)cudaGetLastError();
}

int k3_poseidon(long long m, const void* in, const void* out, const void* rows, void* values,
                long long vstride, void* wires, long long n, int num_wires, int batch,
                void* stream) {
  k3_poseidon_kernel<<<k3_grid(m, K3_POSEIDON_THREADS, batch), K3_POSEIDON_THREADS, 0,
                       (cudaStream_t)stream>>>(
      m, (const int64_t*)in, (const int64_t*)out, (const int64_t*)rows, (uint64_t*)values,
      vstride, (uint64_t*)wires, n, num_wires);
  return (int)cudaGetLastError();
}

int k3_cells(long long ncells, const void* cell_pos, const void* cell_rep, long long npis,
             const void* pi_rep, const void* values, long long vstride, void* wires,
             long long wstride, void* pis, int batch, void* stream) {
  k3_cells_kernel<<<k3_grid(ncells + npis, K3_THREADS, batch), K3_THREADS, 0,
                    (cudaStream_t)stream>>>(
      ncells, (const int64_t*)cell_pos, (const int64_t*)cell_rep, npis, (const int64_t*)pi_rep,
      (const uint64_t*)values, vstride, (uint64_t*)wires, wstride, (uint64_t*)pis);
  return (int)cudaGetLastError();
}

}  // extern "C"
