// The Goldilocks NTT, INTT and coset LDE (K4) for Hopper.
//
// Replaces zk_circuits_tpu/ntt/ntt_mxu.py:167 (ntt_mxu, whose DFT-128
// steps run as exact bf16 limb matmuls, :122 _gf_dot_matrix), which the JAX
// package reaches through ntt/ntt.py:172 (_use_mxu) and :198 (ntt); it is
// no Pallas kernel.  Hopper multiplies u64 natively (four IMAD.WIDE.U32 a
// 64x64 product, csrc/goldilocks.cuh), so a matmul form has no reason here:
// K4 is a radix-2 transform in shared memory, and every NTT that
// ntt/ntt.py runs on a CUDA tensor is one call of it (ntt.cuh gives the
// formula, its modes and the index maps).
//
// Launches: the row path (n <= 2^13) is one launch, a block a tile of
// whole rows; the four-step (n up to 2^26, factors chosen by the wrapper)
// is two, pass A then pass B, through a (rows, n2, n1) scratch tensor.
// A block loads its tile (coset scaling and the LDE's zeros fused into
// the load), runs the stages between barriers, and stores (the four-step
// twiddle fused into pass A's store; the inverse's reversal, n^-1 and
// coset INTT scaling into the last store).  Shared memory: up to 97 KB a
// block (above 48 KB only after the per-launch opt-in below).
//
// Bound on the H100: bytes (the input read once, the output written
// once) or operations where the butterflies dominate: a product a
// butterfly whose twiddle is not 1, none in the LDE's first log2(rate)
// stages, which only copy, at 8 32-bit multiplies each (chip_smoke.py's
// k4_work and k4_time give both for each shape).
// What the design does about it: every global load and store has
// neighbouring threads on neighbouring addresses (pass A reads runs of R
// consecutive j1, pass B writes runs of R consecutive k2), the
// intermediate stages stay in shared memory, and the four-step's scratch
// is the only extra traffic.  Not yet done (speed is later work): radix-4
// or register-resident stages, skipping the zero half of the LDE's first
// stages, async copies.
#include <cuda_runtime.h>

#include "ntt.cuh"

__global__ void __launch_bounds__(K4_THREADS) k4_kernel(const __grid_constant__ K4Call c,
                                                        int pass) {
  extern __shared__ uint64_t k4_smem[];
  const K4Tile t = k4_tile(c, pass, blockIdx.x);
  k4_load(c, pass, t, k4_smem, threadIdx.x, blockDim.x);
  __syncthreads();
  for (int s = 0; s < t.log_len; s++) {
    k4_stage(c, t, k4_smem, s, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  k4_store(c, pass, t, k4_smem, threadIdx.x, blockDim.x);
}

static int k4_pass(const K4Call& c, int pass, cudaStream_t stream) {
  const long long blocks = k4_blocks(c, pass), elems = k4_smem_elems(c, pass);
  if (blocks >= (1LL << 31) || elems > K4_SMEM_MAX_ELEMS) return (int)cudaErrorInvalidValue;
  const int smem = (int)(elems * sizeof(uint64_t));
  // Above 48 KB only after opting in, which holds for the current device
  // alone: set it before every launch, on whichever card this one runs.
  cudaError_t e = cudaFuncSetAttribute(k4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(K4_SMEM_MAX_ELEMS * sizeof(uint64_t)));
  if (e != cudaSuccess) return (int)e;
  k4_kernel<<<(unsigned)blocks, K4_THREADS, smem, stream>>>(c, pass);
  return (int)cudaGetLastError();
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
