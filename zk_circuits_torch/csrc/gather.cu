// The FRI query gather (K10) for Hopper.
//
// Replaces the XLA programs that the JAX package jits for the query phase
// (zk_circuits_tpu/fri/fri_device.py:312 _gather_fn and :384
// _gather_batch_fn, called at :597 and :790): every oracle's and every
// commit-phase tree's query rows and sibling paths gathered into one flat
// buffer, fetched once.  It is no Pallas kernel.  Eager torch ran it as a
// take a leaf matrix and a level, each an index upload, an arange and an
// indexing kernel (265 device operations a wormhole proof, PERF.md); here it
// is one launch for every tree and proof of a call, after one upload of
// the descriptors and indices (gather.cuh gives the layout and the order).
// A row-sharded tree (the sharded prover's oracles and FRI trees, E
// pieces a leaf matrix and a level) is read where its shards lie: a row's
// piece and its local row come from the row by a shift and a mask, a piece
// on another card through its peer pointer, so the sharded proof's query
// phase is the same one launch.
//
// Launch: a row of blocks a tree (grid y), K10_THREADS threads a block, a
// thread an output word in a grid-stride loop over the tree's words;
// neighbouring threads store neighbouring words.
//
// Bound on the H100: neither bytes nor operations.  A wormhole proof
// gathers about 16k words: 0.13 MB read once and written once is 0.08 us at
// 3.35 TB/s (chip_smoke.py's gather_work), and the index arithmetic is a
// few dozen integer instructions a word.  The kernel is bound by its
// launch and by one dependent chain a word (the index, then the value), so
// the design keeps to one launch a call and one upload; it spends nothing
// on coalescing the reads, which land a leaf row or a digest apart.
#include <cuda_runtime.h>

#include "gather.cuh"

__global__ void __launch_bounds__(K10_THREADS) k10_kernel(const __grid_constant__ K10Call c) {
  k10_thread(c, blockIdx.y, blockIdx.x, threadIdx.x);
}

// Launches one call on `stream` of `device`.  Returns 0 or the CUDA error
// code (cudaErrorInvalidValue for a call the kernel does not take).
extern "C" int k10_gather(int device, const K10Call* call, void* stream_ptr) {
  const K10Call& c = *call;
  if (!k10_valid(c)) return (int)cudaErrorInvalidValue;
  if (c.total == 0) return 0;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  k10_kernel<<<dim3((unsigned)c.blocks, (unsigned)c.trees), K10_THREADS, 0,
               (cudaStream_t)stream_ptr>>>(c);
  const cudaError_t err = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)err;
}

// The size of the K10Call the library was built with (the wrapper checks
// its ctypes mirror against it), and of a tree's descriptor in words.
extern "C" int k10_call_size(void) { return (int)sizeof(K10Call); }
extern "C" int k10_desc_words(void) { return (int)K10_DESC; }
