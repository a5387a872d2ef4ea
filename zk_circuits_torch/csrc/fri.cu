// The openings' and FRI's field arithmetic (K7, K8, K9) for Hopper.
//
// Replaces the XLA programs that the JAX package jits for FRI
// (zk_circuits_tpu/fri/fri_device.py): the openings (_make_openings_run
// :158, jitted :173 and :181), the composition without its round-0 NTT and
// commit (_make_compose_run :193: _reduce_alpha :70 and _ddl :96, jitted
// :227, :237, :246) and the fold (_fold_dev :136 in _make_fold_commit_run
// :255 and _final_fold_fn :289).  None is a Pallas kernel.  Eager torch
// ran them as ~11.4k launches a proof; here they are six kernels (fri.cuh
// gives the formulas and what bounds each), six launches for a proof or a
// batch of the wormhole (K7 one, K8 three, K9 one a fold round):
//   k7_kernel: a block of 256 threads a (tile of coefficients, group of up
//     to 32 rows of one point, proof), tiles sized from the SM count
//     (fri_cuda.openings_shape): the tile's powers of the point once for
//     the group's rows, each row's sum over the tile as unreduced
//     multiply-adds a lane and a warp's shuffles, the tile's row sums to a
//     scratch; the last block of a (proof, group) to finish adds the
//     tiles' sums (a counter a group, after a fence).  The oracles are
//     read in place (no concatenation, the shared constants/sigmas oracle
//     once for the batch);
//   k8_point_kernel: a block of 8 warps a tile of 32 points of a proof:
//     the warps split the rows (both alpha reductions over the same rows
//     as K7), 8 rows' loads in flight a lane, the warps' sums added in
//     shared memory;
//     alpha^e = alpha^(e mod 32) alpha^(32 (e div 32)) in shared memory;
//   k8_seg_kernel, k8_finish_kernel: a block of 256 threads a segment of
//     256 points of a proof: each segment's Horner sum, then the later
//     segments' part and the scan within the segment, both divisions by a
//     linear factor and the sum with alpha^nz, f padded with its zero, with
//     no inverse (the proof's z^(2^k) from the first launch's block 0);
//   k9_round_kernel<L> (every fold round but the last, the whole of
//     _make_fold_commit_run but its Merkle levels): a block of 256
//     threads (512 at 2^13 points) a (coset, component, proof) of the next
//     codeword: the lane-parallel fold of its share of f, the other
//     shares of its cluster of cosets read from their blocks' shared
//     memory, x_i = f_i times the coset's powers, radix-8 rounds of K4's
//     DFTs (ntt.cuh) over the 2^L points in shared memory, each value
//     stored at its fiber-leaf slot;
//   k9_fold_kernel (the last round, and the sharded path's fold of a
//     shard): a block of 128 threads, the lane-parallel fold alone.
// K9's betas ride in the launch's parameters (up to K9_MAX_BATCH proofs a
// launch): a round uploads nothing.
//
// Bound on the H100 (chip_smoke.py's fri_work): K7 and K8's point kernel by
// bytes, each reads every oracle row once (267 x 2^13 x 8 B = 17.5 MB a
// wormhole proof) against two products a coefficient; they stream it with
// neighbouring threads on neighbouring coefficients.  K7's powers cost
// a block one extension product a coefficient for up to 32 rows (its
// parent built them once a row: 0.0496 ms a wormhole proof, PERF.md).
// K8's scan and K9 move under 0.4 MB a proof: their time is latency (a
// few thousand threads, a few dozen dependent extension products each).
// K9's fold was a thread an output running Horner's rule over the arity
// (15 dependent extension products at arity 16, loads 128 B apart); its
// lanes now take one coefficient each and meet in log2 A levels of adds,
// and a round's NTT runs 2^rate_bits blocks a component where K4's row
// path gave the 2^12-point codeword two.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fri.cuh"

namespace cg = cooperative_groups;

constexpr int K7_THREADS = 256;
constexpr int K8_SEG_THREADS = 1 << K8_LOG_SEG;

// A block of T threads in the block functions' terms (fri.cuh): one
// object a thread, whose regs() are its registers across the phases.
template <int T>
struct FriBlock {
  static_assert(K9_REGS >= 2 * K9_UNROLL, "a lane's outputs fit its registers");
  uint64_t r[K9_REGS];
  __device__ __forceinline__ int threads() const { return T; }
  __device__ __forceinline__ uint64_t* regs(int) { return r; }
  template <class F>
  __device__ __forceinline__ void each(F f) const { f((int)threadIdx.x); }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // f's K values of each thread summed over its warp by shuffles; g at lane 0
  template <int K, class F, class G>
  __device__ __forceinline__ void warp_sum(F f, G g) const {
    uint64_t v[K];
    f((int)threadIdx.x, v);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
#pragma unroll
      for (int k = 0; k < K; k++)
        v[k] = gl_add_lazy(v[k], __shfl_xor_sync(0xffffffffu, v[k], d));
    if ((threadIdx.x & 31) == 0) g((int)threadIdx.x, v);
  }
  // f's K values summed over each aligned group of 2^lb lanes (lb <= 5) by
  // shuffles; g at the group's first lane
  template <int K, class F, class G>
  __device__ __forceinline__ void group_sum(int lb, F f, G g) const {
    uint64_t v[K];
    f((int)threadIdx.x, v);
    for (int d = (1 << lb) >> 1; d >= 1; d >>= 1)
#pragma unroll
      for (int k = 0; k < K; k++)
        v[k] = gl_add_lazy(v[k], __shfl_xor_sync(0xffffffffu, v[k], d));
    if ((threadIdx.x & ((1 << lb) - 1)) == 0) g((int)threadIdx.x, v);
  }
};

// Three blocks an SM (at most 85 registers): one wave of K7's blocks at
// openings_shape's sizes.
__global__ void __launch_bounds__(K7_THREADS, 3) k7_kernel(const __grid_constant__ K7Call c) {
  extern __shared__ uint64_t k7_smem[];
  FriBlock<K7_THREADS> blk;
  k7_block(blk, c, blockIdx.z, blockIdx.x, blockIdx.y, k7_smem);
}

__global__ void __launch_bounds__(K8_PT_THREADS)
    k8_point_kernel(const __grid_constant__ K8Call c) {
  __shared__ uint64_t sm[K8_PT_SMEM];
  FriBlock<K8_PT_THREADS> blk;
  k8_point_block(blk, c, blockIdx.y, blockIdx.x, sm);
}

__global__ void __launch_bounds__(K8_SEG_THREADS)
    k8_seg_kernel(const __grid_constant__ K8ScanCall c) {
  __shared__ uint64_t sm[4 * K8_SEG_THREADS + 4 * K8_LOG_SEG];
  FriBlock<K8_SEG_THREADS> blk;
  k8_seg_block<K8_LOG_SEG>(blk, c, blockIdx.y, blockIdx.x, sm);
}

__global__ void __launch_bounds__(K8_SEG_THREADS)
    k8_finish_kernel(const __grid_constant__ K8ScanCall c) {
  __shared__ uint64_t sm[12 * K8_SEG_THREADS + 4 * K8_ZTAB];
  FriBlock<K8_SEG_THREADS> blk;
  k8_finish_block<K8_LOG_SEG>(blk, c, blockIdx.y, blockIdx.x, sm);
}

__global__ void __launch_bounds__(K9_FOLD_THREADS)
    k9_fold_kernel(const __grid_constant__ K9Call c) {
  FriBlock<K9_FOLD_THREADS> blk;
  k9_fold_block(blk, c, blockIdx.y, blockIdx.x);
}

// The round mode at 2^L points a coset: block (coset, component, proof)
// folds its share, meets its group's shares (a cluster's distributed shared
// memory, or its own where the group is one block), then runs the NTT's
// rounds (k9_ntt, K4's DFTs) over the column and stores the leaves.  The
// cluster's second barrier is split: a block arrives once its reads of
// the others' shares are done, and waits before it leaves.
template <int L>
__global__ void __launch_bounds__(k9_round_threads(L), 1)
    k9_round_kernel(const __grid_constant__ K9RoundCall c) {
  extern __shared__ uint64_t k9_smem[];
  FriBlock<k9_round_threads(L)> blk;
  const int coset = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  k9_round_prefetch(blk, c, coset, k9_smem);
  k9_round_fold(blk, c, b, y, coset, k9_smem);
  fri_copy_wait();
  const uint64_t* shares[1 << K9_MAX_GROUP_LOG];
  cg::cluster_group cluster = cg::this_cluster();
  if (c.group_log) {
    cluster.sync();   // every share written
    for (int r = 0; r < (1 << c.group_log); r++) shares[r] = cluster.map_shared_rank(k9_smem, r);
  } else {
    __syncthreads();
    shares[0] = k9_smem;
  }
  k9_round_gather(blk, c, shares, k9_smem);
  if (c.group_log) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  k9_ntt<L, 0>(blk, c, k9_smem, b, y, coset);
  if (c.group_log) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

static unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Runs `launch` on `device` and returns its cudaGetLastError.
template <class F>
static int on_device(int device, F launch) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  launch();
  const cudaError_t err = cudaGetLastError();
  cudaSetDevice(prev);
  return (int)err;
}

template <int L>
static void k9_round_launch(const K9RoundCall& c, int smem, cudaStream_t stream,
                            cudaError_t* err) {
  *err = cudaFuncSetAttribute(k9_round_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
  if (*err != cudaSuccess) return;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << c.rate_bits, 2, (unsigned)c.batch);
  cfg.blockDim = dim3(k9_round_threads(L));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << c.group_log;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c.group_log ? 1 : 0;
  *err = cudaLaunchKernelEx(&cfg, k9_round_kernel<L>, c);
}

extern "C" {

// Each launches its kernel once on `stream` of `device` and returns 0 or
// the CUDA error code (cudaErrorInvalidValue for a call the kernel does
// not take).
int k7_openings(int device, const K7Call* call, void* stream) {
  const K7Call& c = *call;
  const int smem = k7_smem(c.tile, c.group) * (int)sizeof(uint64_t);
  if (k7_valid(c) || smem > 48 * 1024 || k7_tiles(c) >= (1LL << 31) || k7_groups(c) > 65535)
    return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    k7_kernel<<<dim3((unsigned)k7_tiles(c), (unsigned)k7_groups(c), (unsigned)c.r.batch),
                K7_THREADS, smem, (cudaStream_t)stream>>>(c);
  });
}

int k8_reduce(int device, const K8Call* call, void* stream) {
  const K8Call& c = *call;
  if (k8_valid(c)) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    k8_point_kernel<<<dim3(blocks(c.r.n, K8_PT_TILE), (unsigned)c.r.batch), K8_PT_THREADS, 0,
                      (cudaStream_t)stream>>>(c);
  });
}

// Both of the scan's launches (seg, then finish) on `stream`.
int k8_scan(int device, const K8ScanCall* call, void* stream) {
  const K8ScanCall& c = *call;
  if (k8_scan_valid(c)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)k8_segs(c.n, K8_LOG_SEG), (unsigned)c.batch);
  return on_device(device, [&] {
    k8_seg_kernel<<<grid, K8_SEG_THREADS, 0, (cudaStream_t)stream>>>(c);
    k8_finish_kernel<<<grid, K8_SEG_THREADS, 0, (cudaStream_t)stream>>>(c);
  });
}

// K7's row groups of a call (the blocks of a tile of coefficients).
int k7_row_groups(const K7Call* call) { return k7_groups(*call); }

// The SMs of `device` (K7's tiles are sized from it), or -1.
int fri_sm_count(int device) {
  int sms = -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return sms;
}

// u64 of a K8ScanCall's scratch for n points and `batch` proofs.
long long k8_scan_scratch(long long n, int batch) {
  return k8_scratch_words(n, batch, K8_LOG_SEG);
}

int k9_fold(int device, const K9Call* call, void* stream) {
  const K9Call& c = *call;
  const long long nb = k9_fold_blocks(c, K9_FOLD_THREADS);
  if (k9_valid(c) || nb >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    k9_fold_kernel<<<dim3((unsigned)nb, (unsigned)c.batch), K9_FOLD_THREADS, 0,
                     (cudaStream_t)stream>>>(c);
  });
}

// One launch of the round mode: a block a (coset, component, proof), in
// clusters of 2^group_log cosets.
int k9_round(int device, const K9RoundCall* call, void* stream) {
  const K9RoundCall& c = *call;
  const long long smem = k9_round_smem(c) * (long long)sizeof(uint64_t);
  if (k9_round_valid(c) || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int code = on_device(device, [&] {
    K4_BY_LEN(c.log_m, k9_round_launch, c, (int)smem, (cudaStream_t)stream, &err)
  });
  return err != cudaSuccess ? (int)err : code;
}

// The sizes of the calls the library was built with: K7Call, K8Call,
// K8ScanCall, K9Call, K9RoundCall for kind 0-4.
int fri_call_size(int kind) {
  switch (kind) {
    case 0: return (int)sizeof(K7Call);
    case 1: return (int)sizeof(K8Call);
    case 2: return (int)sizeof(K8ScanCall);
    case 3: return (int)sizeof(K9Call);
    case 4: return (int)sizeof(K9RoundCall);
    default: return -1;
  }
}

}  // extern "C"
