// Block all-to-all over E shards (K2) for Hopper.
//
// Replaces zk_circuits_tpu/parallel/ntt_exchange.py:52 (_exchange_kernel):
// afterwards shard d holds out_d[s] = x_s[d] for every source shard s, the
// transpose of the two leading axes of a global (E, E, B) tensor.  The
// four-step NTT runs three per transform; a poly->row re-shard of a commit
// and the FRI fiber regroup run one each.
//
// Layout.  Source shard s hands a (E, rows, row_len) view: block d (the one
// destination d receives) starts at element d * blk_stride, its rows lie
// row_stride apart, each row is row_len contiguous elements.  The
// four-step's blocks are contiguous (rows = 1); the commit re-shard reads
// values_s[:, rows of d] of a (k/E, 8n) column-major LDE in place through
// row_stride = 8n, so no local permute is made first.  Destination d
// writes out_d (E, rows, row_len) contiguously.
//
// One launch serves every destination shard that lives on one device:
// blockIdx.y walks (destination, source) pairs, blockIdx.z the rows,
// blockIdx.x the row.  The kernel pulls: sources on other cards are read
// through peer pointers over NVLink (the wrapper enables peer access);
// shards on the launching card are plain local pointers.  The TPU kernel's
// start barrier and DMA semaphores become stream order in the wrapper
// (events between the source and destination streams), so nothing here
// waits on a flag.
//
// Bound: bytes.  Each element is read once and written once and nothing
// is computed, so the least time is 2 * E * E * B * 8 bytes over the HBM
// rate on one card, or (E-1)/E of each shard's bytes over NVLink across
// cards.  The design moves 16 bytes per thread (ulonglong2) with
// neighbouring threads on neighbouring addresses whenever every block row
// starts 16-byte aligned (even row_len, strides and base pointers), and 8
// bytes per thread otherwise; the ragged end of each row is masked by the
// loop bound.  No shared memory, no synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

#define BX_MAX_SHARDS 32

struct BxArgs {
  const uint64_t* src[BX_MAX_SHARDS];   // source shard s's view base
  uint64_t* dst[BX_MAX_SHARDS];         // output of the j-th destination served
  int dst_index[BX_MAX_SHARDS];         // that destination's shard index d
};

template <typename V>
__global__ void __launch_bounds__(256)
block_exchange_kernel(BxArgs a, int n_src, long long blk_stride, long long row_len,
                      long long row_stride, long long rows) {
  const int j = blockIdx.y / n_src;
  const int s = blockIdx.y - j * n_src;
  const long long r = blockIdx.z;
  const int d = a.dst_index[j];
  constexpr int W = sizeof(V) / sizeof(uint64_t);   // elements per thread
  const V* __restrict__ src =
      reinterpret_cast<const V*>(a.src[s] + d * blk_stride + r * row_stride);
  V* __restrict__ dst =
      reinterpret_cast<V*>(a.dst[j] + (s * rows + r) * row_len);
  const long long n = row_len / W;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

// Launches on `stream` of `device` one copy serving the n_dst destinations
// listed; src holds all n_src source views.  vec16 selects the 16-byte
// path (the caller checks alignment).  Returns cudaGetLastError().
extern "C" int block_exchange(int device, const uint64_t* const* src, int n_src,
                              uint64_t* const* dst, const int* dst_index, int n_dst,
                              long long blk_stride, long long rows, long long row_len,
                              long long row_stride, int vec16, void* stream) {
  if (n_src < 1 || n_src > BX_MAX_SHARDS || n_dst < 1 || n_dst > BX_MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || row_len <= 0) return 0;
  if (rows > 65535 || (long long)n_src * n_dst > 65535) return (int)cudaErrorInvalidValue;
  BxArgs a;
  for (int s = 0; s < n_src; s++) a.src[s] = src[s];
  for (int j = 0; j < n_dst; j++) {
    a.dst[j] = dst[j];
    a.dst_index[j] = dst_index[j];
  }
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  const int threads = 256;
  const long long per_thread = vec16 ? 2 : 1;
  long long xb = (row_len / per_thread + threads - 1) / threads;
  if (xb > 65535) xb = 65535;
  if (xb < 1) xb = 1;
  dim3 grid((unsigned)xb, (unsigned)(n_src * n_dst), (unsigned)rows);
  if (vec16)
    block_exchange_kernel<ulonglong2><<<grid, threads, 0, (cudaStream_t)stream>>>(
        a, n_src, blk_stride, row_len, row_stride, rows);
  else
    block_exchange_kernel<unsigned long long><<<grid, threads, 0, (cudaStream_t)stream>>>(
        a, n_src, blk_stride, row_len, row_stride, rows);
  int err = (int)cudaGetLastError();
  cudaSetDevice(prev);
  return err;
}

// Lets `device` read `peer`'s memory.  Returns 0 on success (also when
// access was already enabled), -1 when the hardware cannot, else the CUDA
// error code.
extern "C" int block_exchange_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return -1;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // the call also recorded the error: clear it
    e = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)e;
}
