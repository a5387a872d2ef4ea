// Block all-to-all over E shards (K2) for Hopper, with the four-step NTT's
// arithmetic between exchanges fused into three of its modes.
//
// Replaces zk_circuits_tpu/parallel/ntt_exchange.py:52 (_exchange_kernel):
// afterwards shard d holds out_d[s] = x_s[d] for every source shard s, the
// transpose of the two leading axes of a global (E, E, B) tensor.  A
// poly->row re-shard of a commit and the FRI fiber regroup run one `copy`
// each; the four-step NTT runs `dft`, `twiddle` and `interleave`
// (block_exchange.cuh gives each mode's formula), which absorb the lines of
// the JAX package's _four_step_local (ntt_exchange.py:176-223) between its
// exchanges:
//
//   dft         exchange 1 and the size-E DFT (:196-204).  Every entry of
//               the E-point DFT matrix is a power of two for E | 64 (the
//               order of 2 mod p is 192 and w_E is a power of 2), so each
//               product is a shift and one or two 128-bit reductions.
//               E = 2, 4, 8 run as a radix-2 FFT in registers (E = 4: one
//               shift a column); other E sum over W's entries, with a
//               general multiply for an entry that is no power of two.
//   twiddle     exchange 2 and the twiddle multiply (:206-212).  The factor
//               w_n^(d k) is lo[k mod L] * hi[k / L], two small tables per
//               destination (L + m / L values, from the wrapper's cache, L
//               about sqrt(m)), read through L1/L2: one product to form
//               the factor, one to apply it.
//   interleave  exchange 3, the index reversal of the inverse (:214-217)
//               and the t1-minor interleave (:219-221), and the inverse's
//               n^-1 scaling (the port's intt_sharded_pallas).
//
// Layout of `copy`.  Source shard s hands a (E, rows, row_len) view: block
// d starts at element d * blk_stride, its rows lie row_stride apart, each
// row is row_len contiguous elements (the four-step's blocks have rows = 1;
// the commit re-shard reads values_s[:, rows of d] of a column-major LDE in
// place).  Destination d writes out_d (E, rows, row_len) contiguously.
//
// `copy` walks (destination, source, row, chunk) tiles of BX_COPY_TILE
// elements with 32-bit index arithmetic, one block a tile, every thread
// issuing BX_COPY_UNROLL 16-byte loads before its stores (8-byte ones for a
// tile whose ends break 16-byte alignment); sources on other cards are read
// through peer pointers over NVLink.  A design with 1-D bulk async copies
// (cp.async.bulk through a ring of shared-memory stages on mbarriers, a few
// blocks an SM) was measured beside it on the H100 and lost at the strided
// commit re-shard, the main path's largest copy (PERF.md).
//
// The fused modes read (E, bm) blocks (dft, twiddle) or (m,) rows
// (interleave) with plain loads, so across cards they too read peers'
// memory.
//
// One launch serves every destination shard that lives on one device.  The
// TPU kernel's start barrier and DMA semaphores become stream order in the
// wrapper (events between source and destination streams across cards), so
// nothing here waits on a flag of another shard.
//
// Bound: bytes.  Every mode reads each element once and writes it once
// (2 * 8 * E * E * B bytes over 3.35 TB/s on one card), plus the twiddle
// tables (8 * E * (L + m / L) bytes); its multiplies (8 32-bit products a
// 64x64 product: dft none at E <= 64; twiddle 2 products an element;
// interleave 1 an element in the inverse) take under a fifth of the byte
// time.  What the design does about it: several 16-byte loads in flight
// a thread (copy); loads issued before the arithmetic and stores,
// neighbouring threads on neighbouring addresses on both sides (the
// interleave walks outputs, not columns), the DFT as a radix-2 FFT of
// shifts in registers, no 64-bit division anywhere (fused modes).
#include <cuda_runtime.h>

#include "block_exchange.cuh"

#define BX_COPY_TILE 2048       // copy: elements a tile (even)
#define BX_COPY_UNROLL 8        // copy: 16-byte loads a thread before its stores
#define BX_TWIDDLE_UNROLL 2     // twiddle: elements a thread
#define BX_INTERLEAVE_UNROLL 4  // interleave: outputs a thread

// ---------------------------------------------------------------------------
// copy
// ---------------------------------------------------------------------------

// One block a tile: tile blockIdx.x of the walk.
__global__ void __launch_bounds__(256) block_exchange_copy(const __grid_constant__ BxCall c) {
  const BxTile t = bx_tile<BX_COPY_TILE>(c, blockIdx.x);
  const int w = threadIdx.x, n = blockDim.x;
  if (!t.body) {   // misaligned: 8-byte loads, BX_COPY_UNROLL before the stores
    for (long long base = 0; base < t.len; base += (long long)n * BX_COPY_UNROLL) {
      uint64_t v[BX_COPY_UNROLL];
#pragma unroll
      for (int u = 0; u < BX_COPY_UNROLL; u++) {
        const long long k = base + u * n + w;
        if (k < t.len) v[u] = t.src[k];
      }
#pragma unroll
      for (int u = 0; u < BX_COPY_UNROLL; u++) {
        const long long k = base + u * n + w;
        if (k < t.len) t.dst[k] = v[u];
      }
    }
    return;
  }
  if (w == 0) {   // the ragged ends, at most one element each
    for (long long k = 0; k < t.head; k++) t.dst[k] = t.src[k];
    for (long long k = t.head + t.body; k < t.len; k++) t.dst[k] = t.src[k];
  }
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(t.src + t.head);
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(t.dst + t.head);
  const long long nv = t.body / 2;
  for (long long base = 0; base < nv; base += (long long)n * BX_COPY_UNROLL) {
    ulonglong2 v[BX_COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < BX_COPY_UNROLL; u++) {
      const long long k = base + u * n + w;
      if (k < nv) v[u] = src[k];
    }
#pragma unroll
    for (int u = 0; u < BX_COPY_UNROLL; u++) {
      const long long k = base + u * n + w;
      if (k < nv) dst[k] = v[u];
    }
  }
}

// ---------------------------------------------------------------------------
// the fused modes: blockIdx.y = the destination served (twiddle: with the
// source block); neighbouring threads on neighbouring elements
// ---------------------------------------------------------------------------

template <int EC>
__global__ void __launch_bounds__(256) block_exchange_dft(const __grid_constant__ BxCall c) {
  const int j = blockIdx.y;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < c.bm;
       i += (long long)gridDim.x * blockDim.x)
    bx_dft_column<EC>(c, j, i);
}

__global__ void __launch_bounds__(256) block_exchange_twiddle(const __grid_constant__ BxCall c) {
  const int j = blockIdx.y / c.n_src, s = blockIdx.y % c.n_src, d = c.dst_index[j];
  const uint64_t* src = c.src[s] + d * c.bm;
  const uint64_t* lo = bx_twiddle_table(c, d);
  uint64_t* dst = c.dst[j] + s * c.bm;
  const long long n = (long long)gridDim.x * blockDim.x * BX_TWIDDLE_UNROLL;
  for (long long base = (long long)blockIdx.x * blockDim.x * BX_TWIDDLE_UNROLL + threadIdx.x;
       base < c.bm; base += n) {
    uint64_t v[BX_TWIDDLE_UNROLL];
#pragma unroll
    for (int u = 0; u < BX_TWIDDLE_UNROLL; u++) {
      const long long i = base + u * blockDim.x;
      if (i < c.bm) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < BX_TWIDDLE_UNROLL; u++) {
      const long long i = base + u * blockDim.x;
      if (i < c.bm) dst[i] = bx_twiddle_apply(c, lo, s, i, v[u]);
    }
  }
}

template <int EC>
__global__ void __launch_bounds__(256) block_exchange_interleave(const __grid_constant__ BxCall c) {
  const int j = blockIdx.y, d = c.dst_index[j];
  const long long m = c.bm * BX_E;
  uint64_t* dst = c.dst[j];
  const long long n = (long long)gridDim.x * blockDim.x * BX_INTERLEAVE_UNROLL;
  for (long long base = (long long)blockIdx.x * blockDim.x * BX_INTERLEAVE_UNROLL + threadIdx.x;
       base < m; base += n) {
    uint64_t v[BX_INTERLEAVE_UNROLL];
#pragma unroll
    for (int u = 0; u < BX_INTERLEAVE_UNROLL; u++) {
      const long long o = base + u * blockDim.x;
      if (o < m) v[u] = *bx_interleave_from<EC>(c, d, o);
    }
#pragma unroll
    for (int u = 0; u < BX_INTERLEAVE_UNROLL; u++) {
      const long long o = base + u * blockDim.x;
      if (o < m) dst[o] = bx_interleave_value(c, v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

static long long bx_blocks(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b > (1LL << 30)) b = 1LL << 30;
  return b < 1 ? 1 : b;
}

#define BX_LAUNCH_E(kernel, grid, threads, stream, c)                               \
  switch ((c).n_src) {                                                              \
    case 2: kernel<2><<<grid, threads, 0, stream>>>(c); break;                     \
    case 4: kernel<4><<<grid, threads, 0, stream>>>(c); break;                     \
    case 8: kernel<8><<<grid, threads, 0, stream>>>(c); break;                     \
    default: kernel<0><<<grid, threads, 0, stream>>>(c); break;                    \
  }

// Launches one call on `stream` of `device`; returns cudaGetLastError()
// (or cudaErrorInvalidValue for a call the kernel does not take).
extern "C" int block_exchange(int device, const BxCall* call, void* stream_ptr) {
  const BxCall& c = *call;
  if (c.n_src < 1 || c.n_src > BX_MAX_SHARDS || c.n_dst < 1 || c.n_dst > BX_MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  int err = 0;
  if (c.mode == BX_COPY) {
    if (c.rows <= 0 || c.row_len <= 0) {
      cudaSetDevice(prev);
      return 0;
    }
    const long long tiles = bx_num_tiles<BX_COPY_TILE>(c);
    if (tiles >= (1LL << 31))
      err = (int)cudaErrorInvalidValue;
    else
      block_exchange_copy<<<(unsigned)tiles, 256, 0, stream>>>(c);
  } else if (c.bm <= 0) {
    err = 0;
  } else if ((long long)c.n_dst * c.n_src > 65535) {
    err = (int)cudaErrorInvalidValue;
  } else if (c.mode == BX_DFT) {
    dim3 grid((unsigned)bx_blocks(c.bm, 256), c.n_dst);
    BX_LAUNCH_E(block_exchange_dft, grid, 256, stream, c)
  } else if (c.mode == BX_TWIDDLE) {
    dim3 grid((unsigned)bx_blocks(c.bm, 256 * BX_TWIDDLE_UNROLL), c.n_dst * c.n_src);
    block_exchange_twiddle<<<grid, 256, 0, stream>>>(c);
  } else if (c.mode == BX_INTERLEAVE) {
    dim3 grid((unsigned)bx_blocks(c.bm * c.n_src, 256 * BX_INTERLEAVE_UNROLL), c.n_dst);
    BX_LAUNCH_E(block_exchange_interleave, grid, 256, stream, c)
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  if (!err) err = (int)cudaGetLastError();
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

// The size of the BxCall the library was built with (the wrapper checks
// its ctypes mirror against it).
extern "C" int block_exchange_call_size(void) { return (int)sizeof(BxCall); }
