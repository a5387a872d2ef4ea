// Poseidon leaf sponge and Merkle subtrees (K1) for Hopper.
//
// Replaces zk_circuits_tpu/hash/poseidon_pallas.py::_leaf_hash_kernel.
// Three entry points, one sponge core:
//   k1_sponge: hash_no_pad of every row of an (n, cols) matrix; with
//              levels > 0 also the Merkle levels above the leaves inside
//              each block (the block's subtree), digests kept in shared
//              memory, every level written to its place in the output;
//   k1_top:    one block per tree that compresses the levels above the
//              blocks' subtrees up to the cap.
// Both take a batch of matrices of one shape (one per proof of a batched
// prover), each with its own input and output at fixed strides: one
// launch hashes every proof's rows, or builds every proof's tree.
//
// Bound: integer instructions, not bytes.  A row of c columns costs
// ceil(c/8) permutations (118 S-boxes of four 64x64->128 products, 30 MDS
// layers) against 8c + 32 bytes.  Two ways to spend the instructions,
// chosen by the wrapper from the row count (hash/poseidon_cuda.py config):
//   - one thread per row (T = 1) with the frequency-domain MDS (shifts and
//     adds only, poseidon.cuh): the fewest instructions a row, best where
//     there are rows enough to fill the card (2^14 and more);
//   - a team of T = 4 threads of a warp per row: each thread owns 12/T lanes,
//     runs their S-boxes and its rows of the MDS, and gathers the lanes it
//     lacks with __shfl_sync.  T times the warps and a shorter chain per
//     thread, paid for with the exchange and the partial rounds' S-box,
//     which every thread of the team runs: best for few rows (a 4096-row
//     FRI tree fills 32 SMs one thread a row) and for the tree levels
//     above the blocks' first, where a permutation's latency is the cost
//     (there also teams of 12 once one pass of them covers a level).
// The block stages its rows' next rate chunk (8 felts a row) in shared
// memory with cp.async, 16 bytes a copy where the layout allows, while the
// current permutation runs.  The input is addressed through (row_stride,
// col_stride): column-major LDE output (cols, n) is read in place (its tile
// is kept column-major, so neighbouring threads copy neighbouring rows),
// row-major (n, cols) leaves row by row.  Rows past n are masked.  A batch
// of B matrices is a grid of ceil(n / rows) x B blocks: blockIdx.y is the
// matrix, so no block straddles two of them and each tree stays its own.
#include <cuda_runtime.h>

#include "poseidon.cuh"

__constant__ uint64_t POSEIDON_RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;

constexpr int K1_MAX_ROWS = 256;     // rows per block (a power of two for trees)
constexpr int K1_MAX_BATCH = 65535;  // matrices per launch (the grid's y extent)

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// One team of T threads: its lane index j, the warp lane of its thread 0.
template <int T>
struct Team {
  static constexpr int L = POSEIDON_WIDTH / T;
  static constexpr int PER_WARP = 32 / T;
  int j, base;
  __device__ Team() {
    int lane = threadIdx.x & 31;
    j = lane % T;
    base = lane - j;
  }
  // Block-local team number; the lanes left over when T does not divide
  // 32 get one past every real team.  Teams past the block's rows compute
  // garbage that is never stored.
  __device__ int index() const {
    int lane = threadIdx.x & 31;
    return lane < PER_WARP * T ? (threadIdx.x >> 5) * PER_WARP + lane / T : 1 << 30;
  }
};

template <int T>
__device__ __forceinline__ const uint64_t* round_constants(const uint64_t* rc_smem) {
  return T == 1 ? POSEIDON_RC : rc_smem;  // T = 1: every thread reads the same one
}

// Round r of one row by its team; s holds the thread's lanes.
template <int T, bool FULL>
__device__ __forceinline__ void team_round(uint64_t s[Team<T>::L], const Team<T>& tm, int r,
                                           const uint64_t* rc) {
  constexpr int L = Team<T>::L;
  poseidon_team_sboxes<T, FULL>(s, tm.j, r, rc);
  if constexpr (T == 1) {
    poseidon_mds_freq(s);
  } else {
    uint64_t g[POSEIDON_WIDTH];
#pragma unroll
    for (int e = 0; e < L; e++) g[e * T] = s[e];
#pragma unroll
    for (int d = 1; d < T; d++) {
      int src = tm.base + (tm.j + d < T ? tm.j + d : tm.j + d - T);
#pragma unroll
      for (int e = 0; e < L; e++)
        g[d + e * T] = __shfl_sync(0xffffffffu, team_provide<T>(s, tm.j, d, e), src);
    }
    poseidon_mds_rows<T>(tm.j, g, s);
  }
}

// The permutation: three loops (full, partial, full rounds), one round
// each per iteration, so that the SASS of each round type stands alone.
template <int T>
__device__ __forceinline__ void team_permute(uint64_t s[Team<T>::L], const Team<T>& tm,
                                             const uint64_t* rc) {
  constexpr int H = POSEIDON_HALF_FULL, R = POSEIDON_ROUNDS;
#pragma unroll 1
  for (int r = 0; r < H; r++) team_round<T, true>(s, tm, r, rc);
#pragma unroll 1
  for (int r = H; r < R - H; r++) team_round<T, false>(s, tm, r, rc);
#pragma unroll 1
  for (int r = R - H; r < R; r++) team_round<T, true>(s, tm, r, rc);
}

// One Merkle level by teams of T threads: node k < m is the compress of
// the 8 felts src[8k .. 8k+8), written to dst[4k ..] (when dst is not
// null) and to out[4k ..].  Teams loop over the nodes; a warp with no node
// left skips the permutation (so its shuffles stay warp-uniform).
constexpr int TREE_TEAM = 4;

template <int T>
__device__ __forceinline__ void compress_level(const uint64_t* src, uint64_t* dst,
                                               uint64_t* out, long long m, const uint64_t* rc) {
  constexpr int L = Team<T>::L;
  Team<T> tm;
  const int t = tm.index();
  const int teams = (blockDim.x >> 5) * Team<T>::PER_WARP;
  for (long long k0 = 0; k0 < m; k0 += teams) {
    if (k0 + (long long)(threadIdx.x >> 5) * Team<T>::PER_WARP >= m) continue;  // warp idle
    const long long k = k0 + t;
    const bool act = t < teams && k < m;
    uint64_t s[L];
#pragma unroll
    for (int e = 0; e < L; e++) {
      int lane = tm.j + e * T;
      s[e] = (lane < 8 && act) ? src[8 * k + lane] : 0;
    }
    team_permute<T>(s, tm, rc);
#pragma unroll
    for (int e = 0; e < L; e++) {
      int lane = tm.j + e * T;
      if (lane < 4 && act) {
        uint64_t v = gl_canon(s[e]);
        if (dst) dst[4 * k + lane] = v;
        out[4 * k + lane] = v;
      }
    }
  }
}

// A level of m nodes above the first: teams of 12 (one lane a thread, the
// shortest chain) when one pass of them covers the level, else teams of
// TREE_TEAM.  rc: the round constants in shared memory.
__device__ __forceinline__ void tree_level(const uint64_t* src, uint64_t* dst, uint64_t* out,
                                           long long m, const uint64_t* rc) {
  if (m <= (long long)(blockDim.x >> 5) * Team<12>::PER_WARP)
    compress_level<12>(src, dst, out, m, rc);
  else
    compress_level<TREE_TEAM>(src, dst, out, m, rc);
}

__device__ __forceinline__ void load_round_constants(uint64_t* rc_smem) {
  for (int i = threadIdx.x; i < POSEIDON_WIDTH * POSEIDON_ROUNDS; i += blockDim.x)
    rc_smem[i] = POSEIDON_RC[i];
}

// Shared memory: [round constants] [2 tiles of rows x 8] [2 x rows x 4 digests].
template <int T>
__global__ void __launch_bounds__(T == 1 ? 256 : 512)
k1_sponge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long n,
                 int cols, long long row_stride, long long col_stride, int rows, int levels,
                 int vec16, long long in_bstride, long long out_bstride) {
  constexpr int L = Team<T>::L;
  extern __shared__ uint64_t smem[];
  uint64_t* rc_smem = smem;
  uint64_t* tile = smem + POSEIDON_WIDTH * POSEIDON_ROUNDS;
  uint64_t* dig = tile + 2 * 8 * rows;
  const int nthreads = blockDim.x;
  load_round_constants(rc_smem);
  const uint64_t* rc = round_constants<T>(rc_smem);

  Team<T> tm;
  const int t = tm.index();
  in += blockIdx.y * in_bstride;
  out += blockIdx.y * out_bstride;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + t;
  const bool valid = t < rows && row < n;
  const long long nrows = n - row0 < rows ? n - row0 : rows;  // rows of this block
  const bool colmajor = row_stride == 1 && col_stride != 1;
  // tile element (r, c) of a buffer: column-major or row-major as the input
  const int tr = colmajor ? 1 : 8, tc = colmajor ? rows : 1;

  auto stage = [&](int off, uint64_t* buf) {
    const int chunk = cols - off < POSEIDON_RATE ? cols - off : POSEIDON_RATE;
    const int step = vec16 ? 2 : 1;  // elements per copy, along the contiguous axis
    const int inner = colmajor ? rows : 8;
    const int outer = colmajor ? chunk : (int)nrows;
    const int per_outer = (inner + step - 1) / step;
    for (int p = threadIdx.x; p < outer * per_outer; p += nthreads) {
      int o = p / per_outer, i = (p - o * per_outer) * step;
      int r = colmajor ? i : o, c = colmajor ? o : i;
      int lim = colmajor ? (int)nrows : chunk;  // valid elements along the inner axis
      if (i >= lim) continue;
      const uint64_t* src = in + (row0 + r) * row_stride + (long long)(off + c) * col_stride;
      cp_async(buf + r * tr + c * tc, src, (step == 2 && i + 1 < lim) ? 16 : 8);
    }
    cp_async_commit();
  };

  uint64_t s[L];
#pragma unroll
  for (int k = 0; k < L; k++) s[k] = 0;
  stage(0, tile);
  for (int off = 0, b = 0; off < cols; off += POSEIDON_RATE, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; everyone is done with the other buffer
    if (off + POSEIDON_RATE < cols) stage(off + POSEIDON_RATE, tile + (b ^ 1) * 8 * rows);
    const int chunk = cols - off < POSEIDON_RATE ? cols - off : POSEIDON_RATE;
    const uint64_t* buf = tile + b * 8 * rows;
    const int tt = t < rows ? t : 0;
#pragma unroll
    for (int k = 0; k < L; k++) {
      int lane = tm.j + k * T;
      if (lane < chunk) s[k] = buf[tt * tr + lane * tc];
    }
    team_permute<T>(s, tm, rc);
  }

#pragma unroll
  for (int k = 0; k < L; k++) {
    int lane = tm.j + k * T;
    if (lane < 4) {
      uint64_t v = gl_canon(s[k]);
      if (valid) out[row * 4 + lane] = v;
      if (levels > 0 && t < rows) dig[t * 4 + lane] = v;
    }
  }

  // The block's subtree, level l from level l - 1 (two digest buffers in
  // turn).  While the level keeps at least half the leaves' teams busy it
  // takes their team size; above, the levels are few nodes and the
  // permutation's latency is what counts (tree_level).
  const int teams = (nthreads >> 5) * Team<T>::PER_WARP;
  for (int l = 1; l <= levels; l++) {
    __syncthreads();  // level l - 1 is in its buffer
    const uint64_t* src = dig + ((l - 1) & 1) * 4 * rows;
    uint64_t* dst = dig + (l & 1) * 4 * rows;
    uint64_t* lvl = out + merkle_node_elem(n, l, row0, 0, 0);
    const long long m = nrows >> l;
    if (T != TREE_TEAM && 2 * m >= teams)
      compress_level<T>(src, dst, lvl, m, rc);
    else
      tree_level(src, dst, lvl, m, rc_smem);
  }
}

// Levels from+1 .. to of a tree over n leaves whose level `from` is already
// in `out`; one block per tree (block b: the tree at out + b * out_bstride),
// level by level through global memory (a level is visible to the whole
// block after __syncthreads).
__global__ void __launch_bounds__(512) k1_top_kernel(uint64_t* out, long long n, int from, int to,
                                                     long long out_bstride) {
  __shared__ uint64_t rc_smem[POSEIDON_WIDTH * POSEIDON_ROUNDS];
  out += blockIdx.x * out_bstride;
  load_round_constants(rc_smem);
  for (int l = from + 1; l <= to; l++) {
    __syncthreads();
    tree_level(out + merkle_level_offset(n, l - 1), nullptr, out + merkle_level_offset(n, l),
               n >> l, rc_smem);
  }
}

static int block_threads(int team, int rows) {
  int per_warp = 32 / team;
  return (rows + per_warp - 1) / per_warp * 32;
}

static int max_threads(int team) { return team == 1 ? 256 : 512; }

template <int T>
static int launch_sponge(const uint64_t* in, uint64_t* out, long long n, int cols,
                         long long row_stride, long long col_stride, int rows, int levels,
                         int vec16, int batch, long long in_bstride, long long out_bstride,
                         cudaStream_t stream) {
  int threads = block_threads(T, rows);
  size_t shmem = sizeof(uint64_t) * (POSEIDON_WIDTH * POSEIDON_ROUNDS + 2 * 8 * rows + 2 * 4 * rows);
  dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)batch);
  // Above 48 KB only after opting in, which holds for the current device
  // alone: set it before every launch, on whichever card this one runs.
  cudaError_t err = cudaFuncSetAttribute(
      k1_sponge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(uint64_t) * (POSEIDON_WIDTH * POSEIDON_ROUNDS + 24 * K1_MAX_ROWS)));
  if (err != cudaSuccess) return (int)err;
  k1_sponge_kernel<T><<<grid, threads, shmem, stream>>>(
      in, out, n, cols, row_stride, col_stride, rows, levels, vec16, in_bstride, out_bstride);
  return (int)cudaGetLastError();
}

// hash_no_pad of the n rows of (n, cols) into out[0 .. 4n); with levels > 0
// (n a power of two, rows a power of two), also levels 1..levels of each
// block's subtree, level l at out[merkle_level_offset(n, l)].  team: threads per
// row (1 or 4); rows: rows per block (<= 256).  vec16: the input
// may be copied 16 bytes at a time along its contiguous axis (the caller
// checks alignment).  batch: the number of such matrices, matrix b at
// in + b * in_bstride, its digests (or tree) at out + b * out_bstride.
// Returns a CUDA error code (0 on success), or -1 on arguments the kernel
// does not take.
extern "C" int k1_sponge(const uint64_t* in, uint64_t* out, long long n, int cols,
                         long long row_stride, long long col_stride, int team, int rows,
                         int levels, int vec16, int batch, long long in_bstride,
                         long long out_bstride, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (cols < 1 || rows < 1 || rows > K1_MAX_ROWS || block_threads(team, rows) > max_threads(team) ||
      batch > K1_MAX_BATCH)
    return -1;
  if (levels > 0 && (rows & (rows - 1)) != 0) return -1;
  if (rows % 2) vec16 = 0;  // 16-byte copies need an even tile stride
  cudaStream_t st = (cudaStream_t)stream;
  switch (team) {
    case 1: return launch_sponge<1>(in, out, n, cols, row_stride, col_stride, rows, levels, vec16,
                                    batch, in_bstride, out_bstride, st);
    case 4: return launch_sponge<4>(in, out, n, cols, row_stride, col_stride, rows, levels, vec16,
                                    batch, in_bstride, out_bstride, st);
    default: return -1;
  }
}

// Levels from+1 .. to of each of the `batch` trees in out (see k1_sponge),
// one block of `threads` threads (teams of TREE_TEAM) per tree.
extern "C" int k1_top(uint64_t* out, long long n, int from, int to, int threads, int batch,
                      long long out_bstride, void* stream) {
  if (to <= from || batch <= 0) return 0;
  if (threads < 32 || threads % 32 != 0 || threads > 512 || batch > K1_MAX_BATCH) return -1;
  k1_top_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(out, n, from, to, out_bstride);
  return (int)cudaGetLastError();
}
