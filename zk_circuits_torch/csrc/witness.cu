// The witness schedule (K3) for Hopper.
//
// Replaces the XLA program of zk_circuits_tpu/iop/witness_device.py::
// _witness_body, which the JAX package runs in place of a Pallas kernel:
// the circuit's static schedule (iop/witness.py) run level by level over a
// table of representative values, then the wire cells and public inputs
// gathered from it.  Three kernels, reading each level from its record in
// the blob (witness.cuh, K3Level):
//   k3_walk:  one block of K3_WALK_THREADS threads a proof (blockIdx.x;
//             values (B, R), wires (B, W, n) column-major per proof) walks
//             the levels [first, last) with a __syncthreads() between
//             levels: thread t takes ops t, t + K3_WALK_THREADS, ... of a
//             level (const, arith, arith_ext, eq_inv, ext_inv, base_sum,
//             random_access), and a team of K3_TEAM threads a
//             PoseidonGate (the swap deltas, the permutation with its trace
//             written into the gate's row, the 12 outputs);
//   k3_ops:   a level of more than WIDE_OPS (iop/witness_cuda.py) ops, one
//             thread an op over the whole card (the proof on the grid's y);
//   k3_cells: the (cell, rep) scatter into the wire matrix (every wire
//             output of the schedule and every routed cell) and the public
//             inputs' gather, one thread a cell, the proof on the grid's y.
//
// Bound: neither bytes nor multiplies (a wormhole witness moves ~22 MB and
// runs ~9e5 field products a proof: microseconds of either), but depth:
// 395 dependent levels, most of them 80-163 ops, 24 of them Poseidon levels
// of 20-22 gates.  So the levels synchronise inside a block, not between
// launches (a launch a level cost ~5 us); a level costs a barrier and a
// round trip to L2 for its values, since a thread loads the next level's
// index rows and constants while it works on the current one, and the
// block hints its levels' rows into L2 when it starts.  (An arith level
// with its op removed takes three quarters as long: a narrow level's time
// is the barrier and the loads in flight across it,
// scripts/k3_variants.py.)
// A Poseidon level costs the latency of one permutation's chain of 30
// dependent rounds: its 20-22 gates' teams of 4 fill 3 warps, and a level
// of one gate takes as long as the wormhole's.  A team of 12 shortens the
// chain (a lone gate's level two thirds as long) but needs two passes in
// a block of 256 threads; one thread a gate lengthens it.
// The seven levels of 3,620 to 18,320 ops would take one block up to 72
// passes; they run as k3_ops launches between the walk's runs of levels
// (iop/witness_cuda.py, plan).  The blob is read-only for a launch and
// read through the read-only path; the value table, which a level reads
// after the level before wrote it, is not.
#include <cuda_runtime.h>

#include "witness.cuh"

__constant__ uint64_t POSEIDON_RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;

constexpr int K3_CELLS_THREADS = 256;
constexpr int K3_OPS_THREADS = 256;
constexpr int K3_WALK_THREADS = 256;
constexpr int K3_SMEM_LEVELS = 384;  // level records a walk block keeps in shared memory
constexpr int K3_TEAM = 4;           // threads a Poseidon gate

// One round of a gate by its team: the local part, then the MDS layer
// (the team exchange with warp shuffles).  base: the warp lane of the
// team's thread 0.
template <int T, bool FULL>
__device__ __forceinline__ void gate_round(uint64_t s[POSEIDON_WIDTH / T], int j, int base,
                                           int r, const uint64_t* rc, bool act,
                                           uint64_t* trace, long long n) {
  constexpr int L = POSEIDON_WIDTH / T;
  k3_gate_round<T, FULL>(s, j, r, rc, act, trace, n);
  uint64_t g[POSEIDON_WIDTH];
#pragma unroll
  for (int e = 0; e < L; e++) g[e * T] = s[e];
#pragma unroll
  for (int d = 1; d < T; d++) {
    int src = base + (j + d < T ? j + d : j + d - T);
#pragma unroll
    for (int e = 0; e < L; e++)
      g[d + e * T] = __shfl_sync(0xffffffffu, team_provide<T>(s, j, d, e), src);
  }
  poseidon_mds_rows<T>(j, g, s);
}

// A Poseidon level by teams of T threads of a walk block; teams loop
// over the gates, and a warp with no gate left skips the permutation (so
// its shuffles stay warp-uniform).
template <int T>
__device__ __forceinline__ void walk_poseidon(const K3Level& d, uint64_t* v, uint64_t* w,
                                              long long n, const uint64_t* rc) {
  constexpr int L = POSEIDON_WIDTH / T, H = POSEIDON_HALF_FULL, R = POSEIDON_ROUNDS;
  constexpr int PER_WARP = 32 / T, TEAMS = K3_WALK_THREADS / 32 * PER_WARP;
  const int lane = threadIdx.x & 31;
  const int j = lane % T, base = lane - j;
  const int team = k3_team_index(threadIdx.x, T);
  for (long long g0 = 0; g0 < d.m; g0 += TEAMS) {
    if (g0 + (long long)(threadIdx.x >> 5) * PER_WARP >= d.m) continue;  // warp idle
    const long long g = g0 + team;
    const bool act = g < d.m;
    uint64_t* trace = act ? w + K3_START_DELTA * n + k3_ld(d.rows + g) : w;
    uint64_t s[L];
    k3_gate_start<T>(d, g, j, act, v, s, trace, n);
#pragma unroll 1
    for (int r = 0; r < H; r++) gate_round<T, true>(s, j, base, r, rc, act, trace, n);
#pragma unroll 1
    for (int r = H; r < R - H; r++) gate_round<T, false>(s, j, base, r, rc, act, trace, n);
#pragma unroll 1
    for (int r = R - H; r < R; r++) gate_round<T, true>(s, j, base, r, rc, act, trace, n);
    k3_gate_end<T>(d, g, j, act, s, v);
  }
}

// The walk over levels [first, last) of the records at blob + levels,
// block b on proof b.  The block copies the first K3_SMEM_LEVELS records
// and the round constants (a team's threads read different ones) into
// shared memory and hints the levels' rows into L2; each level's ops read
// rows that its threads loaded before the previous level's work.
__global__ void __launch_bounds__(K3_WALK_THREADS)
k3_walk_kernel(const int64_t* __restrict__ blob, long long levels, int first, int last,
               uint64_t* values, long long vstride, uint64_t* wires, long long wstride,
               long long n) {
  __shared__ uint64_t rc[POSEIDON_WIDTH * POSEIDON_ROUNDS];
  __shared__ int64_t rec_smem[K3_SMEM_LEVELS * K3_LEVEL_FIELDS];
  for (int i = threadIdx.x; i < POSEIDON_WIDTH * POSEIDON_ROUNDS; i += K3_WALK_THREADS)
    rc[i] = POSEIDON_RC[i];
  const int64_t* recs = blob + levels + (long long)first * K3_LEVEL_FIELDS;
  const int staged = min(last - first, K3_SMEM_LEVELS) * K3_LEVEL_FIELDS;
  for (int i = threadIdx.x; i < staged; i += K3_WALK_THREADS) rec_smem[i] = k3_ld(recs + i);
  __syncthreads();
  auto record = [&](int l) -> const int64_t* {
    return l - first < K3_SMEM_LEVELS ? rec_smem + (l - first) * K3_LEVEL_FIELDS
                                      : recs + (long long)(l - first) * K3_LEVEL_FIELDS;
  };
  if (first < last)
    k3_warm_l2(k3_level(blob, record(first)), k3_level(blob, record(last - 1)), threadIdx.x,
               K3_WALK_THREADS);
  uint64_t* v = values + blockIdx.x * vstride;
  uint64_t* w = wires + blockIdx.x * wstride;
  K3Level d, next;
  K3Fetch f, fnext;
  k3_prefetch(blob, record(first), first, last, threadIdx.x, d, f);
  for (int l = first; l < last; l++) {
    k3_prefetch(blob, record(l + 1), l + 1, last, threadIdx.x, next, fnext);
    if (d.kind == K3_POSEIDON)
      walk_poseidon<K3_TEAM>(d, v, w, n, rc);
    else
      k3_level_ops(d, threadIdx.x, K3_WALK_THREADS, f, v);
    __syncthreads();
    d = next;
    f = fnext;
  }
}

// A level of more than WIDE_OPS ops over the whole card: one thread an
// op, the proof on the grid's y.
__global__ void __launch_bounds__(K3_OPS_THREADS)
k3_ops_kernel(const int64_t* __restrict__ blob, long long rec, uint64_t* values,
              long long vstride) {
  const K3Level d = k3_level(blob, blob + rec);
  const long long i = (long long)blockIdx.x * K3_OPS_THREADS + threadIdx.x;
  if (i < d.m) {
    K3Fetch f;
    k3_fetch(d, i, f);
    k3_apply(d, i, f, values + blockIdx.y * vstride);
  }
}

__global__ void __launch_bounds__(K3_CELLS_THREADS)
k3_cells_kernel(long long ncells, const int64_t* cell_pos, const int64_t* cell_rep,
                long long npis, const int64_t* pi_rep, const uint64_t* values,
                long long vstride, uint64_t* wires, long long wstride, uint64_t* pis) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  k3_cell(t, ncells, cell_pos, cell_rep, npis, pi_rep, values + blockIdx.y * vstride,
          wires + blockIdx.y * wstride, pis + blockIdx.y * npis);
}

extern "C" {

// Every function launches on `stream` and returns cudaGetLastError().

int k3_walk(const void* blob, long long levels, int first, int last, void* values,
            long long vstride, void* wires, long long wstride, long long n, int batch,
            void* stream) {
  k3_walk_kernel<<<batch, K3_WALK_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)blob, levels, first, last, (uint64_t*)values, vstride, (uint64_t*)wires,
      wstride, n);
  return (int)cudaGetLastError();
}

// The level whose record is at blob + rec, of m ops.
int k3_ops(const void* blob, long long rec, long long m, void* values, long long vstride,
           int batch, void* stream) {
  dim3 grid((unsigned)((m + K3_OPS_THREADS - 1) / K3_OPS_THREADS), (unsigned)batch);
  k3_ops_kernel<<<grid, K3_OPS_THREADS, 0, (cudaStream_t)stream>>>((const int64_t*)blob, rec,
                                                                  (uint64_t*)values, vstride);
  return (int)cudaGetLastError();
}

int k3_cells(long long ncells, const void* cell_pos, const void* cell_rep, long long npis,
             const void* pi_rep, const void* values, long long vstride, void* wires,
             long long wstride, void* pis, int batch, void* stream) {
  dim3 grid((unsigned)((ncells + npis + K3_CELLS_THREADS - 1) / K3_CELLS_THREADS),
            (unsigned)batch);
  k3_cells_kernel<<<grid, K3_CELLS_THREADS, 0, (cudaStream_t)stream>>>(
      ncells, (const int64_t*)cell_pos, (const int64_t*)cell_rep, npis, (const int64_t*)pi_rep,
      (const uint64_t*)values, vstride, (uint64_t*)wires, wstride, (uint64_t*)pis);
  return (int)cudaGetLastError();
}

}  // extern "C"
