// Index and layout code of the FRI query gather K10, __host__ __device__ so
// that tests/test_torch_gather_kernel.py runs it on the CPU with g++.
//
// One call (a K10Call, filled by fri/gather_cuda.py) gathers, for a batch
// of B proofs, every tree's query rows and sibling paths into one flat
// output, in the order of fri/fri_device.py's plain version:
//
//   for each tree t, in call order:
//     rows   out[o_t + (b Q + q) w + c]             = leaves[b][i][c]
//     level l < L_t (the cap is not opened):
//            out[o_t + B Q w + (l B Q + b Q + q) 4 + d] = level_l[b][(i >> l) ^ 1][d]
//
// with i = idx_t[b][q] (a leaf of the tree, 0 <= i < N_t), b < B, q < Q_t,
// c < w_t and d < 4.  A leaf matrix is read through its strides:
// leaves[b][i][c] at leaves + b bs + i si + c sc, which covers the
// oracles' column-major (B, w, N) values (si = 1, sc = N), the FRI trees'
// row-major (B, N, 2A) leaves (si = 2A, sc = 1) and the circuit's
// constants/sigmas oracle, one (w, N) matrix shared by every proof (bs =
// 0).  Level l holds the (B, N >> l, 4) digests, digest s of proof b at
// level_l + b lbs + s lrs.  The kernel computes each level's sibling from
// the query index itself: no per-level index is uploaded.
//
// The call's descriptors and indices are one int64 blob (one upload):
//
//   blob[t K10_DESC + K10_*]   tree t's descriptor (K10Field below)
//   blob[lvl_t + 3 l + 0..2]   level l's pointer, batch stride, row stride
//   blob[idx_t + b Q_t + q]    the query indices of tree t
//
// Pointers are the tensors' addresses as int64; values are copied as their
// 64-bit patterns, so any u64 (also in [p, 2^64)) comes out as it went in.
#pragma once

#include "goldilocks.cuh"   // GL_HD

#define K10_THREADS 256       // a block's threads: a thread an output word
#define K10_MAX_TREES 65535   // the grid's y extent: a tree a row of blocks
#define K10_MAX_BLOCKS 1024   // blocks a tree, at most (the rest in a grid-stride loop)

// The words of a tree's descriptor.
enum K10Field {
  K10_LEAVES = 0,   // the leaf matrix's address
  K10_BS,           // its proof stride (0: shared by every proof)
  K10_SI,           // its stride along the leaves
  K10_SC,           // its stride along a leaf's words
  K10_W,            // words a leaf
  K10_Q,            // queries a proof
  K10_NLEV,         // sibling levels (the levels below the cap)
  K10_IDX,          // blob offset of the (B, Q) query indices
  K10_LVL,          // blob offset of the levels' (pointer, batch stride, row stride)
  K10_OUT,          // output offset of the tree's words
  K10_TOTAL,        // the tree's output words: B Q (w + 4 nlev)
  K10_DESC          // words a descriptor
};

struct K10Call {
  const long long* blob;   // the descriptors, levels and indices (on the device)
  uint64_t* out;           // the flat output
  long long total;         // output words of the call (every tree's)
  int trees, batch;        // trees; proofs B
  int blocks;              // blocks a tree (grid x)
};

// Output word e (< blob[K10_TOTAL]) of the tree whose descriptor is d.
GL_HD uint64_t k10_value(const long long* blob, const long long* d, long long e, int batch) {
  const long long w = d[K10_W], q = d[K10_Q], bq_all = (long long)batch * q;
  const long long* idx = blob + d[K10_IDX];
  const long long rows = bq_all * w;
  if (e < rows) {
    const long long bq = e / w, c = e - bq * w, b = bq / q;
    const uint64_t* leaves = (const uint64_t*)d[K10_LEAVES];
    return leaves[b * d[K10_BS] + idx[bq] * d[K10_SI] + c * d[K10_SC]];
  }
  const long long e2 = e - rows, per = bq_all * 4;
  const long long l = e2 / per, r = e2 - l * per, bq = r >> 2, b = bq / q;
  const long long* lv = blob + d[K10_LVL] + 3 * l;
  const long long s = (idx[bq] >> l) ^ 1;
  return ((const uint64_t*)lv[0])[b * lv[1] + s * lv[2] + (r & 3)];
}

// Thread `tid` of block (bx, t) of the grid (c.blocks, c.trees): its words
// of tree t, a grid-stride loop over them.
GL_HD void k10_thread(const K10Call& c, int t, long long bx, int tid) {
  const long long* d = c.blob + (long long)t * K10_DESC;
  const long long total = d[K10_TOTAL], out = d[K10_OUT];
  const long long step = (long long)c.blocks * K10_THREADS;
  for (long long e = bx * K10_THREADS + tid; e < total; e += step)
    c.out[out + e] = k10_value(c.blob, d, e, c.batch);
}

// Whether the call is one the kernel takes (the wrapper has checked each
// tree's shapes and indices).
GL_HD bool k10_valid(const K10Call& c) {
  return c.blob && c.out && c.trees >= 1 && c.trees <= K10_MAX_TREES && c.batch >= 1 &&
         c.blocks >= 1 && c.blocks <= K10_MAX_BLOCKS && c.total >= 0;
}
