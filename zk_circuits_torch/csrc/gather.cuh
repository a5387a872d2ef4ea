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
// c < w_t and d < 4.
//
// A leaf matrix, and each level, is a list of pieces that split its rows
// in order, 2^g rows each (one piece for a tree on one device; E for a
// row-sharded tree, shard s holding rows [s 2^g, (s + 1) 2^g)): row i lies
// in piece i >> g at local row i & (2^g - 1), so no per-shard index is
// uploaded and nothing is permuted afterwards.  A matrix of one piece
// (g = K10_ONE_PIECE_LOG) holds its address in place of the offset of its
// piece table, so that its words cost no more dependent loads than the
// index and the word.  The pieces of a matrix
// share its strides, and a piece on another card is read through its peer
// pointer.  A leaf matrix is read through its strides: leaves[b][i][c] at
// piece + b bs + (local i) si + c sc, which covers the oracles'
// column-major (B, w, N) values (si = 1, sc = N), the FRI trees'
// row-major (B, N, 2A) leaves (si = 2A, sc = 1) and the circuit's
// constants/sigmas oracle, one (w, N) matrix shared by every proof (bs =
// 0).  Level l holds the (B, N >> l, 4) digests, digest s of proof b at
// piece + b lbs + (local s) lrs.  The kernel computes each level's sibling
// from the query index itself: no per-level index is uploaded.
//
// The call's descriptors, piece addresses and indices are one int64 blob
// (one upload):
//
//   blob[t K10_DESC + K10_*]   tree t's descriptor (K10Field below)
//   blob[lvl_t + 4 l + K10L_*] level l's record (K10LevelField below)
//   blob[pieces + p]           a matrix's piece addresses, in row order (more
//                              than one piece)
//   blob[idx_t + b Q_t + q]    the query indices of tree t
//
// Pointers are the tensors' addresses as int64; values are copied as their
// 64-bit patterns, so any u64 (also in [p, 2^64)) comes out as it went in.
#pragma once

#include "goldilocks.cuh"   // GL_HD

#define K10_THREADS 256       // a block's threads: a thread an output word
#define K10_MAX_TREES 65535   // the grid's y extent: a tree a row of blocks
#define K10_MAX_BLOCKS 1024   // blocks a tree, at most (the rest in a grid-stride loop)
#define K10_ONE_PIECE_LOG 62  // log2 rows a piece of a matrix that is one piece (its
                              // address in place of its piece table's offset)

// The words of a tree's descriptor.
enum K10Field {
  K10_LEAVES = 0,   // blob offset of the leaf matrix's piece addresses (one piece: its address)
  K10_LLOG,         // log2 of the rows a leaf piece holds
  K10_BS,           // the leaf matrix's proof stride (0: shared by every proof)
  K10_SI,           // its stride along the leaves
  K10_SC,           // its stride along a leaf's words
  K10_W,            // words a leaf
  K10_Q,            // queries a proof
  K10_NLEV,         // sibling levels (the levels below the cap)
  K10_IDX,          // blob offset of the (B, Q) query indices
  K10_LVL,          // blob offset of the levels' records
  K10_OUT,          // output offset of the tree's words
  K10_TOTAL,        // the tree's output words: B Q (w + 4 nlev)
  K10_DESC          // words a descriptor
};

// The words of a level's record.
enum K10LevelField {
  K10L_PIECES = 0,   // blob offset of the level's piece addresses (one piece: its address)
  K10L_LOG,          // log2 of the rows a piece holds
  K10L_BS,           // proof stride
  K10L_RS,           // row stride
  K10L_WORDS         // words a record
};

struct K10Call {
  const long long* blob;   // the descriptors, levels and indices (on the device)
  uint64_t* out;           // the flat output
  long long total;         // output words of the call (every tree's)
  int trees, batch;        // trees; proofs B
  int blocks;              // blocks a tree (grid x)
};

// Row i of a matrix whose piece addresses start at blob[pieces], 2^lg
// rows a piece (or of one piece at address `pieces`): its piece's
// address, and i's row within the piece in *r.
GL_HD const uint64_t* k10_piece(const long long* blob, long long pieces, long long lg,
                                long long i, long long* r) {
  if (lg == K10_ONE_PIECE_LOG) {
    *r = i;
    return (const uint64_t*)pieces;
  }
  *r = i & ((1LL << lg) - 1);
  return (const uint64_t*)blob[pieces + (i >> lg)];
}

// Output word e (< blob[K10_TOTAL]) of the tree whose descriptor is d.
GL_HD uint64_t k10_value(const long long* blob, const long long* d, long long e, int batch) {
  const long long w = d[K10_W], q = d[K10_Q], bq_all = (long long)batch * q;
  const long long* idx = blob + d[K10_IDX];
  const long long rows = bq_all * w;
  long long r;
  if (e < rows) {
    const long long bq = e / w, c = e - bq * w, b = bq / q;
    const uint64_t* leaves = k10_piece(blob, d[K10_LEAVES], d[K10_LLOG], idx[bq], &r);
    return leaves[b * d[K10_BS] + r * d[K10_SI] + c * d[K10_SC]];
  }
  const long long e2 = e - rows, per = bq_all * 4;
  const long long l = e2 / per, rem = e2 - l * per, bq = rem >> 2, b = bq / q;
  const long long* lv = blob + d[K10_LVL] + K10L_WORDS * l;
  const uint64_t* p = k10_piece(blob, lv[K10L_PIECES], lv[K10L_LOG], (idx[bq] >> l) ^ 1, &r);
  return p[b * lv[K10L_BS] + r * lv[K10L_RS] + (rem & 3)];
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
