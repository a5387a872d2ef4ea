// The witness schedule's per-element arithmetic and the body of its walk
// (K3), shared by the CUDA kernel of witness.cu and by a host build for
// testing.
//
// Every value of the representative table is canonical (the host witness
// matrix is), so every result stored here goes through gl_canon; the
// Poseidon rounds chain non-canonical lanes (poseidon.cuh) and only the
// recorded trace columns and the outputs are made canonical.
//
// The value table is written and read within one launch, level after
// level, so it is never read through the read-only path (k3_ld is for
// the blob alone: index rows, constants and level records, which no
// thread writes).
#pragma once

#include "poseidon.cuh"

// Generator kinds of one schedule level (iop/witness_device.py, KINDS).
#define K3_CONST 0
#define K3_ARITH 1
#define K3_ARITH_EXT 2
#define K3_EQ_INV 3
#define K3_EXT_INV 4
#define K3_BASE_SUM 5
#define K3_RANDOM_ACCESS 6
#define K3_POSEIDON 7

// PoseidonGate's wire layout (iop/gates.py): 12 inputs, 12 outputs, swap,
// then the trace: 4 deltas, full rounds 1-3 (36), the 22 partial rounds'
// lane 0, the last 4 full rounds (48).
#define K3_START_DELTA 25
#define K3_TRACE_COLS 110

// A level's record in the blob: K3_LEVEL_FIELDS int64 in this order
// (iop/witness_device.py, LEVEL_FIELDS): its kind, op count, bit count,
// index row widths, and the blob offsets of its input reps (m, k_in),
// output reps (m, k_out), constants and a Poseidon level's gate rows.
#define K3_LEVEL_FIELDS 9

// A blob element, through the read-only path on the card.
GL_HD int64_t k3_ld(const int64_t* p) {
#ifdef __CUDA_ARCH__
  return (int64_t)__ldg((const long long*)p);
#else
  return *p;
#endif
}

GL_HD uint64_t k3_ldu(const uint64_t* p) { return (uint64_t)k3_ld((const int64_t*)p); }

// Canonical results for canonical operands.
GL_HD uint64_t k3_mul(uint64_t a, uint64_t b) { return gl_canon(gl_mul(a, b)); }
GL_HD uint64_t k3_sub(uint64_t a, uint64_t b) { return a >= b ? a - b : a - b + GL_P; }
GL_HD uint64_t k3_neg(uint64_t a) { return a == 0 ? 0 : GL_P - a; }

// a^(p-2) by square-and-multiply over the exponent's 64 bits: inverse(0)
// is 0, as the host's gl.inverse.
GL_HD uint64_t k3_inverse(uint64_t a) {
  const uint64_t e = GL_P - 2;
  uint64_t r = 1;
  for (int i = 63; i >= 0; i--) {
    r = gl_mul(r, r);
    if ((e >> i) & 1) r = gl_mul(r, a);
  }
  return gl_canon(r);
}

// (a0 + a1 X)(b0 + b1 X) with X^2 = 7.
GL_HD void k3_ext_mul(uint64_t a0, uint64_t a1, uint64_t b0, uint64_t b1, uint64_t* c0,
                      uint64_t* c1) {
  *c0 = gl_add(k3_mul(a0, b0), k3_mul(7, k3_mul(a1, b1)));
  *c1 = gl_add(k3_mul(a0, b1), k3_mul(a1, b0));
}

// One schedule level, read from its record.  consts: arith and
// arith_ext's c0 at consts[i], c1 at consts[m + i]; the const level's
// values at consts[i * k_out ..].  nbits: base_sum and random_access's bit
// count.
struct K3Level {
  int kind, nbits, k_in, k_out;
  long long m;
  const int64_t* in;
  const int64_t* out;
  const uint64_t* consts;
  const int64_t* rows;
};

// rec: the level's record, in the blob or in a block's shared copy of it
// (so read with plain loads).
GL_HD K3Level k3_level(const int64_t* blob, const int64_t* rec) {
  K3Level d;
  d.kind = (int)rec[0];
  d.m = rec[1];
  d.nbits = (int)rec[2];
  d.k_in = (int)rec[3];
  d.k_out = (int)rec[4];
  d.in = blob + rec[5];
  d.out = blob + rec[6];
  d.consts = (const uint64_t*)(blob + rec[7]);
  d.rows = blob + rec[8];
  return d;
}

// What op i of a level needs before it reads a value: its first input
// and output reps and its two constants.  None depends on the values, so
// the walk loads a thread's first op of the next level while the thread
// works on the current one.
#define K3_FETCH_IN 6
#define K3_FETCH_OUT 2
struct K3Fetch {
  int64_t in[K3_FETCH_IN], out[K3_FETCH_OUT];
  uint64_t c0, c1;
};

GL_HD void k3_fetch(const K3Level& d, long long i, K3Fetch& f) {
  const int64_t* in = d.in + i * d.k_in;
  const int64_t* out = d.out + i * d.k_out;
#pragma unroll
  for (int j = 0; j < K3_FETCH_IN; j++) f.in[j] = j < d.k_in ? k3_ld(in + j) : 0;
#pragma unroll
  for (int j = 0; j < K3_FETCH_OUT; j++) f.out[j] = j < d.k_out ? k3_ld(out + j) : 0;
  const bool arith = d.kind == K3_ARITH || d.kind == K3_ARITH_EXT;
  f.c0 = arith ? k3_ldu(d.consts + i) : 0;
  f.c1 = arith ? k3_ldu(d.consts + d.m + i) : 0;
}

// Op i of a level other than Poseidon, its rows in f: reads its inputs
// from the value table v and writes its outputs there.
GL_HD void k3_apply(const K3Level& d, long long i, const K3Fetch& f, uint64_t* v) {
  const int64_t* out = d.out + i * d.k_out;
  switch (d.kind) {
    case K3_CONST:
      for (int j = 0; j < d.k_out; j++) v[k3_ld(out + j)] = k3_ldu(d.consts + i * d.k_out + j);
      break;
    case K3_ARITH: {
      uint64_t prod = k3_mul(v[f.in[0]], v[f.in[1]]);
      v[f.out[0]] = gl_add(k3_mul(f.c0, prod), k3_mul(f.c1, v[f.in[2]]));
      break;
    }
    case K3_ARITH_EXT: {
      uint64_t p0, p1;
      k3_ext_mul(v[f.in[0]], v[f.in[1]], v[f.in[2]], v[f.in[3]], &p0, &p1);
      v[f.out[0]] = gl_add(k3_mul(p0, f.c0), k3_mul(v[f.in[4]], f.c1));
      v[f.out[1]] = gl_add(k3_mul(p1, f.c0), k3_mul(v[f.in[5]], f.c1));
      break;
    }
    case K3_EQ_INV:
      v[f.out[0]] = k3_inverse(v[f.in[0]]);
      break;
    case K3_EXT_INV: {  // (a0 - a1 X) / (a0^2 - 7 a1^2)
      uint64_t a0 = v[f.in[0]], a1 = v[f.in[1]];
      uint64_t ninv = k3_inverse(k3_sub(k3_mul(a0, a0), k3_mul(7, k3_mul(a1, a1))));
      v[f.out[0]] = k3_mul(a0, ninv);
      v[f.out[1]] = k3_mul(k3_neg(a1), ninv);
      break;
    }
    case K3_BASE_SUM: {
      uint64_t x = v[f.in[0]];
      for (int j = 0; j < d.nbits; j++) v[k3_ld(out + j)] = (x >> j) & 1;
      break;
    }
    case K3_RANDOM_ACCESS: {  // the host refuses an index past the list
      uint64_t idx = v[f.in[0]];
      v[f.out[0]] = idx < (uint64_t)(d.k_in - 1) ? v[k3_ld(d.in + i * d.k_in + 1 + idx)] : 0;
      for (int j = 0; j < d.nbits; j++) v[k3_ld(out + 1 + j)] = (idx >> j) & 1;
      break;
    }
  }
}

// Thread t's prefetch of level l of the walk over [.., last): the
// level's record (a level of no ops past the end) and, when the level
// has an op t and is not a Poseidon level, op t's rows.  rec: level l's
// record.
GL_HD void k3_prefetch(const int64_t* blob, const int64_t* rec, int l, int last, long long t,
                       K3Level& d, K3Fetch& f) {
  if (l >= last) {
    d.kind = -1;
    d.m = 0;
    return;
  }
  d = k3_level(blob, rec);
  if (d.kind != K3_POSEIDON && t < d.m) k3_fetch(d, t, f);
}

// A hint to bring the line at p into L2 (nothing on the host).
GL_HD void k3_prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// Thread t of a block of nthreads: hints that bring the blob span of the
// levels [first, last] (first's input reps to last's gate rows, the
// levels' arrays lying one after another) into L2, one line a hint, so
// that the walk's loads of index rows find them there.
GL_HD void k3_warm_l2(const K3Level& first, const K3Level& last, long long t, int nthreads) {
  const int64_t* end = last.rows + (last.kind == K3_POSEIDON ? last.m : 0);
  for (const int64_t* p = first.in + 16 * t; p < end; p += 16LL * nthreads) k3_prefetch_l2(p);
}

// Thread t's ops of a level other than Poseidon, of a block of nthreads:
// op t (its rows already in f), then t + nthreads, t + 2 nthreads, ...
GL_HD void k3_level_ops(const K3Level& d, long long t, int nthreads, K3Fetch& f, uint64_t* v) {
  for (long long i = t; i < d.m; i += nthreads) {
    if (i != t) k3_fetch(d, i, f);
    k3_apply(d, i, f, v);
  }
}

// ---------------------------------------------------------------------------
// A Poseidon level: a team of T threads a gate (T divides 12; a warp
// holds 32 / T teams and no team straddles two warps).  Thread j of a
// team owns lanes j + k*T, k < 12 / T, and writes their trace columns;
// each round's MDS layer is the team exchange of poseidon.cuh
// (team_provide, poseidon_mds_rows), in witness.cu.  The trace is
// iop/witness.py::_poseidon_trace's: the deltas, then the state
// after the round constants of full rounds 1-3, of the partial rounds
// (lane 0) and of the last four full rounds, each before its S-box.
// ---------------------------------------------------------------------------

// Block thread tid's team (teams numbered warp by warp; the lanes past
// the warp's last whole team get a team past every level's gates).
GL_HD int k3_team_index(int tid, int team) {
  const int per_warp = 32 / team, lane = tid & 31;
  return lane < per_warp * team ? (tid >> 5) * per_warp + lane / team : 1 << 30;
}

// The trace column of lane `lane` after round r's constants (rounds 1-3
// and the last four full rounds; a partial round records lane 0 alone).
GL_HD int k3_trace_col(int r, int lane) {
  constexpr int H = POSEIDON_HALF_FULL, PR = POSEIDON_PARTIAL, W = POSEIDON_WIDTH;
  if (r < H) return 4 + (r - 1) * W + lane;
  if (r < H + PR) return 4 + (H - 1) * W + (r - H);
  return 4 + (H - 1) * W + PR + (r - H - PR) * W + lane;
}

// Thread j's start of gate g (an active thread's, act): its lanes of the
// 12 inputs with the swap applied, the deltas of its lanes below 4
// written to trace[lane * n] (trace: the gate's first trace cell in the
// wire matrix, column-major with n rows).  A lane below 8 reads its swap
// partner (lane ^ 4) too, so that no exchange is needed whatever T.
template <int T>
GL_HD void k3_gate_start(const K3Level& d, long long g, int j, bool act, const uint64_t* v,
                         uint64_t s[POSEIDON_WIDTH / T], uint64_t* trace, long long n) {
  constexpr int L = POSEIDON_WIDTH / T;
  const int64_t* in = d.in + g * 13;
  const uint64_t swap = act ? v[k3_ld(in + 12)] : 0;
#pragma unroll
  for (int k = 0; k < L; k++) {
    const int lane = j + k * T;
    const uint64_t x = act ? v[k3_ld(in + lane)] : 0;
    if (lane < 8) {
      const uint64_t y = act ? v[k3_ld(in + (lane ^ 4))] : 0;
      const bool low = lane < 4;
      uint64_t dl = k3_mul(swap, low ? k3_sub(y, x) : k3_sub(x, y));
      s[k] = low ? gl_add(x, dl) : k3_sub(x, dl);
      if (act && low) trace[lane * n] = dl;
    } else {
      s[k] = x;
    }
  }
}

// x^7 with a chain of three products (x^2, then x^3 and x^4, then x^7)
// where poseidon_sbox's is four, for the same four products: a gate's
// rounds run on few warps, one dependent chain each.
GL_HD uint64_t k3_sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x3 = gl_mul(x2, x), x4 = gl_mul(x2, x2);
  return gl_mul(x4, x3);
}

// Thread j's local part of round r: the round constants on its lanes,
// their trace columns (every lane in a full round after the first, lane
// 0 by its owner in a partial one), the S-boxes.  rc: the 360 round
// constants, round-major.
template <int T, bool FULL>
GL_HD void k3_gate_round(uint64_t s[POSEIDON_WIDTH / T], int j, int r, const uint64_t* rc,
                         bool act, uint64_t* trace, long long n) {
  constexpr int L = POSEIDON_WIDTH / T;
#pragma unroll
  for (int k = 0; k < L; k++) s[k] = gl_add_canon_rhs(s[k], rc[r * POSEIDON_WIDTH + j + k * T]);
  if (FULL) {
    if (act && r > 0) {
#pragma unroll
      for (int k = 0; k < L; k++) trace[k3_trace_col(r, j + k * T) * n] = gl_canon(s[k]);
    }
#pragma unroll
    for (int k = 0; k < L; k++) s[k] = k3_sbox(s[k]);
  } else {
    if (act && j == 0) trace[k3_trace_col(r, 0) * n] = gl_canon(s[0]);
    uint64_t x = k3_sbox(s[0]);  // every thread runs it: no divergence
    s[0] = j == 0 ? x : s[0];
  }
}

// Thread j's end of gate g: its lanes of the 12 outputs, canonical.
template <int T>
GL_HD void k3_gate_end(const K3Level& d, long long g, int j, bool act,
                       const uint64_t s[POSEIDON_WIDTH / T], uint64_t* v) {
  constexpr int L = POSEIDON_WIDTH / T;
  if (!act) return;
#pragma unroll
  for (int k = 0; k < L; k++) v[k3_ld(d.out + g * POSEIDON_WIDTH + j + k * T)] = gl_canon(s[k]);
}

// k3_cells' thread t: cell t of the wire matrix w from its rep, or, past
// the ncells cells, public input t - ncells.
GL_HD void k3_cell(long long t, long long ncells, const int64_t* cell_pos,
                   const int64_t* cell_rep, long long npis, const int64_t* pi_rep,
                   const uint64_t* v, uint64_t* w, uint64_t* pis) {
  if (t < ncells)
    w[cell_pos[t]] = v[cell_rep[t]];
  else if (t < ncells + npis)
    pis[t - ncells] = v[pi_rep[t - ncells]];
}
