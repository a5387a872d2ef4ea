// The vanishing polynomial over the LDE coset (K5): the arithmetic of one
// coset point of one proof, shared by the CUDA kernel (quotient.cu) and a
// host build for testing.
//
// For each challenge c the value at a point x is the Horner reduction by
// alpha_c of the terms
//   [ L1(x) (Z_c(x) - 1),
//     the permutation argument's chunk terms (plonk/vanishing.py:116),
//     the M gate constraint slots (plonk/vanishing.py:43) ]
// times 1/Z_H(x).  Horner over N terms is sum_j t_j alpha^(N-1-j), linear
// in the slots, so no slot array is kept: the L1 and chunk terms fold by
// Horner and are scaled by alpha^M, and each gate's constraints t_k are
// summed as t_k alpha^(M-1-k) (the slot of its k-th constraint is k),
// scaled by its selector filter and added in.  Field arithmetic is exact,
// so this order gives the integers of the plain version.  Values stay in
// [0, 2^64) (gl_mul_m, gl_add_lazy, gl_sub_lazy) until the output is made
// canonical.
//
// What bounds K5 on the H100, and what the design does about it.  A
// wormhole point is ~1.6k products and ~70k integer instructions in
// dependent chains (the permutation argument's running products, the
// Poseidon gate's S-boxes and rounds, the fold), and the card holds 16
// warps an SM at 128 registers: latency more than throughput.  Taking parts
// away on the card (scripts/k5_variants.py) shows the permutation
// argument ~30% of the time, the S-boxes ~20%, the fold ~7% and the MDS
// layers ~2%.  So the design shortens chains and frees registers: each
// gate's constraints go into an unreduced sum of products with alpha's
// powers (gl_acc_mac: 13 instructions where Horner's product and add took
// ~30, and no chain through a reduction), a chunk's factors are
// multiplied in pairs (perm_chunk.cuh), w + gamma is shared by the two
// factors of a wire, and a block of 256 threads is held to 128 registers
// (uncapped the compiler took 159-182 and one block an SM; at 128 threads
// the NC = 2 kernel spilled).
//
// The circuit blob (int64, built by plonk/quotient_cuda.py, once a
// circuit and device): a header of K5_HEAD fields, the routed wires' coset
// shifts k_j, then one record of K5_GATE_FIELDS a gate type: its kind and
// parameters, its selector column, its filter constants (the other gates
// of its selector group, and the unused-selector index when there are
// several groups: the filter is the product of (f - s)) and M - K (its
// last constraint's power of alpha).
#pragma once

#include "goldilocks.cuh"
#include "perm_chunk.cuh"
#include "poseidon.cuh"

// member functions (GL_HD is static on the host)
#ifdef __CUDACC__
#define K5_MEMBER __host__ __device__ __forceinline__
#else
#define K5_MEMBER inline
#endif

#define K5_MAX_CH 4          // challenges a launch (the fold's accumulators in registers)
#define K5_MAX_POW 256       // powers of alpha a block keeps: M up to 255 slots
#define K5_MAX_FILT 8        // filter constants a gate
#define K5_RA_MAX_BITS 16    // a random-access gate's index bits

// gate kinds (plonk/quotient_cuda.py KINDS)
#define K5_NOOP 0
#define K5_CONSTANT 1        // p0: constants
#define K5_PUBLIC_INPUT 2
#define K5_ARITH 3           // p0: ops
#define K5_BASE_SUM 4        // p0: limbs
#define K5_ARITH_EXT 5       // p0: ops, p1: W
#define K5_RANDOM_ACCESS 6   // p0: bits, p1: copies
#define K5_POSEIDON 7

// the blob's header
#define K5_HEAD 16
#define K5_H_GATES 0
#define K5_H_SELECTORS 1
#define K5_H_CONSTANTS 2
#define K5_H_ROUTED 3
#define K5_H_Q 4             // wires a chunk of the permutation argument
#define K5_H_CHUNKS 5
#define K5_H_PP 6            // partial products a challenge (chunks - 1)
#define K5_H_SLOTS 7         // M, the gate constraint slots
#define K5_H_CHALLENGES 8
#define K5_H_WIRES 9
// a gate record
#define K5_GATE_FIELDS 16
#define K5_G_KIND 0
#define K5_G_P0 1
#define K5_G_P1 2
#define K5_G_SEL 3
#define K5_G_NFILT 4
#define K5_G_SHIFT 5         // M - K: the power of alpha of the gate's last constraint
#define K5_G_FILT 6          // K5_MAX_FILT constants

// One call: the values of `points` coset points (rows row0 .. row0 +
// points of the coset tables) for `batch` proofs and `nc` challenges.
// Every matrix is column-major, a row of points (stride 1), rows *_rs
// apart and proofs *_ps apart.  zs at g x for point i is znext[b zn_ps + c
// zn_rs + (i + zn_shift) mod zn_len]: the zs rows themselves shifted by
// 2^rate_bits with wrap-around on one card, a shard's rows and its halo on
// a mesh.  Challenge c's zs row is zsp's row c and its partial products
// rows pp_row + c pp ..: a circuit of more than K5_MAX_CH challenges is
// launched once a group of at most K5_MAX_CH, the pointers at the group's
// first challenge's rows (plonk/quotient_cuda.py).
struct K5Call {
  const int64_t* circuit;                 // the circuit blob
  const uint64_t* cs;                     // selectors, constants, sigmas
  long long cs_rs;
  const uint64_t* wires;                  // (batch, wires, points)
  long long w_rs, w_ps;
  const uint64_t* zsp;                    // (batch, rows, points): zs, partial products
  long long z_rs, z_ps, pp_row;
  const uint64_t* znext;                  // zs at g x
  long long zn_rs, zn_ps, zn_shift, zn_len;
  const uint64_t* x;                      // the coset tables, read at row0 + i
  const uint64_t* l1;
  const uint64_t* zh_inv;
  long long row0;
  const uint64_t* pi_hash;                // (batch, 4)
  const uint64_t* betas;                  // (nc, batch) each
  const uint64_t* gammas;
  const uint64_t* alphas;
  uint64_t* out;                          // (nc, batch, points), canonical
  long long points;
  int batch, nc;
};

GL_HD long long k5_field(const int64_t* p) { return (long long)gl_ld((const uint64_t*)p); }

GL_HD uint64_t k5_pow(uint64_t a, long long e) {
  uint64_t r = 1;
  while (e > 0) {
    if (e & 1) r = gl_mul_m(r, a);
    e >>= 1;
    if (e) a = gl_mul_m(a, a);
  }
  return r;
}

// Proof b's alpha_c^e for e <= M (apow[c K5_MAX_POW + e]), thread tid of
// nthr.
template <int NC>
GL_HD void k5_alpha_table(const K5Call& c, int b, uint64_t* apow, int tid, int nthr) {
  const long long m = k5_field(c.circuit + K5_H_SLOTS);
  for (long long e = tid; e <= m; e += nthr) {
#pragma unroll
    for (int ch = 0; ch < NC; ch++)
      apow[ch * K5_MAX_POW + e] = k5_pow(gl_ld(c.alphas + ch * c.batch + b), e);
  }
}

// Proof b's tables for the first launch, thread tid of nthr: beta_c k_j
// (bk[c PERM_MAX_ROUTED + j]) and alpha_c^M (am[c]).
template <int NC>
GL_HD void k5_perm_tables(const K5Call& c, int b, uint64_t* am, uint64_t* bk, int tid,
                          int nthr) {
  const long long m = k5_field(c.circuit + K5_H_SLOTS);
  for (int ch = tid; ch < NC; ch += nthr) am[ch] = k5_pow(gl_ld(c.alphas + ch * c.batch + b), m);
  perm_bk_table<NC>((const uint64_t*)(c.circuit + K5_HEAD), k5_field(c.circuit + K5_H_ROUTED),
                    c.betas, c.batch, b, bk, tid, nthr);
}

// Point i of proof b: its inputs.
struct K5Point {
  const K5Call& c;
  int b;
  long long i;

  K5_MEMBER uint64_t wire(long long j) const { return gl_ld(c.wires + b * c.w_ps + j * c.w_rs + i); }
  K5_MEMBER uint64_t cs(long long k) const { return gl_ld(c.cs + k * c.cs_rs + i); }
  K5_MEMBER uint64_t zsp(long long k) const { return gl_ld(c.zsp + b * c.z_ps + k * c.z_rs + i); }
  K5_MEMBER uint64_t znext(int ch) const {
    long long k = i + c.zn_shift;
    k = k >= c.zn_len ? k - c.zn_len : k;
    return gl_ld(c.znext + b * c.zn_ps + ch * c.zn_rs + k);
  }
  K5_MEMBER uint64_t pi(int k) const { return gl_ld(c.pi_hash + 4LL * b + k); }
};

// A gate's constraints t_k, every challenge: sum_k t_k alpha_c^(M - 1 - k),
// each product added to an unreduced sum (gl_acc_mac) from the block's
// table of powers (apow: k5_alpha_table's), reduced once a gate.  (Horner's fold
// by alpha, t_k alpha^(K-1-k) scaled by alpha^(M-K), gives the same field
// elements at a reduced product and an add a constraint.)
template <int NC>
struct K5Fold {
  GlAcc g[NC];
  const uint64_t* apow;
  int e;   // the power of alpha of the next constraint

  K5_MEMBER void put(uint64_t t) {
#pragma unroll
    for (int ch = 0; ch < NC; ch++) gl_acc_mac(g[ch], t, apow[ch * K5_MAX_POW + e]);
    e--;
  }
};

// --- the gates, each in the constraint order of its eval (iop/gates.py) ---

template <int NC>
GL_HD void k5_constant(const K5Point& p, long long cst, long long n, K5Fold<NC>& f) {
  for (long long k = 0; k < n; k++) f.put(gl_sub_lazy(p.wire(k), p.cs(cst + k)));
}

template <int NC>
GL_HD void k5_public_input(const K5Point& p, K5Fold<NC>& f) {
  for (int k = 0; k < 4; k++) f.put(gl_sub_lazy(p.wire(k), p.pi(k)));
}

// out = c0 m0 m1 + c1 addend, wires 4 op ..
template <int NC>
GL_HD void k5_arith(const K5Point& p, long long cst, long long ops, K5Fold<NC>& f) {
  const uint64_t c0 = p.cs(cst), c1 = p.cs(cst + 1);
  for (long long op = 0; op < ops; op++) {
    const uint64_t m = gl_mul_m(p.wire(4 * op), p.wire(4 * op + 1));
    const uint64_t t = gl_add_lazy(gl_mul_m(c0, m), gl_mul_m(c1, p.wire(4 * op + 2)));
    f.put(gl_sub_lazy(t, p.wire(4 * op + 3)));
  }
}

// wire 0 - sum_k 2^k wire(1 + k), then wire(1 + k)^2 - wire(1 + k).
template <int NC>
GL_HD void k5_base_sum(const K5Point& p, long long limbs, K5Fold<NC>& f) {
  uint64_t acc = 0;
  for (long long k = limbs - 1; k >= 0; k--) acc = gl_add_lazy(gl_add_lazy(acc, acc), p.wire(1 + k));
  f.put(gl_sub_lazy(p.wire(0), acc));
  for (long long k = 0; k < limbs; k++) {
    const uint64_t b = p.wire(1 + k);
    f.put(gl_sub_lazy(gl_mul_m(b, b), b));
  }
}

// Over GF(p)[phi]/(phi^2 - w): out = c0 (m0 m1) + c1 addend, wires 8 op ..
template <int NC>
GL_HD void k5_arith_ext(const K5Point& p, long long cst, long long ops, uint64_t w,
                        K5Fold<NC>& f) {
  const uint64_t c0 = p.cs(cst), c1 = p.cs(cst + 1);
  for (long long op = 0; op < ops; op++) {
    const long long o = 8 * op;
    const uint64_t m00 = p.wire(o), m01 = p.wire(o + 1), m10 = p.wire(o + 2),
                   m11 = p.wire(o + 3);
    const uint64_t p0 = gl_add_lazy(gl_mul_m(m00, m10), gl_mul_m(gl_mul_m(m01, m11), w));
    const uint64_t p1 = gl_add_lazy(gl_mul_m(m00, m11), gl_mul_m(m01, m10));
    f.put(gl_sub_lazy(gl_add_lazy(gl_mul_m(c0, p0), gl_mul_m(c1, p.wire(o + 4))), p.wire(o + 6)));
    f.put(gl_sub_lazy(gl_add_lazy(gl_mul_m(c0, p1), gl_mul_m(c1, p.wire(o + 5))), p.wire(o + 7)));
  }
}

// A copy: its bits' booleanity, the index recomposition, and the list
// folded by the bits, LSB first (lo + b (hi - lo)), against the claimed
// element.  The fold runs over the list in order with a stack of one value
// a level (a pair completes at a level when the entry's index has that
// bit set), which combines the same pairs with the same bits as the
// level-by-level fold.
template <int NC>
GL_HD void k5_random_access(const K5Point& p, long long bits, long long copies,
                            K5Fold<NC>& f) {
  const long long v = 1LL << bits;
  for (long long cp = 0; cp < copies; cp++) {
    const long long base = cp * (v + 2), bb = copies * (v + 2) + cp * bits;
    for (long long j = 0; j < bits; j++) {
      const uint64_t b = p.wire(bb + j);
      f.put(gl_sub_lazy(gl_mul_m(b, b), b));
    }
    uint64_t acc = 0;
    for (long long j = bits - 1; j >= 0; j--) acc = gl_add_lazy(gl_add_lazy(acc, acc), p.wire(bb + j));
    f.put(gl_sub_lazy(p.wire(base), acc));
    uint64_t st[K5_RA_MAX_BITS + 1];
    for (long long k = 0; k < v; k++) {
      uint64_t e = p.wire(base + 2 + k);
      long long lvl = 0;
      for (long long kk = k; kk & 1; kk >>= 1, lvl++)
        e = gl_add_lazy(st[lvl], gl_mul_m(p.wire(bb + lvl), gl_sub_lazy(e, st[lvl])));
      st[lvl] = e;
    }
    f.put(gl_sub_lazy(st[bits], p.wire(base + 1)));
  }
}

// The width-12 Poseidon permutation in one row, in the naive partial-round
// form (wire layout: iop/gates.py PoseidonGate).  rc: the 360 round
// constants, round-major.  (The fast partial rounds of
// compat/poseidon_fast.py, a dense layer and then a sparse one a round with
// multiply-add sums, took as long on the H100: scripts/k5_variants.py.)
template <int NC>
GL_HD void k5_poseidon(const K5Point& p, const uint64_t* rc, K5Fold<NC>& f) {
  constexpr int W = POSEIDON_WIDTH, H = POSEIDON_HALF_FULL, R = POSEIDON_PARTIAL;
  const uint64_t swap = p.wire(24);
  f.put(gl_sub_lazy(gl_mul_m(swap, swap), swap));
  uint64_t s[W];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const uint64_t lhs = p.wire(k), rhs = p.wire(4 + k), d = p.wire(25 + k);
    f.put(gl_sub_lazy(gl_mul_m(swap, gl_sub_lazy(rhs, lhs)), d));
    s[k] = gl_add_lazy(lhs, d);
    s[4 + k] = gl_sub_lazy(rhs, d);
  }
#pragma unroll
  for (int k = 8; k < W; k++) s[k] = p.wire(k);
#pragma unroll 1
  for (int r = 0; r < H; r++) {
#pragma unroll
    for (int k = 0; k < W; k++) {
      s[k] = gl_add_canon_rhs(s[k], rc[r * W + k]);
      if (r > 0) {
        const uint64_t wv = p.wire(29 + (r - 1) * W + k);
        f.put(gl_sub_lazy(s[k], wv));
        s[k] = wv;
      }
      s[k] = poseidon_sbox(s[k]);
    }
    poseidon_mds_freq(s);
  }
#pragma unroll 1
  for (int r = H; r < H + R; r++) {
#pragma unroll
    for (int k = 0; k < W; k++) s[k] = gl_add_canon_rhs(s[k], rc[r * W + k]);
    const uint64_t wv = p.wire(65 + r - H);
    f.put(gl_sub_lazy(s[0], wv));
    s[0] = poseidon_sbox(wv);
    poseidon_mds_freq(s);
  }
#pragma unroll 1
  for (int r = H + R; r < 2 * H + R; r++) {
#pragma unroll
    for (int k = 0; k < W; k++) {
      const uint64_t wv = p.wire(87 + (r - H - R) * W + k);
      f.put(gl_sub_lazy(gl_add_canon_rhs(s[k], rc[r * W + k]), wv));
      s[k] = poseidon_sbox(wv);
    }
    poseidon_mds_freq(s);
  }
#pragma unroll
  for (int k = 0; k < W; k++) f.put(gl_sub_lazy(s[k], p.wire(12 + k)));
}

// K5's first launch at point i of proof b: the L1 term and the permutation
// argument's chunk terms of every challenge, Horner's fold by alpha_c,
// times alpha_c^M, into c.out (any u64 congruent to it).  bk: proof b's
// perm_bk_table; am: its alpha_c^M.
template <int NC>
GL_HD void k5_perm_point(const K5Call& c, int b, long long i, const uint64_t* am,
                         const uint64_t* bk) {
  const int64_t* h = c.circuit;
  const long long sig = k5_field(h + K5_H_SELECTORS) + k5_field(h + K5_H_CONSTANTS);
  const long long routed = k5_field(h + K5_H_ROUTED), q = k5_field(h + K5_H_Q);
  const long long chunks = k5_field(h + K5_H_CHUNKS), pp = k5_field(h + K5_H_PP);
  const K5Point p{c, b, i};
  const uint64_t x = gl_ld(c.x + c.row0 + i), l1 = gl_ld(c.l1 + c.row0 + i);
  uint64_t al[NC], be[NC], ga[NC], acc[NC], prev[NC], num[NC], den[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ch++) {
    al[ch] = gl_ld(c.alphas + ch * c.batch + b);
    be[ch] = gl_ld(c.betas + ch * c.batch + b);
    ga[ch] = gl_ld(c.gammas + ch * c.batch + b);
    prev[ch] = p.zsp(ch);
    acc[ch] = gl_mul_m(l1, gl_sub_lazy(prev[ch], 1));
  }
  // a term a chunk of q routed wires
  for (long long t = 0; t < chunks; t++) {
    const long long lo = t * q, hi = lo + q < routed ? lo + q : routed;
    perm_chunk<NC>(c.wires + b * c.w_ps + i, c.w_rs, c.cs + sig * c.cs_rs + i, c.cs_rs, lo, hi,
                   x, bk, be, ga, num, den);
#pragma unroll
    for (int ch = 0; ch < NC; ch++) {
      const uint64_t cur = t < pp ? p.zsp(c.pp_row + ch * pp + t) : p.znext(ch);
      const uint64_t term = gl_sub_lazy(gl_mul_m(cur, den[ch]), gl_mul_m(prev[ch], num[ch]));
      acc[ch] = gl_add_lazy(gl_mul_m(acc[ch], al[ch]), term);
      prev[ch] = cur;
    }
  }
#pragma unroll
  for (int ch = 0; ch < NC; ch++)
    c.out[(ch * (long long)c.batch + b) * c.points + i] = gl_mul_m(acc[ch], am[ch]);
}

// K5's second launch at point i of proof b: every gate type's constraints
// added to the first launch's value in c.out, times 1/Z_H(x), canonical.
// apow: proof b's k5_alpha_table; rc: the round constants.
template <int NC>
GL_HD void k5_gate_point(const K5Call& c, int b, long long i, const uint64_t* apow,
                         const uint64_t* rc) {
  const int64_t* h = c.circuit;
  const long long cst = k5_field(h + K5_H_SELECTORS), routed = k5_field(h + K5_H_ROUTED);
  const long long m = k5_field(h + K5_H_SLOTS), gates = k5_field(h + K5_H_GATES);
  const K5Point p{c, b, i};
  uint64_t acc[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ch++) acc[ch] = c.out[(ch * (long long)c.batch + b) * c.points + i];
  for (long long gi = 0; gi < gates; gi++) {
    const int64_t* g = h + K5_HEAD + routed + gi * K5_GATE_FIELDS;
    const long long kind = k5_field(g + K5_G_KIND);
    if (kind == K5_NOOP) continue;
    const long long p0 = k5_field(g + K5_G_P0), p1 = k5_field(g + K5_G_P1);
    K5Fold<NC> f;
#pragma unroll
    for (int ch = 0; ch < NC; ch++) f.g[ch] = gl_acc_zero();
    f.apow = apow;
    f.e = (int)m - 1;
    switch (kind) {
      case K5_CONSTANT: k5_constant<NC>(p, cst, p0, f); break;
      case K5_PUBLIC_INPUT: k5_public_input<NC>(p, f); break;
      case K5_ARITH: k5_arith<NC>(p, cst, p0, f); break;
      case K5_BASE_SUM: k5_base_sum<NC>(p, p0, f); break;
      case K5_ARITH_EXT: k5_arith_ext<NC>(p, cst, p0, (uint64_t)p1, f); break;
      case K5_RANDOM_ACCESS: k5_random_access<NC>(p, p0, p1, f); break;
      default: k5_poseidon<NC>(p, rc, f); break;
    }
    const long long nf = k5_field(g + K5_G_NFILT);
    if (nf) {
      const uint64_t s = p.cs(k5_field(g + K5_G_SEL));
      uint64_t filt = gl_sub_lazy((uint64_t)k5_field(g + K5_G_FILT), s);
      for (long long k = 1; k < nf; k++)
        filt = gl_mul_m(filt, gl_sub_lazy((uint64_t)k5_field(g + K5_G_FILT + k), s));
#pragma unroll
      for (int ch = 0; ch < NC; ch++)
        acc[ch] = gl_add_lazy(acc[ch], gl_mul_m(gl_acc_value(f.g[ch]), filt));
    } else {
#pragma unroll
      for (int ch = 0; ch < NC; ch++) acc[ch] = gl_add_lazy(acc[ch], gl_acc_value(f.g[ch]));
    }
  }
  const uint64_t zi = gl_ld(c.zh_inv + c.row0 + i);
#pragma unroll
  for (int ch = 0; ch < NC; ch++)
    c.out[(ch * (long long)c.batch + b) * c.points + i] = gl_canon(gl_mul_m(acc[ch], zi));
}

// What the kernel refuses: 0 or a CUDA error code (cudaErrorInvalidValue).
GL_HD int k5_valid(const K5Call& c) {
  return c.nc >= 1 && c.nc <= K5_MAX_CH && c.pp_row >= c.nc && c.points >= 1 && c.batch >= 1 &&
                 c.batch <= 65535 && c.zn_len >= 1 && c.zn_shift >= 0 &&
                 c.zn_shift < c.zn_len
             ? 0
             : 1;
}
