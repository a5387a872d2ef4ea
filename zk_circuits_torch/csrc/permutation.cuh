// The permutation argument's products over H (K6), shared by the CUDA
// kernels (permutation.cu) and a host build for testing.
//
// For each proof b, challenge c and point i of H (x = w^i), with the
// routed wires' values w_j (the NTT of the committed coefficients) and
// their sigmas s_j:
//   num_j = w_j + beta k_j x + gamma,  den_j = w_j + beta s_j + gamma,
//   ratio_t = prod_{j in chunk t} num_j / prod_{j in chunk t} den_j
// over chunks of q wires (the last one shorter where q does not divide
// the routed wires), total = prod_t ratio_t, Z = the exclusive prefix
// product of total over H (Z(0) = 1), and the partial products
// Z ratio_0 ... ratio_t for t < chunks - 1.  A chunk's denominator is
// inverted on its own (a^(p-2), so 1/0 is 0 as in the plain version; a
// batch inversion across the chunks would turn one zero into zeros for
// the whole point).
//
// k6_point (a thread a point) writes each point's running products
// ratio_0 ... ratio_t into the partial-product rows and its total into Z's
// row; k6_scan_block (a block a proof and challenge) turns the Z row into
// the exclusive prefix product in place, multiplies the partial-product
// rows by it, and writes the closing product (the inclusive product at the
// last point, 1 for a valid witness).  Output rows (B, nc (1 + pp), n):
// Z_0 .. Z_{nc-1}, then challenge 0's pp rows, challenge 1's, ...  A call
// takes at most K6_MAX_CH challenges; a circuit of more is launched once a
// group, its pointers at the group's first challenge (Z row c of the call,
// its partial products at rows pp_row + c pp, its closing products
// fin_bs apart a proof; plonk/permutation_cuda.py).
#pragma once

#include "perm_chunk.cuh"

#define K6_MAX_CH 4          // challenges a launch (the point kernel's products in registers)
#define K6_SEG 8             // consecutive points a scan thread owns

struct K6Call {
  const uint64_t* wv;                     // (batch, routed, n) wire values on H
  long long wv_rs, wv_ps;
  const uint64_t* sig;                    // (routed, n)
  long long sig_rs;
  const uint64_t* x;                      // (n,) the subgroup
  const uint64_t* kis;                    // (routed,) coset shifts
  const uint64_t* betas;                  // (nc, batch) each
  const uint64_t* gammas;
  uint64_t* out;                          // (batch, rows, n), rows n apart
  long long out_ps, pp_row;
  uint64_t* finals;                       // (batch, fin_bs)
  long long fin_bs;
  long long n;
  int routed, q, nc, batch;
};

GL_HD int k6_chunks(const K6Call& c) { return (c.routed + c.q - 1) / c.q; }

// a^(p-2) = 1/a (0 for 0) by an addition chain: a^(2^k - 1) for k = 2, 3,
// 6, 12, 24, 30, 31, 32, then (a^(2^31 - 1))^(2^33) a^(2^32 - 1), since
// p - 2 = (2^31 - 1) 2^33 + 2^32 - 1: 64 squarings and 9 products.
GL_HD uint64_t k6_sqn(uint64_t a, int n) {
  for (int k = 0; k < n; k++) a = gl_mul_m(a, a);
  return a;
}

GL_HD uint64_t k6_inverse(uint64_t a) {
  const uint64_t x2 = gl_mul_m(k6_sqn(a, 1), a);
  const uint64_t x3 = gl_mul_m(k6_sqn(x2, 1), a);
  const uint64_t x6 = gl_mul_m(k6_sqn(x3, 3), x3);
  const uint64_t x12 = gl_mul_m(k6_sqn(x6, 6), x6);
  const uint64_t x24 = gl_mul_m(k6_sqn(x12, 12), x12);
  const uint64_t x30 = gl_mul_m(k6_sqn(x24, 6), x6);
  const uint64_t x31 = gl_mul_m(k6_sqn(x30, 1), a);
  const uint64_t x32 = gl_mul_m(k6_sqn(x31, 1), a);
  return gl_mul_m(k6_sqn(x31, 33), x32);
}

// Point i of proof b, every challenge: the running products of the ratios
// into the partial-product rows, the total into Z's row.  bk:
// perm_bk_table's for proof b.
template <int NC>
GL_HD void k6_point(const K6Call& c, int b, long long i, const uint64_t* bk) {
  const int chunks = k6_chunks(c), pp = chunks - 1;
  const uint64_t x = gl_ld(c.x + i);
  uint64_t be[NC], ga[NC], run[NC], num[NC], den[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ch++) {
    be[ch] = gl_ld(c.betas + ch * c.batch + b);
    ga[ch] = gl_ld(c.gammas + ch * c.batch + b);
    run[ch] = 1;
  }
  uint64_t* out = c.out + b * c.out_ps + i;
  for (int t = 0; t < chunks; t++) {
    const int lo = t * c.q, hi = lo + c.q < c.routed ? lo + c.q : c.routed;
    perm_chunk<NC>(c.wv + b * c.wv_ps + i, c.wv_rs, c.sig + i, c.sig_rs, lo, hi, x, bk, be, ga,
                   num, den);
#pragma unroll
    for (int ch = 0; ch < NC; ch++) {
      run[ch] = gl_mul_m(run[ch], gl_mul_m(num[ch], k6_inverse(den[ch])));
      if (t < pp) out[(c.pp_row + ch * pp + t) * c.n] = gl_canon(run[ch]);
    }
  }
#pragma unroll
  for (int ch = 0; ch < NC; ch++) out[ch * c.n] = gl_canon(run[ch]);
}

// The scan's three phases over a tile of nthr * K6_SEG points from base,
// for the block of proof b and challenge ch.  Thread tid owns the points
// base + tid K6_SEG .. + K6_SEG (those below n).
//
// 1. Its points' inclusive product in place in the Z row; returns their
//    product (1 for none).
GL_HD uint64_t k6_seg_scan(const K6Call& c, int b, int ch, long long base, int tid) {
  uint64_t* z = c.out + b * c.out_ps + ch * c.n;
  uint64_t acc = 1;
  for (long long i = base + (long long)tid * K6_SEG, e = i + K6_SEG; i < e && i < c.n; i++) {
    acc = gl_mul_m(acc, z[i]);
    z[i] = acc;
  }
  return acc;
}

// 2. One step of the block's inclusive scan of the threads' products
//    (Hillis-Steele, from src into dst).
GL_HD void k6_scan_step(const uint64_t* src, uint64_t* dst, int d, int tid) {
  dst[tid] = tid >= d ? gl_mul_m(src[tid - d], src[tid]) : src[tid];
}

// 3. From excl, the product of every point before the thread's first: Z at
//    its points (the point's exclusive product; the in-place inclusive
//    products are read from the last point down, so each is read before it
//    is overwritten), and the partial-product rows times Z.
GL_HD void k6_seg_finish(const K6Call& c, int b, int ch, long long base, int tid,
                         uint64_t excl) {
  const int pp = k6_chunks(c) - 1;
  uint64_t* z = c.out + b * c.out_ps + ch * c.n;
  uint64_t* rows = c.out + b * c.out_ps + (c.pp_row + ch * pp) * c.n;
  const long long first = base + (long long)tid * K6_SEG;
  for (long long i = first + K6_SEG - 1; i >= first; i--) {
    if (i >= c.n) continue;
    const uint64_t zi = gl_canon(i > first ? gl_mul_m(excl, z[i - 1]) : excl);
    z[i] = zi;
    for (int t = 0; t < pp; t++) rows[t * c.n + i] = gl_canon(gl_mul_m(rows[t * c.n + i], zi));
  }
}

// The whole scan of proof b and challenge ch by one block of blk.threads()
// threads (a power of two): blk.each(f) runs f(tid) for each thread of the
// block, blk.sync() is the barrier; buf: 2 blk.threads() values of shared
// memory.
template <class Blk>
GL_HD void k6_scan_block(Blk& blk, const K6Call& c, int b, int ch, uint64_t* buf) {
  const int nthr = blk.threads();
  uint64_t carry = 1;
  for (long long base = 0; base < c.n; base += (long long)nthr * K6_SEG) {
    blk.each([&](int tid) { buf[tid] = k6_seg_scan(c, b, ch, base, tid); });
    blk.sync();
    int src = 0;
    for (int d = 1; d < nthr; d <<= 1) {
      blk.each([&](int tid) { k6_scan_step(buf + src * nthr, buf + (1 - src) * nthr, d, tid); });
      blk.sync();
      src ^= 1;
    }
    const uint64_t* incl = buf + src * nthr;
    blk.each([&](int tid) {
      k6_seg_finish(c, b, ch, base, tid, tid ? gl_mul_m(carry, incl[tid - 1]) : carry);
    });
    carry = gl_mul_m(carry, incl[nthr - 1]);
    blk.sync();
  }
  blk.each([&](int tid) {
    if (tid == 0) c.finals[b * c.fin_bs + ch] = gl_canon(carry);
  });
}

// What the kernels refuse: 0 or 1 (cudaErrorInvalidValue).
GL_HD int k6_valid(const K6Call& c) {
  return c.nc >= 1 && c.nc <= K6_MAX_CH && c.pp_row >= c.nc && c.fin_bs >= c.nc && c.n >= 1 &&
                 c.batch >= 1 && c.batch <= 65535 &&
                 c.routed >= 1 && c.routed <= PERM_MAX_ROUTED && c.q >= 1
             ? 0
             : 1;
}
