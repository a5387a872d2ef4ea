// The openings' and FRI's field arithmetic (K7, K8, K9), shared by the
// CUDA kernels (fri.cu) and a host build for testing.
//
// Extension elements are pairs (a0, a1) of GF(p^2) = GF(p)[x]/(x^2 - 7).
// The oracles' rows are base polynomials of n coefficients, read in place:
// FriRows lists up to FRI_MAX_SETS sets, each a (batch, rows, n) tensor
// given by its pointer and strides (batch stride 0: the circuit's
// constants/sigmas, one copy for every proof) and a table t (0 or 1).  Row
// r of a call is row r - (rows of the sets before) of its set.
//
// K7, the openings (k7_row_block, a block a proof and row):
//   e[b, r] = sum_i row_r[b, i] z_t[b]^i
// for the point z_t of proof b: zeta (t = 0) or g zeta (t = 1).  The
// powers are computed in place (each thread its first power by squaring
// and multiplying, then a running product), not read from a table.
// K8's point kernel, the alpha reduction (k8_point, a thread a proof and
// point):
//   comp_t[b, i] = sum over the rows r of table t of alpha[b]^e_r row_r[b, i]
// where row j of a set takes the exponent e = (the set's exp) + j; the
// block's table of powers of alpha is computed in shared memory.
// K8's scan, both divisions by a linear factor and their sum (k8_scan_block,
// a block a proof), from comp_0 at zeta (z_0) and comp_1 at g zeta (z_1):
//   E_t[i] = sum_{j > i} comp_t[j] z_t^j,  q_t[i] = E_t[i] z_t^-(i+1),
//   f[i] = q_1[i] + s q_0[i] for i < n - 1,  f[n - 1] = 0  (s = alpha^nz),
// the powers of z_t and of its inverse computed in place as in K7.
// K9, the fold (k9_point, a thread a proof and output coefficient):
//   new_c[m] = sum_j beta^j c[A m + j]  (Horner over j, A = 2^arity_bits).
// Every value in between is any u64 congruent to it (gl_mul_m,
// gl_add_lazy); the stores canonicalise.
#pragma once

#include "goldilocks.cuh"

#define FRI_MAX_SETS 8       // sets a FriRows holds
#define FRI_W 7ULL           // x^2 = 7
#define K8_SEG 16            // consecutive points a scan thread owns
#define K8_MAX_POW 1024      // powers of alpha a K8 point block keeps

// A read-only input, through the read-only path on the card.
GL_HD uint64_t fri_ld(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__ldg((const unsigned long long*)p);
#else
  return *p;
#endif
}

struct FriExt {
  uint64_t a, b;   // a + b x
};

GL_HD FriExt fri_eadd(FriExt x, FriExt y) {
  return {gl_add_lazy(x.a, y.a), gl_add_lazy(x.b, y.b)};
}

GL_HD FriExt fri_emul(FriExt x, FriExt y) {
  return {gl_add_lazy(gl_mul_m(x.a, y.a), gl_mul_m(gl_mul_m(x.b, y.b), FRI_W)),
          gl_add_lazy(gl_mul_m(x.a, y.b), gl_mul_m(x.b, y.a))};
}

// x + y s for base y.
GL_HD FriExt fri_madd_base(FriExt x, uint64_t y, FriExt s) {
  return {gl_add_lazy(x.a, gl_mul_m(y, s.a)), gl_add_lazy(x.b, gl_mul_m(y, s.b))};
}

GL_HD FriExt fri_pow(FriExt x, unsigned long long e) {
  FriExt r = {1, 0};
  for (; e; e >>= 1) {
    if (e & 1) r = fri_emul(r, x);
    x = fri_emul(x, x);
  }
  return r;
}

// 1/x (0 for 0): (a - b x) / (a^2 - 7 b^2), the norm's inverse as
// norm^(p - 2) by k6_inverse's addition chain.
GL_HD uint64_t fri_sqn(uint64_t a, int n) {
  for (int k = 0; k < n; k++) a = gl_mul_m(a, a);
  return a;
}

GL_HD FriExt fri_inverse(FriExt x) {
  const uint64_t a = gl_sub_lazy(gl_mul_m(x.a, x.a), gl_mul_m(gl_mul_m(x.b, x.b), FRI_W));
  const uint64_t x2 = gl_mul_m(fri_sqn(a, 1), a);
  const uint64_t x3 = gl_mul_m(fri_sqn(x2, 1), a);
  const uint64_t x6 = gl_mul_m(fri_sqn(x3, 3), x3);
  const uint64_t x12 = gl_mul_m(fri_sqn(x6, 6), x6);
  const uint64_t x24 = gl_mul_m(fri_sqn(x12, 12), x12);
  const uint64_t x30 = gl_mul_m(fri_sqn(x24, 6), x6);
  const uint64_t x31 = gl_mul_m(fri_sqn(x30, 1), a);
  const uint64_t x32 = gl_mul_m(fri_sqn(x31, 1), a);
  const uint64_t inv = gl_mul_m(fri_sqn(x31, 33), x32);
  return {gl_mul_m(x.a, inv), gl_mul_m(gl_sub_lazy(0, x.b), inv)};
}

GL_HD FriExt fri_ld_ext(const uint64_t* p0, const uint64_t* p1, long long i) {
  return {fri_ld(p0 + i), fri_ld(p1 + i)};
}

GL_HD void fri_st_ext(uint64_t* p0, uint64_t* p1, long long i, FriExt v) {
  p0[i] = gl_canon(v.a);
  p1[i] = gl_canon(v.b);
}

struct FriSet {
  const uint64_t* ptr;   // row 0 of proof 0
  long long bs, rs;      // batch stride (0: shared by the proofs), row stride
  int rows, table;       // rows; point (K7) or output (K8), 0 or 1
  int exp;               // K8: the power of alpha of row 0
};

struct FriRows {
  FriSet sets[FRI_MAX_SETS];
  long long n;           // coefficients a row, contiguous
  int nsets, rows, batch;
};

// Row r of proof b, and its table.
GL_HD const uint64_t* fri_row(const FriRows& t, int b, int r, int* table) {
  for (int s = 0; s < t.nsets; s++) {
    if (r < t.sets[s].rows) {
      *table = t.sets[s].table;
      return t.sets[s].ptr + b * t.sets[s].bs + r * t.sets[s].rs;
    }
    r -= t.sets[s].rows;
  }
  *table = 0;
  return t.sets[0].ptr;   // not reached for r < t.rows
}

GL_HD int fri_rows_valid(const FriRows& t) {
  int rows = 0;
  for (int s = 0; s < t.nsets; s++) {
    if (t.sets[s].rows < 0 || t.sets[s].table < 0 || t.sets[s].table > 1 ||
        t.sets[s].exp < 0)
      return 1;
    rows += t.sets[s].rows;
  }
  return t.nsets >= 1 && t.nsets <= FRI_MAX_SETS && rows == t.rows && t.rows >= 1 &&
                 t.n >= 1 && t.batch >= 1 && t.batch <= 65535
             ? 0
             : 1;
}

// --- K7: the openings ------------------------------------------------------

struct K7Call {
  FriRows r;
  const uint64_t* pts;     // (tables, 2, batch): component k of z_t[b] at (t 2 + k) batch + b
  uint64_t* out;           // (2, batch, rows): component k of e[b, r] at (k batch + b) rows + r
  int tables;              // 1 or 2
};

// Point t of proof b.
GL_HD FriExt fri_point(const uint64_t* pts, int batch, int t, int b) {
  return {fri_ld(pts + 2 * t * batch + b), fri_ld(pts + (2 * t + 1) * batch + b)};
}

// Row r of proof b by a block of blk.threads() threads (a power of two):
// each thread sums its coefficients' products with the powers of the
// row's point (the coefficients tid, tid + threads, ...: z^tid, then
// times z^threads), then a tree in buf (2 blk.threads() values) adds the
// threads' sums.
template <class Blk>
GL_HD void k7_row_block(Blk& blk, const K7Call& c, int b, int r, uint64_t* buf) {
  const int nthr = blk.threads();
  blk.each([&](int tid) {
    int t;
    const uint64_t* row = fri_row(c.r, b, r, &t);
    const FriExt z = fri_point(c.pts, c.r.batch, t, b);
    const FriExt step = fri_pow(z, (unsigned long long)nthr);
    FriExt p = fri_pow(z, (unsigned long long)tid);
    uint64_t s0 = 0, s1 = 0;
#pragma unroll 4
    for (long long i = tid; i < c.r.n; i += nthr) {
      const uint64_t x = fri_ld(row + i);
      s0 = gl_add_lazy(s0, gl_mul_m(x, p.a));
      s1 = gl_add_lazy(s1, gl_mul_m(x, p.b));
      p = fri_emul(p, step);
    }
    buf[tid] = s0;
    buf[nthr + tid] = s1;
  });
  blk.sync();
  for (int h = nthr / 2; h >= 1; h /= 2) {
    blk.each([&](int tid) {
      if (tid < h) {
        buf[tid] = gl_add_lazy(buf[tid], buf[tid + h]);
        buf[nthr + tid] = gl_add_lazy(buf[nthr + tid], buf[nthr + tid + h]);
      }
    });
    blk.sync();
  }
  blk.each([&](int tid) {
    if (tid == 0) {
      c.out[(long long)b * c.r.rows + r] = gl_canon(buf[0]);
      c.out[((long long)c.r.batch + b) * c.r.rows + r] = gl_canon(buf[nthr]);
    }
  });
}

GL_HD int k7_valid(const K7Call& c) {
  if (fri_rows_valid(c.r) || c.tables < 1 || c.tables > 2) return 1;
  for (int s = 0; s < c.r.nsets; s++)
    if (c.r.sets[s].table >= c.tables) return 1;
  return 0;
}

// --- K8: the alpha reduction and the composition -----------------------------

struct K8Call {
  FriRows r;
  const uint64_t* alpha;   // (1, 2, batch): each proof's alpha, as K7Call's pts
  uint64_t* out;           // (tables, 2, batch, n): comp_t's component k at ((t 2 + k) batch + b) n
  int tables;              // 1 or 2
  int npow;                // powers of alpha the sets take: max of exp + rows
};

// Proof b's powers alpha^e, e < npow, by thread tid of nthr: component 0
// at apow[e], 1 at apow[K8_MAX_POW + e].
GL_HD void k8_alpha_table(const K8Call& c, int b, uint64_t* apow, int tid, int nthr) {
  const FriExt a = fri_point(c.alpha, c.r.batch, 0, b);
  const FriExt step = fri_pow(a, (unsigned long long)nthr);
  FriExt p = fri_pow(a, (unsigned long long)tid);
  for (int e = tid; e < c.npow; e += nthr) {
    apow[e] = p.a;
    apow[K8_MAX_POW + e] = p.b;
    p = fri_emul(p, step);
  }
}

// Point i of proof b: every table's sum over its rows.  apow:
// k8_alpha_table's for proof b.
GL_HD void k8_point(const K8Call& c, int b, long long i, const uint64_t* apow) {
  FriExt acc0 = {0, 0}, acc1 = {0, 0};
  for (int s = 0; s < c.r.nsets; s++) {
    const FriSet& set = c.r.sets[s];
    const uint64_t* x = set.ptr + b * set.bs + i;
    const uint64_t* a = apow + set.exp;
    FriExt acc = {0, 0};
#pragma unroll 8
    for (int j = 0; j < set.rows; j++)
      acc = fri_madd_base(acc, fri_ld(x + j * set.rs), {a[j], a[K8_MAX_POW + j]});
    if (set.table == 0)
      acc0 = fri_eadd(acc0, acc);
    else
      acc1 = fri_eadd(acc1, acc);
  }
  const long long n = c.r.n, bn = (long long)c.r.batch * n;
  fri_st_ext(c.out, c.out + bn, b * n + i, acc0);
  if (c.tables > 1) fri_st_ext(c.out + 2 * bn, c.out + 3 * bn, b * n + i, acc1);
}

GL_HD int k8_valid(const K8Call& c) {
  if (fri_rows_valid(c.r) || c.tables < 1 || c.tables > 2 || c.npow > K8_MAX_POW) return 1;
  for (int s = 0; s < c.r.nsets; s++)
    if (c.r.sets[s].table >= c.tables || c.r.sets[s].exp + c.r.sets[s].rows > c.npow) return 1;
  return 0;
}

struct K8ScanCall {
  const uint64_t* comp[4]; // (batch, n) each: comp_0's components, then comp_1's
  const uint64_t* pts;     // (3, 2, batch): zeta, g zeta and alpha^nz, as K7Call's pts
  uint64_t* f[2];          // (batch, n)
  long long n;
  int batch;
};

GL_HD FriExt k8_comp(const K8ScanCall& c, int t, long long o) {
  return fri_ld_ext(c.comp[2 * t], c.comp[2 * t + 1], o);
}

// The scan's phases over a tile of nthr K8_SEG points from base, for the
// block of proof b.  Thread tid owns the points base + tid K8_SEG .. +
// K8_SEG (those below n).  w_t[i] = comp_t[i] z_t^i.
//
// 1. Its points' sums of w_0 and w_1 into buf[k nthr + tid], k = 0..3.
GL_HD void k8_seg_sum(const K8ScanCall& c, int b, long long base, int tid, int nthr,
                      uint64_t* buf) {
  FriExt s0 = {0, 0}, s1 = {0, 0};
  const long long first = base + (long long)tid * K8_SEG;
  const FriExt z0 = fri_point(c.pts, c.batch, 0, b), z1 = fri_point(c.pts, c.batch, 1, b);
  FriExt p0 = fri_pow(z0, (unsigned long long)first), p1 = fri_pow(z1, (unsigned long long)first);
#pragma unroll 4
  for (int k = 0; k < K8_SEG; k++) {
    const long long i = first + k;
    if (i >= c.n) break;
    const long long o = b * c.n + i;
    s0 = fri_eadd(s0, fri_emul(k8_comp(c, 0, o), p0));
    s1 = fri_eadd(s1, fri_emul(k8_comp(c, 1, o), p1));
    p0 = fri_emul(p0, z0);
    p1 = fri_emul(p1, z1);
  }
  buf[tid] = s0.a;
  buf[nthr + tid] = s0.b;
  buf[2 * nthr + tid] = s1.a;
  buf[3 * nthr + tid] = s1.b;
}

// 2. One step of the block's inclusive suffix sum of the threads' sums
//    (Hillis-Steele, from src into dst, 4 nthr values each).
GL_HD void k8_scan_step(const uint64_t* src, uint64_t* dst, int d, int tid, int nthr) {
  for (int k = 0; k < 4; k++) {
    const uint64_t* s = src + k * nthr;
    dst[k * nthr + tid] = tid + d < nthr ? gl_add_lazy(s[tid], s[tid + d]) : s[tid];
  }
}

// 3. From e0 and e1, the sums of w_0 and w_1 over every point after the
//    thread's last, f at its points from the last below n down: at point
//    i the powers z_t^i (times 1/z_t a step) and z_t^-(i+1) (times z_t).
GL_HD void k8_seg_finish(const K8ScanCall& c, int b, long long base, int tid, FriExt e0,
                         FriExt e1) {
  const long long first = base + (long long)tid * K8_SEG;
  if (first >= c.n) return;
  const long long last = first + K8_SEG <= c.n ? first + K8_SEG - 1 : c.n - 1;
  const FriExt z0 = fri_point(c.pts, c.batch, 0, b), z1 = fri_point(c.pts, c.batch, 1, b);
  const FriExt s = fri_point(c.pts, c.batch, 2, b);
  const FriExt zi0 = fri_inverse(z0), zi1 = fri_inverse(z1);
  FriExt p0 = fri_pow(z0, (unsigned long long)last), p1 = fri_pow(z1, (unsigned long long)last);
  FriExt q0 = fri_pow(zi0, (unsigned long long)last + 1);
  FriExt q1 = fri_pow(zi1, (unsigned long long)last + 1);
#pragma unroll 4
  for (long long i = last; i >= first; i--) {
    const long long o = b * c.n + i;
    FriExt f = {0, 0};
    if (i + 1 < c.n) f = fri_eadd(fri_emul(e1, q1), fri_emul(s, fri_emul(e0, q0)));
    fri_st_ext(c.f[0], c.f[1], o, f);
    e0 = fri_eadd(e0, fri_emul(k8_comp(c, 0, o), p0));
    e1 = fri_eadd(e1, fri_emul(k8_comp(c, 1, o), p1));
    p0 = fri_emul(p0, zi0);
    p1 = fri_emul(p1, zi1);
    q0 = fri_emul(q0, z0);
    q1 = fri_emul(q1, z1);
  }
}

// The whole composition of proof b by one block of blk.threads() threads
// (a power of two), tile by tile from the last, with the sums of the later
// tiles carried: blk.each(f) runs f(tid) for each thread, blk.sync() is
// the barrier; buf: 8 blk.threads() values of shared memory.
template <class Blk>
GL_HD void k8_scan_block(Blk& blk, const K8ScanCall& c, int b, uint64_t* buf) {
  const int nthr = blk.threads();
  const long long tile = (long long)nthr * K8_SEG;
  uint64_t carry[4] = {0, 0, 0, 0};
  for (long long base = (c.n - 1) / tile * tile; base >= 0; base -= tile) {
    blk.each([&](int tid) { k8_seg_sum(c, b, base, tid, nthr, buf); });
    blk.sync();
    int src = 0;
    for (int d = 1; d < nthr; d <<= 1) {
      blk.each([&](int tid) {
        k8_scan_step(buf + src * 4 * nthr, buf + (1 - src) * 4 * nthr, d, tid, nthr);
      });
      blk.sync();
      src ^= 1;
    }
    const uint64_t* incl = buf + src * 4 * nthr;
    blk.each([&](int tid) {
      uint64_t e[4];
      for (int k = 0; k < 4; k++)
        e[k] = tid + 1 < nthr ? gl_add_lazy(carry[k], incl[k * nthr + tid + 1]) : carry[k];
      k8_seg_finish(c, b, base, tid, {e[0], e[1]}, {e[2], e[3]});
    });
    for (int k = 0; k < 4; k++) carry[k] = gl_add_lazy(carry[k], incl[k * nthr]);
    blk.sync();
  }
}

GL_HD int k8_scan_valid(const K8ScanCall& c) {
  return c.n >= 1 && c.batch >= 1 && c.batch <= 65535 ? 0 : 1;
}

// --- K9: the fold ------------------------------------------------------------

struct K9Call {
  const uint64_t* c[2];    // (batch, m 2^arity_bits) components, rows c_bs apart
  long long c_bs;
  const uint64_t* beta[2]; // (batch,)
  uint64_t* out[2];        // (batch, m) components
  long long m;
  int arity_bits, batch;
};

// Output coefficient k of proof b.
GL_HD void k9_point(const K9Call& c, int b, long long k) {
  const int arity = 1 << c.arity_bits;
  const long long o = b * c.c_bs + k * arity;
  const FriExt beta = {fri_ld(c.beta[0] + b), fri_ld(c.beta[1] + b)};
  FriExt acc = fri_ld_ext(c.c[0], c.c[1], o + arity - 1);
  for (int j = arity - 2; j >= 0; j--)
    acc = fri_eadd(fri_emul(acc, beta), fri_ld_ext(c.c[0], c.c[1], o + j));
  fri_st_ext(c.out[0], c.out[1], b * c.m + k, acc);
}

GL_HD int k9_valid(const K9Call& c) {
  return c.arity_bits >= 1 && c.arity_bits <= 4 && c.m >= 1 && c.batch >= 1 &&
                 c.batch <= 65535
             ? 0
             : 1;
}
