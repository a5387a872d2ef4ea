// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on native u64, shared
// by the CUDA kernels and by a host build for testing.
//
// Values may be non-canonical (any u64 congruent to the true value): the
// Poseidon rounds chain through gl_mul/gl_add_canon_rhs without
// canonicalising, and only the digest lanes go through gl_canon.  The
// reduction uses 2^64 = 2^32 - 1 (mod p).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GL_HD __host__ __device__ __forceinline__
#else
#define GL_HD static inline
#endif

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p

// a + b over 64 bits and the carry out (0 or 1).  On the card the carry
// comes from the adder's flag (add.cc / addc), with no compare.
GL_HD uint64_t gl_add_carry(uint64_t a, uint64_t b, uint32_t* carry) {
#ifdef __CUDA_ARCH__
  uint64_t s;
  asm("add.cc.u64 %0, %2, %3;\n\taddc.u32 %1, 0, 0;" : "=l"(s), "=r"(*carry) : "l"(a), "l"(b));
  return s;
#else
  uint64_t s = a + b;
  *carry = s < a;
  return s;
#endif
}

// a - b over 64 bits and the borrow out (0 or 1).
GL_HD uint64_t gl_sub_borrow(uint64_t a, uint64_t b, uint32_t* borrow) {
#ifdef __CUDA_ARCH__
  uint64_t d;
  uint32_t m;
  asm("sub.cc.u64 %0, %2, %3;\n\tsubc.u32 %1, 0, 0;" : "=l"(d), "=r"(m) : "l"(a), "l"(b));
  *borrow = m & 1;
  return d;
#else
  *borrow = a < b;
  return a - b;
#endif
}

// (lo + 2^64 * hi) mod p, non-canonical: the result may lie in [p, 2^64).
GL_HD uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  uint32_t b, c;
  uint64_t t0 = gl_sub_borrow(lo, hi >> 32, &b);
  t0 -= (uint64_t)(0u - b);  // borrow: 2^64 = EPS, cannot underflow again
  uint64_t hl = hi & GL_EPS;
  uint64_t t2 = gl_add_carry(t0, (hl << 32) - hl, &c);  // hl * EPS < 2^64
  return t2 + (uint64_t)(0u - c);  // carry: cannot overflow again
}

// a * b + c for 32-bit a, b and 64-bit c (no overflow: at most 2^64 - 1);
// one IMAD.WIDE.U32 on the card.
GL_HD uint64_t gl_madw(uint32_t a, uint32_t b, uint64_t c) {
#ifdef __CUDA_ARCH__
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
#else
  return (uint64_t)a * b + c;
#endif
}

// a * b mod p for any u64 a, b; non-canonical result.  The 128-bit
// product is four 32x32->64 multiply-adds whose addends absorb the middle
// carries, so it costs four IMAD.WIDE.U32 and one 64-bit add.
GL_HD uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  uint64_t p00 = gl_madw(a0, b0, 0);
  uint64_t mid = gl_madw(a0, b1, p00 >> 32);            // < 2^64
  uint64_t mid2 = gl_madw(a1, b0, (uint32_t)mid);       // < 2^64
  uint64_t lo = (mid2 << 32) | (uint32_t)p00;
  uint64_t hi = gl_madw(a1, b1, mid >> 32) + (mid2 >> 32);
  return gl_reduce128(lo, hi);
}

// (lo + 2^64 * h) mod p for h < 2^32, non-canonical: 2^64 = 2^32 - 1.
GL_HD uint64_t gl_reduce96(uint64_t lo, uint64_t h) {
  uint32_t c;
  uint64_t r = gl_add_carry(lo, (h << 32) - h, &c);  // h * EPS < 2^64 - 2^33
  return r + (uint64_t)(0u - c);  // carry: r < h * EPS, so this cannot overflow
}

// (lo + 2^32 * hi) mod p for lo, hi < 2^63 (a lane split into 32-bit
// halves, each half multiplied and summed on its own).
GL_HD uint64_t gl_reduce_split(uint64_t lo, uint64_t hi) {
  uint32_t c;
  uint64_t x = gl_add_carry(lo, hi << 32, &c);
  return gl_reduce96(x, (hi >> 32) + c);
}

// a + b mod p for any u64 a and canonical b (< p); non-canonical result.
// On wraparound the corrected sum is <= p - 2, so one EPS-add suffices.
GL_HD uint64_t gl_add_canon_rhs(uint64_t a, uint64_t b) {
  uint32_t c;
  uint64_t s = gl_add_carry(a, b, &c);
  return s + (uint64_t)(0u - c);
}

// Any u64 -> [0, p).
GL_HD uint64_t gl_canon(uint64_t a) { return a >= GL_P ? a - GL_P : a; }

// Canonical a + b mod p for canonical a, b.
GL_HD uint64_t gl_add(uint64_t a, uint64_t b) {
  return gl_canon(gl_add_canon_rhs(a, b));
}

// Canonical a - b mod p for canonical a, b.
GL_HD uint64_t gl_sub(uint64_t a, uint64_t b) { return a >= b ? a - b : a - b + GL_P; }

// a - b over 64 bits and the borrow as a mask: 0, or 0xFFFFFFFF = EPS.  On
// the card the mask is the subtract's own borrow-out (subc), one
// instruction, where a 0/1 borrow costs two more to turn into EPS.
GL_HD uint64_t gl_sub_mask(uint64_t a, uint64_t b, uint32_t* mask) {
#ifdef __CUDA_ARCH__
  uint64_t d;
  asm("sub.cc.u64 %0, %2, %3;\n\tsubc.u32 %1, 0, 0;" : "=l"(d), "=r"(*mask) : "l"(a), "l"(b));
  return d;
#else
  *mask = a < b ? 0xFFFFFFFFu : 0u;
  return a - b;
#endif
}

// gl_reduce128 with its borrow kept as a mask: the same value.
GL_HD uint64_t gl_reduce128_m(uint64_t lo, uint64_t hi) {
  uint32_t m, c;
  uint64_t t0 = gl_sub_mask(lo, hi >> 32, &m);
  t0 -= m;   // borrow: 2^64 = EPS, cannot underflow again
  const uint64_t hl = hi & GL_EPS;
  const uint64_t t2 = gl_add_carry(t0, (hl << 32) - hl, &c);   // hl * EPS < 2^64
  return t2 + (uint64_t)(0u - c);   // carry: cannot overflow again
}

// a * b mod p for any u64 a, b; any u64 out: gl_mul's value.  On the card
// the 128-bit product is one carry chain of 32-bit multiply-adds (r3 r2 r1
// r0, the low and high halves of the four partial products: eight IMADs
// and an add, where gl_mul's four IMAD.WIDE.U32 leave ptxas seven adds to
// place), reduced by gl_reduce128_m.
GL_HD uint64_t gl_mul_m(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r0, r1, r2, r3;
  asm("mul.lo.u32 %0, %4, %6;\n\t"
      "mul.hi.u32 %1, %4, %6;\n\t"
      "mad.lo.cc.u32 %1, %4, %7, %1;\n\t"
      "madc.hi.u32 %2, %4, %7, 0;\n\t"
      "mad.lo.cc.u32 %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32 %3, %5, %7, 0;\n\t"
      "mad.lo.cc.u32 %2, %5, %7, %2;\n\t"
      "addc.u32 %3, %3, 0;"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
  return gl_reduce128_m(((uint64_t)r1 << 32) | r0, ((uint64_t)r3 << 32) | r2);
#else
  return gl_mul(a, b);
#endif
}

// a + b mod p for any u64 a and b; any u64 out.  A carry owes 2^64 = EPS
// (mod p); adding it carries once more when a + b - 2^64 >= p, and then the
// sum is below EPS, so a second EPS fits: two corrections, never a third.
GL_HD uint64_t gl_add_lazy(uint64_t a, uint64_t b) {
  uint32_t c;
  uint64_t s = gl_add_carry(a, b, &c);
  s = gl_add_carry(s, (uint64_t)(0u - c), &c);
  return s + (uint64_t)(0u - c);
}

// a - b mod p for any u64 a and b; any u64 out.  A borrow owes -2^64 = -EPS;
// taking it off borrows once more when a - b + 2^64 < EPS, and then the
// difference is at least p > EPS, so a second EPS comes off without a
// third borrow.
GL_HD uint64_t gl_sub_lazy(uint64_t a, uint64_t b) {
  uint32_t m;
  uint64_t d = gl_sub_mask(a, b, &m);
  d = gl_sub_mask(d, m, &m);
  return d - m;
}

// 7 y = 8 y - y mod p for any u64 y; any u64 out: a shift and two
// reductions, no multiply.
GL_HD uint64_t gl_mul7(uint64_t y) { return gl_sub_lazy(gl_reduce96(y << 3, y >> 61), y); }

// A sum of 64x64-bit products kept unreduced: 160 bits in five 32-bit
// words, w[0] the lowest.  gl_acc_mac adds a product in 13 multiply-adds
// and carries (gl_mul_m and then gl_add_lazy take about twice as many
// instructions); gl_acc_value reduces the sum once.  Exact for fewer than
// 2^32 products.
struct GlAcc {
  uint32_t w[5];
};

GL_HD GlAcc gl_acc_zero() { return {{0, 0, 0, 0, 0}}; }

// acc += a b for any u64 a, b.
GL_HD void gl_acc_mac(GlAcc& acc, uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  // the even partial products a0 b0 and a1 b1 in one carry chain, then a0
  // b1 and a1 b0 from word 1 up
  asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 %1, %5, %8, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %8, %2;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 %1, %6, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %6, %7, %2;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.u32 %4, %4, 0;"
      : "+r"(acc.w[0]), "+r"(acc.w[1]), "+r"(acc.w[2]), "+r"(acc.w[3]), "+r"(acc.w[4])
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
#else
  const unsigned __int128 p = (unsigned __int128)a * b;
  const unsigned __int128 cur =
      ((unsigned __int128)(((uint64_t)acc.w[3] << 32) | acc.w[2]) << 64) |
      (((uint64_t)acc.w[1] << 32) | acc.w[0]);
  const unsigned __int128 s = cur + p;
  acc.w[4] += s < cur;
  for (int k = 0; k < 4; k++) acc.w[k] = (uint32_t)(s >> (32 * k));
#endif
}

// The sum mod p, any u64 out: 2^128 = -2^32 (mod p), so w[4] 2^128 comes
// off the reduced low 128 bits as w[4] 2^32.
GL_HD uint64_t gl_acc_value(const GlAcc& acc) {
  const uint64_t lo = ((uint64_t)acc.w[1] << 32) | acc.w[0];
  const uint64_t hi = ((uint64_t)acc.w[3] << 32) | acc.w[2];
  return gl_sub_lazy(gl_reduce128_m(lo, hi), (uint64_t)acc.w[4] << 32);
}
