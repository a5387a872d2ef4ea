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

// High 64 bits of the 128-bit product a * b.
GL_HD uint64_t gl_mulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// (lo + 2^64 * hi) mod p, non-canonical: the result may lie in [p, 2^64).
GL_HD uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & GL_EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= GL_EPS;  // borrow: 2^64 = EPS, cannot underflow again
  uint64_t t1 = (hi_lo << 32) - hi_lo;  // hi_lo * EPS < 2^64
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += GL_EPS;  // carry: cannot overflow again
  return t2;
}

// a * b mod p for any u64 a, b; non-canonical result.
GL_HD uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, gl_mulhi(a, b));
}

// a + b mod p for any u64 a and canonical b (< p); non-canonical result.
// On wraparound the corrected sum is <= p - 2, so one EPS-add suffices.
GL_HD uint64_t gl_add_canon_rhs(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += GL_EPS;
  return s;
}

// Any u64 -> [0, p).
GL_HD uint64_t gl_canon(uint64_t a) { return a >= GL_P ? a - GL_P : a; }

// Canonical a + b mod p for canonical a, b.
GL_HD uint64_t gl_add(uint64_t a, uint64_t b) {
  return gl_canon(gl_add_canon_rhs(a, b));
}
