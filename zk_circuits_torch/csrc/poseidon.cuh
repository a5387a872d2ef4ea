// Poseidon permutation (width 12, rate 8; 4 full + 22 partial + 4 full
// rounds, x^7 S-box) on a register-resident u64 state, shared by the leaf
// kernel and by a host build for testing.
//
// Needs poseidon_constants.h, generated from hash/constants.py at build
// time (poseidon_mds_circ / poseidon_mds_diag and POSEIDON_RC_INIT).
// Lanes stay non-canonical between rounds: every step is exact for any u64
// input, so only the caller's output lanes need gl_canon.
#pragma once

#include "goldilocks.cuh"
#include "poseidon_constants.h"

GL_HD uint64_t poseidon_sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x3 = gl_mul(x2, x);
  uint64_t x6 = gl_mul(x3, x3);
  return gl_mul(x6, x);
}

// s <- M s with M circulant plus diagonal.  Each lane is split into 32-bit
// halves so the small-coefficient sums stay exact in u64 (< 264 * 2^32);
// the two halves recombine into one 128-bit value for the reduction.
GL_HD void poseidon_mds(uint64_t s[POSEIDON_WIDTH]) {
  uint64_t out[POSEIDON_WIDTH];
#pragma unroll
  for (int r = 0; r < POSEIDON_WIDTH; r++) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; i++) {
      uint64_t c = poseidon_mds_circ((i - r + POSEIDON_WIDTH) % POSEIDON_WIDTH) +
                   (i == r ? poseidon_mds_diag(r) : 0);
      lo += (s[i] & 0xFFFFFFFFULL) * c;
      hi += (s[i] >> 32) * c;
    }
    uint64_t x_lo = lo + (hi << 32);
    uint64_t carry = x_lo < lo ? 1 : 0;
    out[r] = gl_reduce128(x_lo, (hi >> 32) + carry);
  }
#pragma unroll
  for (int i = 0; i < POSEIDON_WIDTH; i++) s[i] = out[i];
}

GL_HD void poseidon_full_round(uint64_t s[POSEIDON_WIDTH], const uint64_t* rc) {
#pragma unroll
  for (int i = 0; i < POSEIDON_WIDTH; i++)
    s[i] = poseidon_sbox(gl_add_canon_rhs(s[i], rc[i]));
  poseidon_mds(s);
}

GL_HD void poseidon_partial_round(uint64_t s[POSEIDON_WIDTH], const uint64_t* rc) {
#pragma unroll
  for (int i = 0; i < POSEIDON_WIDTH; i++) s[i] = gl_add_canon_rhs(s[i], rc[i]);
  s[0] = poseidon_sbox(s[0]);
  poseidon_mds(s);
}

// rc: the 360 round constants, round-major.
GL_HD void poseidon_permute(uint64_t s[POSEIDON_WIDTH], const uint64_t* rc) {
  int r = 0;
#pragma unroll 1
  for (int k = 0; k < POSEIDON_HALF_FULL; k++, r++)
    poseidon_full_round(s, rc + r * POSEIDON_WIDTH);
#pragma unroll 1
  for (int k = 0; k < POSEIDON_PARTIAL; k++, r++)
    poseidon_partial_round(s, rc + r * POSEIDON_WIDTH);
#pragma unroll 1
  for (int k = 0; k < POSEIDON_HALF_FULL; k++, r++)
    poseidon_full_round(s, rc + r * POSEIDON_WIDTH);
}
