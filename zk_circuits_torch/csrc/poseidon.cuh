// Poseidon permutation (width 12, rate 8; 4 full + 22 partial + 4 full
// rounds, x^7 S-box) on u64 lanes, shared by the leaf kernel and by a host
// build for testing.
//
// Needs poseidon_constants.h, generated from hash/constants.py at build
// time: the MDS circulant and diagonal, the round constants and the
// frequency-domain blocks of the circulant (poseidon_freq*).
// Lanes stay non-canonical between rounds: every step is exact for any u64
// input, so only the caller's output lanes need gl_canon.
//
// Two forms of the MDS layer, both exact integer sums of the lanes' 32-bit
// halves (each below 2^32 * 264, so they never overflow):
//   - poseidon_mds_freq: the whole 12-lane layer through a 4-point real DFT
//     over the stride-3 groups of lanes, three 3x3 products in the
//     frequency domain whose coefficients are small powers of two (shifts),
//     and the inverse DFT; no multiplies.  Used by one thread per row.
//   - poseidon_mds_rows<T>: the output lanes one thread of a team of T owns,
//     each as 24 multiply-adds (IMAD.WIDE.U32) of a 32-bit half by a small
//     coefficient straight into a 64-bit sum.  Used by a thread team.
// A team of T threads (T divides 12) hashes one row: thread j owns lanes
// j, j + T, j + 2T, ... (L = 12 / T of them).  Each round is local work on
// the owned lanes (round constants, S-boxes), then an exchange in which
// every thread gathers all 12 lanes rotated to start at its own lane j,
// then the thread's rows of the MDS.  The exchange is written as
// team_provide (what a thread sends in step (d, e)) so that the host can
// run the T threads in turn with arrays in place of the warp shuffles.
#pragma once

#include "goldilocks.cuh"
#include "poseidon_constants.h"

GL_HD uint64_t poseidon_sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x3 = gl_mul(x2, x);
  uint64_t x6 = gl_mul(x3, x3);
  return gl_mul(x6, x);
}

// One half (32-bit words of the 12 lanes, as signed 64-bit) of the
// circulant product, in place: y[r] = sum_i circ[(i - r) % 12] x[i].
GL_HD void poseidon_mds_freq_half(int64_t x[POSEIDON_WIDTH]) {
  int64_t X0[3], X2[3], Xr[3], Xi[3];
#pragma unroll
  for (int b = 0; b < 3; b++) {  // 4-point DFT over lanes b, b+3, b+6, b+9
    int64_t p0 = x[b] + x[b + 6], p1 = x[b + 3] + x[b + 9];
    X0[b] = p0 + p1;
    X2[b] = p0 - p1;
    Xr[b] = x[b] - x[b + 6];
    Xi[b] = x[b + 3] - x[b + 9];
  }
#pragma unroll
  for (int q = 0; q < 3; q++) {  // the frequency-domain products, inverse DFT
    int64_t z0 = 0, z2 = 0, zr = 0, zi = 0;
#pragma unroll
    for (int b = 0; b < 3; b++) {
      z0 += poseidon_freq0(3 * q + b) * X0[b];
      z2 += poseidon_freq2(3 * q + b) * X2[b];
      zr += poseidon_freq1r(3 * q + b) * Xr[b] - poseidon_freq1i(3 * q + b) * Xi[b];
      zi += poseidon_freq1r(3 * q + b) * Xi[b] + poseidon_freq1i(3 * q + b) * Xr[b];
    }
    x[q] = z0 + z2 + zr;
    x[q + 3] = z0 - z2 + zi;
    x[q + 6] = z0 + z2 - zr;
    x[q + 9] = z0 - z2 - zi;
  }
}

// s <- M s, M circulant plus diagonal, in the frequency domain.
GL_HD void poseidon_mds_freq(uint64_t s[POSEIDON_WIDTH]) {
  int64_t lo[POSEIDON_WIDTH], hi[POSEIDON_WIDTH];
#pragma unroll
  for (int i = 0; i < POSEIDON_WIDTH; i++) {
    lo[i] = (int64_t)(uint32_t)s[i];
    hi[i] = (int64_t)(s[i] >> 32);
  }
  poseidon_mds_freq_half(lo);
  poseidon_mds_freq_half(hi);
  // the diagonal: only lane 0 has a coefficient
  lo[0] += (int64_t)poseidon_mds_diag(0) * (int64_t)(uint32_t)s[0];
  hi[0] += (int64_t)poseidon_mds_diag(0) * (int64_t)(s[0] >> 32);
#pragma unroll
  for (int i = 0; i < POSEIDON_WIDTH; i++)
    s[i] = gl_reduce_split((uint64_t)lo[i], (uint64_t)hi[i]);
}

// The value thread o of a team sends in exchange step (d, e), 1 <= d < T:
// the receiver j = (o - d) mod T wants lane (j + d + e*T) mod 12, which is
// o's register (e + [o < d]) mod L.
template <int T>
GL_HD uint64_t team_provide(const uint64_t s[], int o, int d, int e) {
  constexpr int L = POSEIDON_WIDTH / T;
  return o < d ? s[(e + 1) % L] : s[e];
}

// Thread j's output lanes j + k*T of the MDS layer, from g[m] = lane
// (j + m) mod 12 of the input state.
template <int T>
GL_HD void poseidon_mds_rows(int j, const uint64_t g[POSEIDON_WIDTH],
                             uint64_t out[POSEIDON_WIDTH / T]) {
  constexpr int L = POSEIDON_WIDTH / T;
  const uint32_t c00 = (uint32_t)(poseidon_mds_circ(0) + (j == 0 ? poseidon_mds_diag(0) : 0));
#pragma unroll
  for (int k = 0; k < L; k++) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int m = 0; m < POSEIDON_WIDTH; m++) {
      int ci = (m - k * T + POSEIDON_WIDTH) % POSEIDON_WIDTH;
      uint32_t c = (k == 0 && m == 0) ? c00 : (uint32_t)poseidon_mds_circ(ci);
      lo = gl_madw((uint32_t)g[m], c, lo);
      hi = gl_madw((uint32_t)(g[m] >> 32), c, hi);
    }
    out[k] = gl_reduce_split(lo, hi);
  }
}

// Local half of round `r` for thread j: add the round constants to the
// owned lanes, then the S-boxes (all owned lanes in a full round, lane 0
// in a partial one).  rc: the 360 round constants, round-major.
template <int T, bool FULL>
GL_HD void poseidon_team_sboxes(uint64_t s[POSEIDON_WIDTH / T], int j, int r,
                                const uint64_t* rc) {
  constexpr int L = POSEIDON_WIDTH / T;
#pragma unroll
  for (int k = 0; k < L; k++) s[k] = gl_add_canon_rhs(s[k], rc[r * POSEIDON_WIDTH + j + k * T]);
  if (FULL) {
#pragma unroll
    for (int k = 0; k < L; k++) s[k] = poseidon_sbox(s[k]);
  } else {
    uint64_t x = poseidon_sbox(s[0]);  // every thread runs it: no divergence
    s[0] = j == 0 ? x : s[0];
  }
}

GL_HD bool poseidon_full_round(int r) {
  return r < POSEIDON_HALF_FULL || r >= POSEIDON_HALF_FULL + POSEIDON_PARTIAL;
}

// rc: the 360 round constants, round-major.  One thread, whole state.
GL_HD void poseidon_permute(uint64_t s[POSEIDON_WIDTH], const uint64_t* rc) {
  for (int r = 0; r < POSEIDON_ROUNDS; r++) {
    if (poseidon_full_round(r))
      poseidon_team_sboxes<1, true>(s, 0, r, rc);
    else
      poseidon_team_sboxes<1, false>(s, 0, r, rc);
    poseidon_mds_freq(s);
  }
}

// Merkle levels of a tree over n leaves, stored one after another, 4 felts
// a node: level l starts at this element.
GL_HD long long merkle_level_offset(long long n, int l) { return 4 * (2 * n - 2 * (n >> l)); }

// Element of felt `lane` of node t of level l in the subtree of the block
// whose first leaf is row0.
GL_HD long long merkle_node_elem(long long n, int l, long long row0, long long t, int lane) {
  return merkle_level_offset(n, l) + ((row0 >> l) + t) * 4 + lane;
}
