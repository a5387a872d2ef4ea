// The permutation argument's arithmetic at one point, shared by K5
// (quotient.cuh, its chunk terms over the LDE coset) and K6
// (permutation.cuh, its products over H), on the card and in the host
// builds for testing: the read-only load, the block's beta k_j table and a
// chunk's numerator and denominator products
//   num_c = prod_{lo <= j < hi} (w_j + beta_c k_j x + gamma_c),
//   den_c = prod_{lo <= j < hi} (w_j + beta_c s_j + gamma_c)
// for the routed wires' values w_j, sigmas s_j and coset shifts k_j.
#pragma once

#include "goldilocks.cuh"

#define PERM_MAX_ROUTED 256   // routed wires: beta_c k_j a block keeps

// A read-only input, through the read-only path on the card.
GL_HD uint64_t gl_ld(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__ldg((const unsigned long long*)p);
#else
  return *p;
#endif
}

// Proof b's table, thread tid of nthr: beta_c k_j at bk[c PERM_MAX_ROUTED
// + j] for the `routed` shifts kis and the challenges betas (nc, batch).
template <int NC>
GL_HD void perm_bk_table(const uint64_t* kis, long long routed, const uint64_t* betas,
                         int batch, int b, uint64_t* bk, int tid, int nthr) {
  for (long long j = tid; j < routed; j += nthr) {
    const uint64_t k = gl_ld(kis + j);
#pragma unroll
    for (int ch = 0; ch < NC; ch++)
      bk[ch * PERM_MAX_ROUTED + j] = gl_mul_m(gl_ld(betas + ch * batch + b), k);
  }
}

// Chunk [lo, hi) at point x, every challenge: num[c] and den[c] (in [0,
// 2^64)).  w_j = w[j w_rs] and s_j = s[j s_rs]; bk: perm_bk_table's; be,
// ga: the point's proof's beta_c and gamma_c.  The factors are taken two
// at a time, their product first, so each running product's chain is half
// the chunk long (the same products, in another order).
template <int NC>
GL_HD void perm_factors(const uint64_t* w, long long w_rs, const uint64_t* s, long long s_rs,
                        long long j, uint64_t x, const uint64_t* bk, const uint64_t* be,
                        const uint64_t* ga, uint64_t* nj, uint64_t* dj) {
  const uint64_t wj = gl_ld(w + j * w_rs), sj = gl_ld(s + j * s_rs);
#pragma unroll
  for (int ch = 0; ch < NC; ch++) {
    const uint64_t u = gl_add_lazy(wj, ga[ch]);   // shared by the two factors
    nj[ch] = gl_add_lazy(u, gl_mul_m(bk[ch * PERM_MAX_ROUTED + j], x));
    dj[ch] = gl_add_lazy(u, gl_mul_m(be[ch], sj));
  }
}

template <int NC>
GL_HD void perm_chunk(const uint64_t* w, long long w_rs, const uint64_t* s, long long s_rs,
                      long long lo, long long hi, uint64_t x, const uint64_t* bk,
                      const uint64_t* be, const uint64_t* ga, uint64_t* num, uint64_t* den) {
  long long j = lo;
  if ((hi - lo) & 1) {
    perm_factors<NC>(w, w_rs, s, s_rs, j++, x, bk, be, ga, num, den);
  } else {
    uint64_t n1[NC], d1[NC];
    perm_factors<NC>(w, w_rs, s, s_rs, j, x, bk, be, ga, num, den);
    perm_factors<NC>(w, w_rs, s, s_rs, j + 1, x, bk, be, ga, n1, d1);
#pragma unroll
    for (int ch = 0; ch < NC; ch++) {
      num[ch] = gl_mul_m(num[ch], n1[ch]);
      den[ch] = gl_mul_m(den[ch], d1[ch]);
    }
    j += 2;
  }
  for (; j < hi; j += 2) {
    uint64_t n0[NC], d0[NC], n1[NC], d1[NC];
    perm_factors<NC>(w, w_rs, s, s_rs, j, x, bk, be, ga, n0, d0);
    perm_factors<NC>(w, w_rs, s, s_rs, j + 1, x, bk, be, ga, n1, d1);
#pragma unroll
    for (int ch = 0; ch < NC; ch++) {
      num[ch] = gl_mul_m(num[ch], gl_mul_m(n0[ch], n1[ch]));
      den[ch] = gl_mul_m(den[ch], gl_mul_m(d0[ch], d1[ch]));
    }
  }
}
