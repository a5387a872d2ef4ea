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
// ga: the point's proof's beta_c and gamma_c.  A chunk's first factor
// starts its products.
template <int NC>
GL_HD void perm_chunk(const uint64_t* w, long long w_rs, const uint64_t* s, long long s_rs,
                      long long lo, long long hi, uint64_t x, const uint64_t* bk,
                      const uint64_t* be, const uint64_t* ga, uint64_t* num, uint64_t* den) {
  for (long long j = lo; j < hi; j++) {
    const uint64_t wj = gl_ld(w + j * w_rs), sj = gl_ld(s + j * s_rs);
#pragma unroll
    for (int ch = 0; ch < NC; ch++) {
      const uint64_t nj = gl_add_lazy(wj, gl_add_lazy(gl_mul_m(bk[ch * PERM_MAX_ROUTED + j], x), ga[ch]));
      const uint64_t dj = gl_add_lazy(wj, gl_add_lazy(gl_mul_m(be[ch], sj), ga[ch]));
      num[ch] = j == lo ? nj : gl_mul_m(num[ch], nj);
      den[ch] = j == lo ? dj : gl_mul_m(den[ch], dj);
    }
  }
}
