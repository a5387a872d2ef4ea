// The port's host runtime: Goldilocks vector operations, the Poseidon
// permutation and sponges, Merkle levels and the radix-2 NTT / coset LDE,
// for the numpy host code (host/gl.py, host/poseidon.py, hash/merkle.py,
// ntt/ntt.py) through zk_circuits_torch/native.  The Fiat-Shamir
// challenger, the circuit build, the host witness and the host verifier
// reach it through those modules.
//
// Built by g++ with OpenMP (utils/nvcc.py, build_host_library) on the same
// field and permutation code the CUDA kernels compile (goldilocks.cuh,
// poseidon.cuh).  Those keep lanes non-canonical between steps; every
// function here returns canonical values ([0, p)), exact for any u64
// input.  Every parallel loop runs on the caller's thread count; a loop
// of fewer than 16 items runs on the calling thread alone, since waking a
// thread team costs more than a few permutations.
//
// Plain C interface, loaded with ctypes.

#include <stdint.h>
#include <string.h>

#include <vector>

#include "poseidon.cuh"

typedef uint64_t u64;

static const u64 RC[POSEIDON_WIDTH * POSEIDON_ROUNDS] = POSEIDON_RC_INIT;
// A generator of the subgroup of order 2^32 (plonky2's POWER_OF_TWO_GENERATOR).
static const u64 POWER_OF_TWO_GENERATOR = 1753635133440165772ULL;
static const int PAR_MIN = 16;

template <class F>
static void par_for(int64_t n, int threads, F f) {
  if (threads <= 1 || n < PAR_MIN) {
    for (int64_t i = 0; i < n; i++) f(i);
    return;
  }
#pragma omp parallel for schedule(static) num_threads(threads)
  for (int64_t i = 0; i < n; i++) f(i);
}

// ---------------------------------------------------------------------------
// Goldilocks, canonical results for any u64 inputs
// ---------------------------------------------------------------------------

static inline u64 add_any(u64 a, u64 b) {
  return gl_canon(gl_add_canon_rhs(a, gl_canon(b)));
}

static inline u64 sub_any(u64 a, u64 b) {
  uint32_t borrow;
  // a < canon(b) wraps: d = a - b + 2^64 > 2^64 - p = EPS, and 2^64 = EPS
  u64 d = gl_sub_borrow(a, gl_canon(b), &borrow);
  return gl_canon(d - (u64)(0u - borrow));
}

static inline u64 mul_any(u64 a, u64 b) { return gl_canon(gl_mul(a, b)); }

static inline u64 pow_any(u64 a, u64 e) {
  u64 acc = 1, sq = a;
  while (e) {
    if (e & 1) acc = gl_mul(acc, sq);
    sq = gl_mul(sq, sq);
    e >>= 1;
  }
  return gl_canon(acc);
}

static inline u64 inv_any(u64 a) { return pow_any(a, GL_P - 2); }  // inv(0) = 0

extern "C" {

void zkh_gl_add(const u64* a, const u64* b, u64* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = add_any(a[i], b[i]);
}

void zkh_gl_sub(const u64* a, const u64* b, u64* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = sub_any(a[i], b[i]);
}

void zkh_gl_mul(const u64* a, const u64* b, u64* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = mul_any(a[i], b[i]);
}

void zkh_gl_inv(const u64* a, u64* out, int64_t n, int threads) {
  par_for(n, threads, [&](int64_t i) { out[i] = inv_any(a[i]); });
}

// out[i] = base^i
void zkh_gl_powers(u64 base, u64* out, int64_t n) {
  u64 acc = 1;
  for (int64_t i = 0; i < n; i++) {
    out[i] = gl_canon(acc);
    acc = gl_mul(acc, base);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Poseidon: the permutation, the sponge and two-to-one compression
// ---------------------------------------------------------------------------

static inline void permute_one(u64* s) {
  poseidon_permute(s, RC);
  for (int i = 0; i < POSEIDON_WIDTH; i++) s[i] = gl_canon(s[i]);
}

// hash_no_pad: absorb `len` felts RATE at a time (each chunk overwrites the
// first lanes), permute after each; the digest is lanes 0-3.
static inline void hash_no_pad_one(const u64* in, int64_t len, u64* out4) {
  u64 s[POSEIDON_WIDTH] = {0};
  for (int64_t off = 0; off < len; off += POSEIDON_RATE) {
    int64_t chunk = len - off < POSEIDON_RATE ? len - off : POSEIDON_RATE;
    memcpy(s, in + off, (size_t)chunk * sizeof(u64));
    poseidon_permute(s, RC);
  }
  for (int i = 0; i < 4; i++) out4[i] = gl_canon(s[i]);
}

extern "C" {

// n states of 12 consecutive lanes, permuted in place.
void zkh_poseidon_permute(u64* states, int64_t n, int threads) {
  par_for(n, threads, [&](int64_t i) { permute_one(states + i * POSEIDON_WIDTH); });
}

// rows x cols leaf matrix -> rows x 4 digests.  With or_noop, a row of at
// most 4 felts is its own digest, zero-padded (the Merkle leaf rule).
void zkh_hash_leaves(const u64* leaves, int64_t rows, int64_t cols, int or_noop,
                     u64* out, int threads) {
  if (or_noop && cols <= 4) {
    for (int64_t r = 0; r < rows; r++)
      for (int64_t j = 0; j < 4; j++) out[r * 4 + j] = j < cols ? leaves[r * cols + j] : 0;
    return;
  }
  par_for(rows, threads, [&](int64_t r) { hash_no_pad_one(leaves + r * cols, cols, out + r * 4); });
}

// (2 n_pairs) x 4 digests, left and right in turn -> n_pairs x 4:
// lanes 0-3 of permute(left || right || 0^4).
void zkh_compress_level(const u64* digests, int64_t n_pairs, u64* out, int threads) {
  par_for(n_pairs, threads, [&](int64_t i) {
    u64 s[POSEIDON_WIDTH] = {0};
    memcpy(s, digests + i * 8, 8 * sizeof(u64));
    poseidon_permute(s, RC);
    for (int j = 0; j < 4; j++) out[i * 4 + j] = gl_canon(s[j]);
  });
}

// n inputs of len felts -> n x 4 digests.
void zkh_hash_no_pad_batch(const u64* in, int64_t n, int64_t len, u64* out, int threads) {
  par_for(n, threads, [&](int64_t i) { hash_no_pad_one(in + i * len, len, out + i * 4); });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Radix-2 NTT along rows of n (a power of two), natural order in and out:
// values[i] = p(w^i), w the primitive n-th root of unity from
// POWER_OF_TWO_GENERATOR.  Bit-reversal, then one butterfly stage per bit.
// ---------------------------------------------------------------------------

static int log2_exact(int64_t n) {
  int bits = 0;
  while ((int64_t(1) << bits) < n) bits++;
  return bits;
}

// Twiddles of every stage in one table: stage s (half = 2^s) reads
// w_{2^(s+1)}^j at tw[2^s - 1 + j], j < 2^s.
static std::vector<u64> stage_twiddles(int64_t n) {
  int bits = log2_exact(n);
  std::vector<u64> tw((size_t)(n > 1 ? n - 1 : 0));
  for (int s = 0; s < bits; s++) {
    u64 w = POWER_OF_TWO_GENERATOR;  // order 2^32 -> order 2^(s+1)
    for (int k = 0; k < 32 - (s + 1); k++) w = gl_mul(w, w);
    int64_t half = int64_t(1) << s;
    u64 acc = 1;
    for (int64_t j = 0; j < half; j++) {
      tw[(size_t)(half - 1 + j)] = gl_canon(acc);
      acc = gl_mul(acc, w);
    }
  }
  return tw;
}

static void bit_reverse(u64* x, int64_t n, int bits) {
  for (int64_t i = 0; i < n; i++) {
    int64_t r = 0;
    for (int b = 0; b < bits; b++) r |= ((i >> b) & 1) << (bits - 1 - b);
    if (r > i) {
      u64 t = x[i];
      x[i] = x[r];
      x[r] = t;
    }
  }
}

// In place on canonical x.
static void ntt_one(u64* x, int64_t n, const u64* tw) {
  int bits = log2_exact(n);
  bit_reverse(x, n, bits);
  for (int s = 0; s < bits; s++) {
    int64_t half = int64_t(1) << s;
    const u64* w = tw + half - 1;
    for (int64_t blk = 0; blk < n; blk += 2 * half) {
      for (int64_t j = 0; j < half; j++) {
        u64 a = x[blk + j];
        u64 b = mul_any(x[blk + j + half], w[j]);
        x[blk + j] = add_any(a, b);
        x[blk + j + half] = sub_any(a, b);
      }
    }
  }
}

extern "C" {

// batch rows of n, in place: the NTT, or with inverse the INTT
// (INTT(x)[i] = NTT(x)[-i mod n] / n).
void zkh_ntt(u64* data, int64_t batch, int64_t n, int inverse, int threads) {
  std::vector<u64> tw = stage_twiddles(n);
  u64 n_inv = inv_any((u64)n);
  par_for(batch, threads, [&](int64_t b) {
    u64* x = data + b * n;
    for (int64_t i = 0; i < n; i++) x[i] = gl_canon(x[i]);
    ntt_one(x, n, tw.data());
    if (inverse) {
      for (int64_t i = 1; i < n - i; i++) {
        u64 t = x[i];
        x[i] = x[n - i];
        x[n - i] = t;
      }
      for (int64_t i = 0; i < n; i++) x[i] = mul_any(x[i], n_inv);
    }
  });
}

// Coset LDE: batch rows of n coefficients -> batch rows of m = n << rate_bits
// values on shift * <w_m>: coefficient i scaled by shift^i, zero-padded, NTT.
void zkh_coset_lde(const u64* coeffs, int64_t batch, int64_t n, int rate_bits, u64 shift,
                   u64* out, int threads) {
  int64_t m = n << rate_bits;
  std::vector<u64> tw = stage_twiddles(m);
  par_for(batch, threads, [&](int64_t b) {
    u64* x = out + b * m;
    u64 acc = 1;
    for (int64_t i = 0; i < n; i++) {
      x[i] = mul_any(coeffs[b * n + i], acc);
      acc = gl_mul(acc, shift);
    }
    memset(x + n, 0, (size_t)(m - n) * sizeof(u64));
    ntt_one(x, m, tw.data());
  });
}

}  // extern "C"
