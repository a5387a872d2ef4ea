// Index and field code of the Goldilocks NTT kernel K4, __host__ __device__
// so that tests/test_torch_kernel_host.py runs it on the CPU with g++.
//
// One call (a K4Call, filled by ntt/ntt_cuda.py) transforms `rows` rows of
// the input along their last axis, row r at x + r * in_stride:
//
//   X_r[k]    = sum_{i < n_in} pre[i] * x[r, i] * w_n^(i k)       (k < n)
//   out[r, m] = scale * post[m] * X_r[m]              (forward)
//   out[r, m] = scale * post[m] * X_r[(n - m) mod n]  (inverse)
//
// w_n is ntt/ntt.py's primitive n-th root of unity, the input is read up
// to n_in <= n and taken as zero beyond (the LDE's padding), pre and post
// are absent (1) unless given.  So ntt.py's modes are:
//
//   ntt           n_in = n
//   intt          inverse, scale = n^-1
//   coset_ntt     pre = shift^i (and n_in < n for a padded one)
//   coset_intt    inverse, post = n^-1 shift^-m
//   lde           pre = shift^i, n = n_in 2^rate_bits
//
// The leaf mode (leaf_log > 0, ntt_cuda.coset_leaves) serves FRI's
// codewords: the rows are the two components of `half` extension
// polynomials (row r = comp half + b, comp = 0, 1), the second read at
// x1 + (r - half) * in_stride (it need not follow the first in memory),
// and out[r, m] is stored at its fiber-leaf slot instead of its row's,
//
//   leaves[b][m mod M][2 (m div M) + comp],   M = n / 2^leaf_log,
//
// the (half, M, 2^(leaf_log + 1)) leaves of fri/fri_device.py's
// _fiber_leaves, with no regroup copy after the transform.  A leaf holds
// words of both component rows, so the passes that store (the row path,
// pass B) take tiles of the same columns of rows b and half + b (the
// first component's columns first, k4_col_row) and store whole leaves:
// the last round puts its values in shared memory in the output's order
// (k4_stage_index), and after a barrier each thread stores pairs of
// consecutive words from there, 16 bytes each (k4_flush), a warp 64 words
// of one run.  On the row path a tile's proofs are one run; in pass B,
// where column k2 holds the values m = k2 + n2 k1 (k1 < n1),
// m mod M = k2 + n2 (k1 mod M / n2) and m div M = k1 div (M / n2) while
// n2 <= M: the column holds M / n2 whole leaves of one component, each
// leaf 2^(leaf_log + 1) consecutive words of the output (a larger n2 still
// takes the same order, in shorter runs).
//
// Every output is canonical, so equal to the stage loop's (field results
// are unique).  Two paths, each made of passes; a pass transforms columns
// of L = 2^l points, a block a tile of C = 2^lc columns:
//
//   row path   (log_n1 = 0, n <= 2^K4_PASS_MAX_LOG): one pass, a column a
//              row (L = n).
//   four-step  (n = n1 n2, both <= 2^K4_PASS_MAX_LOG): input i = j1 + n1 j2,
//              output k = k2 + n2 k1 (the maps of the JAX package's
//              ntt_mxu.py:167-191, with any factors the call names):
//     pass A   columns j1 of one batch row: NTT_{n2} over j2, times
//              w_n^(j1 k2), written to scratch[row, k2, j1];
//     pass B   columns k2 of one batch row: NTT_{n1} over j1 (a contiguous
//              run of scratch), written to output k2 + n2 k1.
//
// A pass is a Stockham transform in rounds: round r takes the remaining
// length L_r apart as L_r = R_r M_r, R_r = 16 but in one round
// (k4_radix_log: the last of two, the second of three or four), which
// takes what is left.  Subproblem D of round r (D < S_r = R_0 ... R_(r-1))
// holds Y_r[D][j], j < L_r (Y_0 is the column).  A task (D, j < M_r) takes
// the R_r values a[m] = Y_r[D][j + M_r m], computes their R_r-point DFT
// A[k] in registers (radix-2 stages whose twiddles, powers of w_16, are
// powers of two: shifts, k4_unit_mul), and hands on Y_(r+1)[D + S_r k][j]
// = A[k] w_(L_r)^(j k); the last round's A[k] is X[D + S_r k].  Each
// thread holds K4_V = 16 values, 16 / R_r tasks of a round.  Round 0
// reads the input and the last round writes the output, each thread its
// R_r values at a stride, so that neighbouring threads touch neighbouring
// words; between rounds the tile goes through shared memory once (one
// write, a barrier, one read).  The values stay in [0, 2^64) between
// stages (gl_mul_m, gl_add_lazy, gl_sub_lazy); only the output store
// canonicalises.  An input zero from n_in on skips round 0's stages that
// would only copy (k4_live_log).
//
// Tables (tw, built by the wrapper): for each pass, each round r but the
// last, w_(L_r)^(j k) at k M_r + j (k < R_r, j < M_r); the row path's, or
// pass A's then pass B's; then for the four-step w_n^e as lo[e mod 2^h]
// hi[e >> h] (h = ceil(log_n / 2)), from which pass A computes its
// twiddles as running powers along k2.
//
// Shared memory: column c at c * k4_pitch(l, pass), value q at k4_pad(q),
// one spare slot every 16 values, and in passes A and B an odd pitch.  A
// 64-bit access is served a half-warp at a time; its 16 threads meet 16
// bank pairs at every exchange of the wide tiles (16 columns or more) and
// of the row path, and up to four threads share a pair in the exchanges
// over columns of a narrow tile (4 or 8 columns).
// The kernel's phases run thread tid of nthr over the tile; the host tests
// run a block's threads one after another between the barriers, each with
// its own 16 values.
#pragma once

#include "goldilocks.cuh"

#define K4_V 16               // values a thread holds (registers)
#define K4_LOG_V 4
#define K4_PASS_MAX_LOG 13    // the longest pass: 2^13 points
#define K4_MAX_LOG_N 26       // 2 K4_PASS_MAX_LOG: the four-step's largest n
#define K4_TILE_MAX_LOG 12    // a tile holds at most 2^12 values, 256 threads,
                              // but a pass of 2^13 takes one column, 512 threads
#define K4_MAX_THREADS 512
// The largest shared tile in slots: one column of 2^13 in pass A,
// k4_pitch(13, K4_PASS_A).
#define K4_SMEM_MAX_ELEMS 8705

enum K4Pass { K4_PASS_ROW = 0, K4_PASS_A = 1, K4_PASS_B = 2 };

struct K4Call {
  const uint64_t* x;         // input rows: row r at x + r * in_stride
  uint64_t* out;             // (rows, n), contiguous
  uint64_t* scratch;         // (rows, n2, n1): pass A's output (four-step only)
  const uint64_t* tw;        // the round tables, then lo and hi (see above)
  const uint64_t* pre;       // shift^i for i < n_in, or null
  const uint64_t* post;      // n^-1 shift^-m for m < n, or null
  unsigned long long scale;  // n^-1 for an inverse transform without post, else 1
  long long rows, in_stride, n_in;
  int log_n, log_n1;         // log_n1 = 0: the row path; else n1 = 2^log_n1
  int inverse;
  int log_cols[3];           // log2 of a tile's columns, per pass (the wrapper's plan)
  int leaf_log;              // 0, or the leaf mode's log2 fiber-leaf arity (see above)
  const uint64_t* x1;        // the leaf mode's: rows from `half` on at x1 + (r - half) * in_stride
  long long half;            // the leaf mode's polynomials (0 outside it)
};

// One block's tile.  Row path: batch rows row .. row + count - 1 (columns
// from count on are past the last row).  Passes A and B: batch row `row`,
// j1 (A) or k2 (B) first .. first + 2^lc - 1.  `staged`: the leaf mode's
// row path and pass B (k4_staged), whose tile holds 2^(lc - 1) columns of
// each component row and whose last round stores through shared memory.
struct K4Tile {
  long long row, first;
  int count, l, lc, rounds, staged;
};

// A task of a round: column c, subproblem d, index j < M_r.
struct K4Task {
  int c, d, j;
};

// ---------------------------------------------------------------------------
// geometry
// ---------------------------------------------------------------------------

// j's lowest `bits` bits reversed, bits <= 4: one expression without a
// loop, so that it folds to a constant in the unrolled DFT (an index the
// compiler cannot fold would put the thread's values in local memory).
GL_HD constexpr int k4_rev(int j, int bits) {
  return (((j & 1) << 3) | ((j & 2) << 1) | ((j & 4) >> 1) | ((j & 8) >> 3)) >> (4 - bits);
}

GL_HD int k4_log_len(const K4Call& c, int pass) {
  return pass == K4_PASS_ROW ? c.log_n : pass == K4_PASS_A ? c.log_n - c.log_n1 : c.log_n1;
}

// Rounds of a pass of 2^l points, and log2 of round r's radix: 16 but one
// round, which takes what is left (1 for l = 0: a copy): the last of two,
// the second of three or four.  Round 0 keeps radix 16 for an LDE's zeros,
// and a small radix in the middle spares the last round's exchange the
// bank conflicts of a short column and, with three rounds, one round of
// twiddles (the last one's M is 1).
GL_HD constexpr int k4_rounds(int l) {
  return l <= K4_LOG_V ? 1 : (l + K4_LOG_V - 1) / K4_LOG_V;
}

GL_HD constexpr int k4_radix_log(int l, int r) {
  return r != (k4_rounds(l) > 2 ? 1 : k4_rounds(l) - 1)
             ? K4_LOG_V
             : l - K4_LOG_V * (k4_rounds(l) - 1);
}

// log2 S_r: the radices of the rounds before round r together; round r's
// sub-transforms have 2^(l - k4_done_log(l, r)) points.
GL_HD constexpr int k4_done_log(int l, int r) {
  int s = 0;
  for (int q = 0; q < r; q++) s += k4_radix_log(l, q);
  return s;
}

// Whether a tile of 2^lc columns of a pass of 2^l points fits a block.
GL_HD constexpr bool k4_tile_fits(int l, int lc) {
  return lc >= 0 && (l + lc <= K4_TILE_MAX_LOG || (l == K4_PASS_MAX_LOG && lc == 0));
}

// Threads of a block: 16 values each, at least one.
GL_HD int k4_threads(int l, int lc) {
  return l + lc > K4_LOG_V ? 1 << (l + lc - K4_LOG_V) : 1;
}

// Shared-memory slot of value q of a column, and the slots a column of the
// pass takes: odd in the four-step's passes, whose rounds that load or
// store run over columns (k4_task).
GL_HD int k4_pad(int q) { return q + (q >> 4); }
GL_HD int k4_pitch(int l, int pass) {
  return (1 << l) + ((1 << l) >> 4) + (pass == K4_PASS_ROW ? 0 : 1);
}

// Whether the pass stores whole fiber leaves through shared memory: the
// leaf mode's row path and pass B.
GL_HD bool k4_staged(const K4Call& c, int pass) { return c.leaf_log && pass != K4_PASS_A; }

// The tile's values at once: 2^(l + lc), and the slots that the staged
// store takes (two spare slots every 32, k4_stage_pad).
GL_HD long long k4_stage_elems(int l, int lc) {
  const long long v = 1LL << (l + lc);
  return v + (v >> 4);
}

GL_HD long long k4_blocks(const K4Call& c, int pass) {
  const int lc = c.log_cols[pass];
  if (pass == K4_PASS_ROW) return (c.rows + (1LL << lc) - 1) >> lc;
  const int cols = pass == K4_PASS_A ? c.log_n1 : c.log_n - c.log_n1;
  return (c.rows << cols) >> lc;   // a staged pass B: lc up to cols + 1, rows even
}

// Shared-memory slots of a block of the pass (none for one round, but
// for a staged store).
GL_HD long long k4_smem_elems(const K4Call& c, int pass) {
  const int l = k4_log_len(c, pass), lc = c.log_cols[pass];
  const long long ex = k4_rounds(l) > 1 ? (long long)k4_pitch(l, pass) << lc : 0;
  if (!k4_staged(c, pass)) return ex;
  const long long st = k4_stage_elems(l, lc);
  return st > ex ? st : ex;
}

// Block blk's tile.  A staged tile (k4_staged) takes 2^(lc - 1) columns
// of each component row: row path, proofs row .. row + count - 1 of both
// components; pass B, proof `row`'s k2 first .. first + 2^(lc - 1) - 1.
GL_HD K4Tile k4_tile(const K4Call& c, int pass, long long blk) {
  K4Tile t;
  t.l = k4_log_len(c, pass);
  t.lc = c.log_cols[pass];
  t.rounds = k4_rounds(t.l);
  t.staged = k4_staged(c, pass);
  const int h = t.lc - t.staged;   // log2 of the tile's columns of one row
  if (pass == K4_PASS_ROW) {
    t.row = blk << h;
    t.first = 0;
    const long long left = (t.staged ? c.half : c.rows) - t.row;
    t.count = left < (1LL << h) ? (int)left : 1 << h;
  } else {
    const int per_row = (pass == K4_PASS_A ? c.log_n1 : c.log_n - c.log_n1) - h;
    t.row = blk >> per_row;
    t.first = (blk & ((1LL << per_row) - 1)) << h;
    t.count = 1 << h;
  }
  return t;
}

// The batch row of tile column col, and in *cl its column among those of
// its row (col itself but in a staged tile, whose columns from 2^(lc - 1)
// on are the second component's, row half + b).
GL_HD long long k4_col_row(const K4Call& c, int pass, const K4Tile& t, int col, int* cl) {
  const int h = t.lc - t.staged;
  *cl = col & ((1 << h) - 1);
  const long long row = t.staged && (col >> h) ? t.row + c.half : t.row;
  return pass == K4_PASS_ROW ? row + *cl : row;
}

// Task tau of round r.  Pass A's first and last rounds, and pass B's last
// round after others (but staged), put neighbouring tasks on neighbouring
// columns (j1, contiguous in the input and in scratch; k2, contiguous in
// the output); otherwise neighbouring tasks take neighbouring j, then d
// (a staged last round: neighbouring values of a column, whose slots in
// shared memory are 2^(leaf_log + 1) apart).
GL_HD K4Task k4_task(int pass, const K4Tile& t, int r, int tau) {
  const int b = k4_radix_log(t.l, r), lm = t.l - k4_done_log(t.l, r) - b;   // log2 M_r
  K4Task k;
  int q;
  if ((pass == K4_PASS_A && (r == 0 || r == t.rounds - 1)) ||
      (pass == K4_PASS_B && !t.staged && r > 0 && r == t.rounds - 1)) {
    k.c = tau & ((1 << t.lc) - 1);
    q = tau >> t.lc;
  } else {
    q = tau & ((1 << (t.l - b)) - 1);
    k.c = tau >> (t.l - b);
  }
  k.j = q & ((1 << lm) - 1);
  k.d = q >> lm;
  return k;
}

// A call the kernel takes: n up to 2^26, the row path up to 2^13, the
// four-step's factors both up to 2^13, n_in in [1, n], tiles that fit a
// block (k4_tile_fits) and no more columns than the pass has; the leaf
// mode forward only and unscaled, its staged tiles of two columns at least
// (one of each component row).
GL_HD bool k4_valid(const K4Call& c) {
  if (c.log_n < 0 || c.log_n > K4_MAX_LOG_N || c.rows < 0 || c.n_in < 1 ||
      c.n_in > (1LL << c.log_n) || c.in_stride < 0 || c.inverse < 0 || c.inverse > 1)
    return false;
  if (c.leaf_log < 0 || c.leaf_log > c.log_n || !c.leaf_log != !c.x1 ||
      (c.leaf_log ? c.half < 1 || c.rows != 2 * c.half || c.inverse || c.post || c.scale != 1
                  : c.half != 0))
    return false;
  const int l1 = c.log_n1, l2 = c.log_n - c.log_n1, leaf = c.leaf_log != 0;
  if (leaf && c.log_cols[l1 == 0 ? 0 : 2] < 1) return false;
  if (l1 == 0)
    return c.log_n <= K4_PASS_MAX_LOG && k4_tile_fits(c.log_n, c.log_cols[0]);
  return l1 > 0 && l2 > 0 && l1 <= K4_PASS_MAX_LOG && l2 <= K4_PASS_MAX_LOG &&
         c.scratch != nullptr && c.log_cols[1] <= l1 && k4_tile_fits(l2, c.log_cols[1]) &&
         c.log_cols[2] <= l2 + leaf && k4_tile_fits(l1, c.log_cols[2]);
}

// ---------------------------------------------------------------------------
// tables and field
// ---------------------------------------------------------------------------

// Values of the round tables of a pass of 2^l points.
GL_HD long long k4_round_table_elems(int l) {
  long long n = 0;
  for (int r = 0; r < k4_rounds(l) - 1; r++) n += 1LL << (l - k4_done_log(l, r));
  return n;
}

// Round r's table of the pass: w_(L_r)^(j k) at k M_r + j.
GL_HD const uint64_t* k4_round_table(const K4Call& c, int pass, int l, int r) {
  const uint64_t* t = c.tw + (pass == K4_PASS_B ? k4_round_table_elems(c.log_n - c.log_n1) : 0);
  for (int q = 0; q < r; q++) t += 1LL << (l - k4_done_log(l, q));
  return t;
}

// w_n^e for 0 <= e < n on the four-step: lo[e mod 2^h] hi[e >> h], any u64.
GL_HD uint64_t k4_twiddle(const K4Call& c, long long e) {
  const int h = (c.log_n + 1) >> 1;
  const uint64_t* lo = c.tw + k4_round_table_elems(c.log_n - c.log_n1) +
                       k4_round_table_elems(c.log_n1);
  return gl_mul_m(lo[e & ((1LL << h) - 1)], lo[(1LL << h) + (e >> h)]);
}

// Pass A's twiddles of one task, w_n^(j1 (d + k 2^ls)) for k = 0, 1, ...:
// running powers, start w_n^(j1 d) (times the inverse's n^-1), step
// w_n^(j1 2^ls).
struct K4Run {
  uint64_t w, step;
};

GL_HD K4Run k4_run(const K4Call& c, long long j1, long long d, int ls) {
  K4Run run;
  run.w = k4_twiddle(c, j1 * d);
  if (c.scale != 1) run.w = gl_mul_m(run.w, c.scale);   // n^-1, here and not in pass B
  run.step = k4_twiddle(c, j1 << ls);
  return run;
}

GL_HD uint64_t k4_next(K4Run& run) {
  const uint64_t w = run.w;
  run.w = gl_mul_m(run.w, run.step);
  return w;
}

// x 2^k mod p for 0 <= k < 96 and any u64 x, any u64 out: shifts and adds,
// no multiply (2^64 = EPS mod p, one reduction, two from k = 64 on).
template <int K>
GL_HD uint64_t k4_shl(uint64_t x) {
  if constexpr (K == 0) {
    return x;
  } else if constexpr (K >= 64) {
    return gl_reduce128_m(0, k4_shl<K - 64>(x));
  } else if constexpr (K <= 32) {
    return gl_reduce96(x << K, x >> (64 - K));   // the high part is below 2^32
  } else {
    return gl_reduce128_m(x << K, x >> (64 - K));
  }
}

// y w_16^u for 0 < u < 8 as (-1)^neg y 2^k: ntt.py's w_16 is 2^156 mod p,
// so w_16^u = 2^(156 u mod 192) and 2^96 = -1.  The stage twiddles of a
// round's DFT are w_(2^(s+1))^j = w_16^(j 2^(3-s)).  Constant once unrolled.
GL_HD uint64_t k4_unit_mul(uint64_t y, int u, bool* neg) {
  switch (u) {
    case 1: *neg = true; return k4_shl<60>(y);    // 2^156
    case 2: *neg = true; return k4_shl<24>(y);    // 2^120
    case 3: *neg = false; return k4_shl<84>(y);   // 2^84
    case 4: *neg = false; return k4_shl<48>(y);   // 2^48
    case 5: *neg = false; return k4_shl<12>(y);   // 2^12
    case 6: *neg = true; return k4_shl<72>(y);    // 2^168
    default: *neg = true; return k4_shl<36>(y);   // 2^132
  }
}

// The first input of batch row `row` (in the leaf mode x1's from `half` on).
GL_HD const uint64_t* k4_src(const K4Call& c, long long row) {
  return c.leaf_log && row >= c.half ? c.x1 + (row - c.half) * c.in_stride
                                      : c.x + row * c.in_stride;
}

// Where out[row, m] goes: the row's own slot, or its fiber-leaf slot.
GL_HD uint64_t* k4_slot(const K4Call& c, long long row, long long m) {
  if (!c.leaf_log) return c.out + (row << c.log_n) + m;
  const int comp = row >= c.half, lm = c.log_n - c.leaf_log;
  const long long b = comp ? row - c.half : row;
  return c.out + (b << (c.log_n + 1)) + ((m & ((1LL << lm) - 1)) << (c.leaf_log + 1)) +
         ((m >> lm) << 1) + comp;
}

// Input value i of the row at `src`: zero from n_in on, times pre[i].
GL_HD uint64_t k4_in(const K4Call& c, const uint64_t* src, long long i) {
  if (i >= c.n_in) return 0;
  return c.pre ? gl_mul_m(src[i], c.pre[i]) : src[i];
}

// Output position of X[k], and the canonical value stored there.
GL_HD long long k4_dest(const K4Call& c, long long k) {
  return c.inverse ? (0 - k) & ((1LL << c.log_n) - 1) : k;
}

GL_HD uint64_t k4_out(const K4Call& c, long long m, uint64_t v) {
  if (c.scale != 1 && c.log_n1 == 0) v = gl_mul_m(v, c.scale);   // the four-step's: k4_run
  if (c.post) v = gl_mul_m(v, c.post[m]);
  return gl_canon(v);
}

// log2 of the round-0 inputs a[m] that can be nonzero (m below it): the
// pass's value j = j + M_0 m is input j (row path) or j1 + n1 j (pass A),
// zero from n_in on.  Pass B reads scratch, which is full.
GL_HD int k4_live_log(const K4Call& c, int pass, int l) {
  const int b = k4_radix_log(l, 0);
  if (pass == K4_PASS_B) return b;
  const long long jmax =
      pass == K4_PASS_ROW ? c.n_in : (c.n_in + (1LL << c.log_n1) - 1) >> c.log_n1;
  const long long m0 = 1LL << (l - b), live = (jmax + m0 - 1) / m0;
  int z = 0;
  while (z < b && (1LL << z) < live) z++;
  return z;
}

// ---------------------------------------------------------------------------
// the DFT of a task, in registers
// ---------------------------------------------------------------------------

// In place on a[0 .. 2^B): A[k] = sum_m a[m] w_(2^B)^(m k), natural order in
// and out, where a[m] for m >= 2^Z are zero and not read: the first B - Z
// radix-2 stages of the decimation in time would only copy, so every slot
// starts as its stage-(B - Z) value.  Any u64 in and out.
template <int B, int Z>
GL_HD void k4_dft(uint64_t* a) {
  constexpr int R = 1 << B;
  uint64_t w[R];
#pragma unroll
  for (int p = 0; p < R; p++) w[p] = a[k4_rev(p >> (B - Z), Z)];
#pragma unroll
  for (int s = B - Z; s < B; s++)
#pragma unroll
    for (int i = 0; i < R; i += 2 << s)
#pragma unroll
      for (int j = 0; j < (1 << s); j++) {
        const uint64_t x = w[i + j], y0 = w[i + j + (1 << s)];
        bool neg = false;
        const uint64_t y = j ? k4_unit_mul(y0, j << (3 - s), &neg) : y0;
        w[i + j] = neg ? gl_sub_lazy(x, y) : gl_add_lazy(x, y);
        w[i + j + (1 << s)] = neg ? gl_add_lazy(x, y) : gl_sub_lazy(x, y);
      }
#pragma unroll
  for (int p = 0; p < R; p++) a[p] = w[p];
}

template <int B>
GL_HD void k4_dft_live(uint64_t* a, int z) {
  switch (z) {
    case 0: k4_dft<B, 0>(a); break;
    case 1: k4_dft<B, (B < 1 ? B : 1)>(a); break;
    case 2: k4_dft<B, (B < 2 ? B : 2)>(a); break;
    case 3: k4_dft<B, (B < 3 ? B : 3)>(a); break;
    default: k4_dft<B, B>(a); break;
  }
}

// A[k] *= w_(L_r)^(j k) after round r (not the last).
template <int B>
GL_HD void k4_twiddle_round(const K4Call& c, int pass, const K4Tile& t, int r, const K4Task& k,
                            uint64_t* a) {
  const int lm = t.l - k4_done_log(t.l, r) - B;
  const uint64_t* tab = k4_round_table(c, pass, t.l, r) + k.j;
#pragma unroll
  for (int q = 1; q < (1 << B); q++) a[q] = gl_mul_m(a[q], tab[(long long)q << lm]);
}

// ---------------------------------------------------------------------------
// a block's phases: begin, then per round after the first put (barrier)
// get, then store; a barrier also before every put but the first
// ---------------------------------------------------------------------------

// Round 0: each task's inputs from the row (pre and the zeros fused in),
// its DFT and, when more rounds follow, its twiddles.
template <int B>
GL_HD void k4_begin_r(const K4Call& c, int pass, const K4Tile& t, uint64_t* v, int tid, int nthr) {
  constexpr int R = 1 << B;
  const int lm = t.l - B, tasks = 1 << (t.l + t.lc - B);
  const int z = k4_live_log(c, pass, t.l);
#pragma unroll
  for (int u = 0; u < K4_V / R; u++) {
    const int tau = tid + nthr * u;
    if (tau >= tasks) continue;
    uint64_t* a = v + u * R;
    const K4Task k = k4_task(pass, t, 0, tau);
    int cl;
    const long long row = k4_col_row(c, pass, t, k.c, &cl);
    if (pass == K4_PASS_ROW) {
      const uint64_t* src = k4_src(c, row);
      const bool live = cl < t.count;
#pragma unroll
      for (int m = 0; m < R; m++)
        if (m < (1 << z)) a[m] = live ? k4_in(c, src, k.j + ((long long)m << lm)) : 0;
    } else if (pass == K4_PASS_A) {
      const uint64_t* src = k4_src(c, t.row);
      const long long j1 = t.first + k.c;
#pragma unroll
      for (int m = 0; m < R; m++)
        if (m < (1 << z)) a[m] = k4_in(c, src, j1 + ((long long)(k.j + (m << lm)) << c.log_n1));
    } else {
      const uint64_t* src = c.scratch + (row << c.log_n) + ((t.first + cl) << c.log_n1) + k.j;
#pragma unroll
      for (int m = 0; m < R; m++) a[m] = src[(long long)m << lm];
    }
    k4_dft_live<B>(a, z);
    if (t.rounds > 1) k4_twiddle_round<B>(c, pass, t, 0, k, a);
  }
}

// After round r (not the last, radix 2^B): each task's A[k] to
// Y_(r+1)[d + S_r k][j].
template <int B>
GL_HD void k4_put_r(const K4Call& c, int pass, const K4Tile& t, uint64_t* sm, int r,
                    const uint64_t* v, int tid, int nthr) {
  (void)c;
  constexpr int R = 1 << B;
  const int ld = k4_done_log(t.l, r), lm = t.l - ld - B, pitch = k4_pitch(t.l, pass);
  const int tasks = 1 << (t.l + t.lc - B);
#pragma unroll
  for (int u = 0; u < K4_V / R; u++) {
    const int tau = tid + nthr * u;
    if (tau >= tasks) continue;
    const uint64_t* a = v + u * R;
    const K4Task k = k4_task(pass, t, r, tau);
    uint64_t* col = sm + k.c * pitch;
#pragma unroll
    for (int q = 0; q < R; q++) col[k4_pad(((k.d + (q << ld)) << lm) + k.j)] = a[q];
  }
}

// Round r >= 1: each task's inputs Y_r[d][j + M_r m] from shared memory,
// its DFT and, when more rounds follow, its twiddles.
template <int B>
GL_HD void k4_get_r(const K4Call& c, int pass, const K4Tile& t, const uint64_t* sm, int r,
                    uint64_t* v, int tid, int nthr) {
  constexpr int R = 1 << B;
  const int lr = t.l - k4_done_log(t.l, r), lm = lr - B, pitch = k4_pitch(t.l, pass);
  const int tasks = 1 << (t.l + t.lc - B);
#pragma unroll
  for (int u = 0; u < K4_V / R; u++) {
    const int tau = tid + nthr * u;
    if (tau >= tasks) continue;
    uint64_t* a = v + u * R;
    const K4Task k = k4_task(pass, t, r, tau);
    const uint64_t* col = sm + k.c * pitch;
    const int base = (k.d << lr) + k.j;
#pragma unroll
    for (int m = 0; m < R; m++) a[m] = col[k4_pad(base + (m << lm))];
    k4_dft<B, B>(a);
    if (r < t.rounds - 1) k4_twiddle_round<B>(c, pass, t, r, k, a);
  }
}

// Shared-memory slot of staged value e: a pair of spare slots every 32
// values, so that the pair (2p, 2p + 1) is one aligned 16-byte load and
// the last round's writes, 2^(leaf_log + 1) values apart, spread over the
// banks.
GL_HD int k4_stage_pad(int e) { return e + ((e >> 5) << 1); }

// Two consecutive words, 16-byte aligned: one 16-byte access on the card.
GL_HD void k4_load2(const uint64_t* src, uint64_t* w) {
#ifdef __CUDA_ARCH__
  const ulonglong2 p = *reinterpret_cast<const ulonglong2*>(src);
  w[0] = p.x;
  w[1] = p.y;
#else
  w[0] = src[0];
  w[1] = src[1];
#endif
}

GL_HD void k4_store2(uint64_t* dst, const uint64_t* w) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(w[0], w[1]);
#else
  dst[0] = w[0];
  dst[1] = w[1];
#endif
}

// k1's l bits turned g to the right: k1 = k 2^g + t becomes t 2^(l - g) + k.
GL_HD int k4_rot(int k1, int g, int l) { return ((k1 & ((1 << g) - 1)) << (l - g)) | (k1 >> g); }

// Slot, before k4_stage_pad, of value k1 (< 2^l) of column cl of component
// comp in a staged tile: e = (cl << (l + 1)) | (rot(k1) << 1) | comp, rot
// by g = max(l - leaf_log, 0).  Row path: m = k1 = k M + t is slot k of
// leaf t, so e runs over the tile's proofs' leaves in the output's order;
// pass B: m mod M = k2 + n2 t and m div M = k, so e runs over column cl's
// whole leaves, each 2^(leaf_log + 1) words (see the top of the file).
GL_HD int k4_stage_index(const K4Tile& t, int leaf_log, int cl, int k1, int comp) {
  const int g = t.l > leaf_log ? t.l - leaf_log : 0;
  return (((cl << t.l) | k4_rot(k1, g, t.l)) << 1) | comp;
}

// The last round's A[k] = X[d + S k] (S = S_(rounds - 1)) of the pass:
// to the output (row path, pass B: inverse's reversal, scale and post
// fused, canonical), to shared memory (a staged tile: k4_flush stores it)
// or to scratch times pass A's twiddle w_n^(j1 k2).
template <int B>
GL_HD void k4_store_r(const K4Call& c, int pass, const K4Tile& t, uint64_t* sm,
                      const uint64_t* v, int tid, int nthr) {
  constexpr int R = 1 << B;
  const int ls = k4_done_log(t.l, t.rounds - 1), tasks = 1 << (t.l + t.lc - B);
#pragma unroll
  for (int u = 0; u < K4_V / R; u++) {
    const int tau = tid + nthr * u;
    if (tau >= tasks) continue;
    const uint64_t* a = v + u * R;
    const K4Task k = k4_task(pass, t, t.rounds - 1, tau);
    if (t.staged) {   // the leaf mode: forward, no scaling (k4_valid)
      // k1 = d + q 2^ls with d < 2^ls: the rotation of k1 is that of d or'd
      // with that of q 2^ls, their bits apart
      const int h = t.lc - 1, g = t.l > c.leaf_log ? t.l - c.leaf_log : 0;
      const int head = k4_stage_index(t, c.leaf_log, k.c & ((1 << h) - 1), k.d, k.c >> h);
#pragma unroll
      for (int q = 0; q < R; q++)
        sm[k4_stage_pad(head | (k4_rot(q << ls, g, t.l) << 1))] = gl_canon(a[q]);
    } else if (pass == K4_PASS_ROW) {
      if (k.c >= t.count) continue;
#pragma unroll
      for (int q = 0; q < R; q++) {
        const long long m = k4_dest(c, k.d + ((long long)q << ls));
        *k4_slot(c, t.row + k.c, m) = k4_out(c, m, a[q]);
      }
    } else if (pass == K4_PASS_A) {
      const long long j1 = t.first + k.c;
      uint64_t* dst = c.scratch + (t.row << c.log_n) + j1;
      K4Run run = k4_run(c, j1, k.d, ls);
#pragma unroll
      for (int q = 0; q < R; q++)
        dst[(k.d + ((long long)q << ls)) << c.log_n1] = gl_mul_m(a[q], k4_next(run));
    } else {
      const long long k2 = t.first + k.c;
      const int log_n2 = c.log_n - c.log_n1;
#pragma unroll
      for (int q = 0; q < R; q++) {
        const long long m = k4_dest(c, k2 + ((k.d + ((long long)q << ls)) << log_n2));
        *k4_slot(c, t.row, m) = k4_out(c, m, a[q]);
      }
    }
  }
}

// A staged tile's words from shared memory to the output, in slot order
// (k4_stage_index), a pair of words (the two components of one value) at
// a time: thread tid the pairs tid + nthr u, all loaded (into v, free
// after the store) before any is stored, each stored as 16 bytes, so that
// a warp stores 64 consecutive words of the output wherever a run of
// whole leaves holds them.  The row path's tile is one run from its first
// proof's leaves; in pass B, where the column holds whole leaves
// (leaf_log <= l), slot e is word e mod 2^(leaf_log + 1) of leaf
// first + cl + n2 t (t = bits leaf_log + 1 .. l of e), else the pair goes
// to k4_slot of its (row, m) and the next word.
GL_HD void k4_flush(const K4Call& c, int pass, const K4Tile& t, const uint64_t* sm,
                    uint64_t* v, int tid, int nthr) {
  const int g = t.l > c.leaf_log ? t.l - c.leaf_log : 0, kb = t.l - g, ll = c.leaf_log + 1;
  const int pairs = 1 << (t.l + t.lc - 1), log_n2 = c.log_n - c.log_n1;
  uint64_t* const base = c.out + (t.row << (c.log_n + 1));
#pragma unroll
  for (int u = 0; u < K4_V / 2; u++) {
    const int p = tid + nthr * u;
    if (p < pairs) k4_load2(sm + k4_stage_pad(2 * p), v + 2 * u);
  }
#pragma unroll
  for (int u = 0; u < K4_V / 2; u++) {
    const int p = tid + nthr * u, e = 2 * p, cl = e >> (t.l + 1);
    if (p >= pairs || (pass == K4_PASS_ROW && cl >= t.count)) continue;   // past the last proof
    uint64_t* dst;
    if (pass == K4_PASS_ROW) {
      dst = base + e;
    } else if (c.leaf_log <= t.l) {   // leaf < M <= 2^25
      const int leaf = (int)t.first + cl + (((e >> ll) & ((1 << g) - 1)) << log_n2);
      dst = base + ((long long)leaf << ll) + (e & ((1 << ll) - 1));
    } else {
      const int r = (e >> 1) & ((1 << t.l) - 1);
      const long long k1 = ((long long)(r & ((1 << kb) - 1)) << g) | (r >> kb);
      dst = k4_slot(c, t.row, t.first + cl + (k1 << log_n2));
    }
    k4_store2(dst, v + 2 * u);
  }
}

// A block's work on a pass of 2^L points, its phases in order: round 0,
// then for each later round a put of the last round's values (after a
// barrier: every read of the exchange before it done), a barrier and the
// round's get, then the store; a staged tile's store goes to shared
// memory (after a barrier, where rounds exchanged there), and after
// another barrier the flush stores it to the output.  `blk` runs a phase
// for the block's threads and holds their values: on the card one thread
// and __syncthreads (ntt.cu), in the host tests every thread in turn and
// no barrier.
template <int L, class Block>
GL_HD void k4_block(Block& blk) {
  constexpr int k = k4_rounds(L);
  blk.template begin<k4_radix_log(L, 0)>();
  if constexpr (k > 1) {
    blk.template put<k4_radix_log(L, 0)>(0);
    blk.sync();
    blk.template get<k4_radix_log(L, 1)>(1);
  }
  if constexpr (k > 2) {
    blk.sync();
    blk.template put<k4_radix_log(L, 1)>(1);
    blk.sync();
    blk.template get<k4_radix_log(L, 2)>(2);
  }
  if constexpr (k > 3) {
    blk.sync();
    blk.template put<k4_radix_log(L, 2)>(2);
    blk.sync();
    blk.template get<k4_radix_log(L, 3)>(3);
  }
  static_assert(k <= 4, "a pass has at most four rounds");
  if (k4_staged(blk.c, blk.pass)) {
    if constexpr (k > 1) blk.sync();
    blk.template store<k4_radix_log(L, k - 1)>();
    blk.sync();
    blk.flush();
  } else {
    blk.template store<k4_radix_log(L, k - 1)>();
  }
}

// The kernel's pass lengths, 2^0 .. 2^K4_PASS_MAX_LOG: F<L>(args...) for
// the call's L.
#define K4_BY_LEN(l, F, ...)                   \
  switch (l) {                                 \
    case 0: F<0>(__VA_ARGS__); break;          \
    case 1: F<1>(__VA_ARGS__); break;          \
    case 2: F<2>(__VA_ARGS__); break;          \
    case 3: F<3>(__VA_ARGS__); break;          \
    case 4: F<4>(__VA_ARGS__); break;          \
    case 5: F<5>(__VA_ARGS__); break;          \
    case 6: F<6>(__VA_ARGS__); break;          \
    case 7: F<7>(__VA_ARGS__); break;          \
    case 8: F<8>(__VA_ARGS__); break;          \
    case 9: F<9>(__VA_ARGS__); break;          \
    case 10: F<10>(__VA_ARGS__); break;        \
    case 11: F<11>(__VA_ARGS__); break;        \
    case 12: F<12>(__VA_ARGS__); break;        \
    default: F<13>(__VA_ARGS__); break;        \
  }
