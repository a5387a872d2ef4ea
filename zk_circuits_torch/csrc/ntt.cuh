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
//   coset_intt    inverse, scale = n^-1, post = shift^-m
//   lde           pre = shift^i, n = n_in 2^rate_bits
//
// Every output is canonical, so equal to the stage loop's (field results
// are unique).  Two paths:
//
//   row path   (log_n1 = 0, n <= 2^K4_TILE_LOG): a block holds a tile of
//              whole rows in shared memory: loaded at bit-reversed
//              positions, log2(n) radix-2 stages, stored in natural order
//              (ntt.py's _bit_reverse_indices and its stage twiddles
//              w_{2^(s+1)}^j).
//   four-step  (n = n1 n2, both <= 2^K4_TILE_LOG): input i = j1 + n1 j2,
//              output k = k2 + n2 k1 (the maps of the JAX package's
//              ntt_mxu.py:167-191, with any factors the call names):
//     pass A   a block takes one batch row's j1 in [first, first + R):
//              NTT_{n2} over j2 of each, times w_n^(j1 k2), written to
//              scratch[row, k2, j1];
//     pass B   a block takes one batch row's k2 in [first, first + R):
//              NTT_{n1} over j1 of each (a contiguous run of scratch),
//              written to output k2 + n2 k1.
//
// One twiddle table serves every stage and the four-step's twiddle: its
// stage s segment, 2^s values from slot 2^s - 1, holds w_{2^(s+1)}^j
// (j < 2^s), whatever the length of the transform the stage belongs to;
// the last segment is w_n^e for e < n / 2, and w_n^e for e >= n / 2 is
// -w_n^(e - n / 2).  A warp's neighbouring butterflies read neighbouring
// twiddles.
//
// Shared memory: tile row r starts at r * k4_pitch(l) and element i sits
// at k4_pad(i, l), one spare slot every 2^(l-5) elements.  The bit-reversed
// scatter of a warp's 32 neighbouring elements then lands in 32 banks
// instead of one, and an odd pitch spreads pass A's rows over the banks.
// The kernel's loops run thread tid of nthr over the tile; the host tests
// run a block's threads one after another between the barriers.
#pragma once

#include "goldilocks.cuh"

#define K4_TILE_LOG 13    // a tile holds 2^13 elements (plus padding)
#define K4_THREADS 512    // threads a block
#define K4_MAX_LOG_N 26   // 2 K4_TILE_LOG: the four-step's largest n
// The largest tile in shared-memory slots: 2^7 rows of 2^6 elements at a
// pitch of 97 (every other tile is smaller: k4_smem_elems).
#define K4_SMEM_MAX_ELEMS 12416

enum K4Pass { K4_PASS_ROW = 0, K4_PASS_A = 1, K4_PASS_B = 2 };

struct K4Call {
  const uint64_t* x;         // input rows: row r at x + r * in_stride
  uint64_t* out;             // (rows, n), contiguous
  uint64_t* scratch;         // (rows, n2, n1): pass A's output (four-step only)
  const uint64_t* tw;        // stage s at tw + 2^s - 1: w_{2^(s+1)}^j, j < 2^s
  const uint64_t* pre;       // shift^i for i < n_in, or null
  const uint64_t* post;      // shift^-m for m < n, or null
  unsigned long long scale;  // n^-1 for an inverse transform, else 1
  long long rows, in_stride, n_in;
  int log_n, log_n1;         // log_n1 = 0: the row path; else n1 = 2^log_n1
  int inverse;
};

// The rows of one block's tile.  Row path: batch rows row .. row + count - 1.
// Passes A and B: batch row `row`, j1 (A) or k2 (B) first .. first + count - 1,
// count = 2^log_count.
struct K4Tile {
  long long row, first;
  int count, log_count, log_len;
};

// ---------------------------------------------------------------------------
// indices
// ---------------------------------------------------------------------------

// j's lowest `bits` bits reversed.
GL_HD unsigned k4_rev(unsigned j, int bits) {
#ifdef __CUDA_ARCH__
  return bits ? __brev(j) >> (32 - bits) : 0u;
#else
  unsigned r = 0;
  for (int b = 0; b < bits; b++) r |= ((j >> b) & 1u) << (bits - 1 - b);
  return r;
#endif
}

// Shared-memory slot of element i of a tile row of 2^l elements.
GL_HD int k4_pad(int i, int l) { return l > 5 ? i + (i >> (l - 5)) : i; }

// Slots a tile row of 2^l elements takes (odd from l = 6 on).
GL_HD int k4_pitch(int l) { return l > 5 ? (1 << l) + 33 : 1 << l; }

GL_HD int k4_log_len(const K4Call& c, int pass) {
  return pass == K4_PASS_ROW ? c.log_n : pass == K4_PASS_A ? c.log_n - c.log_n1 : c.log_n1;
}

// log2 of the rows of a full tile.
GL_HD int k4_log_tile_rows(const K4Call& c, int pass) {
  const int l = k4_log_len(c, pass);
  const int most = pass == K4_PASS_ROW ? 30 : pass == K4_PASS_A ? c.log_n1 : c.log_n - c.log_n1;
  const int fit = K4_TILE_LOG - l;
  return fit < most ? fit : most;
}

GL_HD long long k4_blocks(const K4Call& c, int pass) {
  const int lr = k4_log_tile_rows(c, pass);
  if (pass == K4_PASS_ROW) return (c.rows + (1LL << lr) - 1) >> lr;
  const int per_row = pass == K4_PASS_A ? c.log_n1 : c.log_n - c.log_n1;
  return c.rows << (per_row - lr);
}

// Shared-memory elements of a block of the pass.
GL_HD long long k4_smem_elems(const K4Call& c, int pass) {
  long long r = 1LL << k4_log_tile_rows(c, pass);
  if (pass == K4_PASS_ROW && c.rows < r) r = c.rows;
  return r * k4_pitch(k4_log_len(c, pass));
}

GL_HD K4Tile k4_tile(const K4Call& c, int pass, long long blk) {
  K4Tile t;
  t.log_len = k4_log_len(c, pass);
  t.log_count = k4_log_tile_rows(c, pass);
  if (pass == K4_PASS_ROW) {
    t.row = blk << t.log_count;
    t.first = 0;
    const long long left = c.rows - t.row;
    t.count = left < (1LL << t.log_count) ? (int)left : 1 << t.log_count;
  } else {
    const int per_row = (pass == K4_PASS_A ? c.log_n1 : c.log_n - c.log_n1) - t.log_count;
    t.row = blk >> per_row;
    t.first = (blk & ((1LL << per_row) - 1)) << t.log_count;
    t.count = 1 << t.log_count;
  }
  return t;
}

// A call the kernel takes: n up to 2^26, the row path up to 2^13, the
// four-step's factors both up to 2^13, n_in in [1, n].
GL_HD bool k4_valid(const K4Call& c) {
  if (c.log_n < 0 || c.log_n > K4_MAX_LOG_N || c.rows < 0 || c.n_in < 1 ||
      c.n_in > (1LL << c.log_n) || c.in_stride < 0 || c.inverse < 0 || c.inverse > 1)
    return false;
  if (c.log_n1 == 0) return c.log_n <= K4_TILE_LOG;
  return c.log_n1 > 0 && c.log_n1 < c.log_n && c.log_n1 <= K4_TILE_LOG &&
         c.log_n - c.log_n1 <= K4_TILE_LOG && c.scratch != nullptr;
}

// ---------------------------------------------------------------------------
// field
// ---------------------------------------------------------------------------

// Input element i of the row at `src`: zero from n_in on, times pre[i].
GL_HD uint64_t k4_in(const K4Call& c, const uint64_t* src, long long i) {
  if (i >= c.n_in) return 0;
  const uint64_t v = gl_canon(src[i]);
  return c.pre ? gl_canon(gl_mul(v, c.pre[i])) : v;
}

// Output position of X[k], and the value stored there.
GL_HD long long k4_dest(const K4Call& c, long long k) {
  return c.inverse ? (0 - k) & ((1LL << c.log_n) - 1) : k;
}

GL_HD uint64_t k4_out(const K4Call& c, long long m, uint64_t v) {
  if (c.scale != 1) v = gl_canon(gl_mul(v, c.scale));
  return c.post ? gl_canon(gl_mul(v, c.post[m])) : v;
}

// w_n^e for e < n (n >= 2), from the table's last segment.
GL_HD uint64_t k4_twiddle(const K4Call& c, long long e) {
  const long long h = 1LL << (c.log_n - 1);
  const uint64_t* last = c.tw + h - 1;
  return e < h ? last[e] : GL_P - last[e - h];   // w != 0
}

// ---------------------------------------------------------------------------
// a block's three phases (barriers between them and between stages)
// ---------------------------------------------------------------------------

GL_HD void k4_load(const K4Call& c, int pass, const K4Tile& t, uint64_t* sm, int tid, int nthr) {
  const int l = t.log_len, pitch = k4_pitch(l), total = t.count << l;
  if (pass == K4_PASS_ROW) {   // neighbouring threads on neighbouring i
    for (int f = tid; f < total; f += nthr) {
      const int r = f >> l, i = f & ((1 << l) - 1);
      sm[r * pitch + k4_pad(k4_rev(i, l), l)] = k4_in(c, c.x + (t.row + r) * c.in_stride, i);
    }
  } else if (pass == K4_PASS_A) {   // neighbouring threads on neighbouring j1
    const uint64_t* src = c.x + t.row * c.in_stride;
    for (int f = tid; f < total; f += nthr) {
      const int r = f & (t.count - 1), j2 = f >> t.log_count;
      sm[r * pitch + k4_pad(k4_rev(j2, l), l)] =
          k4_in(c, src, t.first + r + ((long long)j2 << c.log_n1));
    }
  } else {   // the tile is one contiguous run of scratch
    const uint64_t* src = c.scratch + (t.row << c.log_n) + (t.first << c.log_n1);
    for (int f = tid; f < total; f += nthr) {
      const int r = f >> l, j1 = f & ((1 << l) - 1);
      sm[r * pitch + k4_pad(k4_rev(j1, l), l)] = src[f];
    }
  }
}

// Radix-2 stage s of every row of the tile: butterflies 2^s apart.
GL_HD void k4_stage(const K4Call& c, const K4Tile& t, uint64_t* sm, int s, int tid, int nthr) {
  const int l = t.log_len, pitch = k4_pitch(l), total = t.count << (l - 1);
  const uint64_t* tw = c.tw + (1 << s) - 1;
  for (int f = tid; f < total; f += nthr) {
    const int r = f >> (l - 1), u = f & ((1 << (l - 1)) - 1);
    const int j = u & ((1 << s) - 1);
    const int i0 = ((u >> s) << (s + 1)) | j;
    uint64_t* row = sm + r * pitch;
    const int p0 = k4_pad(i0, l), p1 = k4_pad(i0 + (1 << s), l);
    const uint64_t a = row[p0];
    const uint64_t b = gl_canon(gl_mul(row[p1], tw[j]));
    row[p0] = gl_add(a, b);
    row[p1] = gl_sub(a, b);
  }
}

GL_HD void k4_store(const K4Call& c, int pass, const K4Tile& t, const uint64_t* sm, int tid,
                    int nthr) {
  const int l = t.log_len, pitch = k4_pitch(l), total = t.count << l;
  if (pass == K4_PASS_ROW) {   // neighbouring threads on neighbouring k
    for (int f = tid; f < total; f += nthr) {
      const int r = f >> l, k = f & ((1 << l) - 1);
      const long long m = k4_dest(c, k);
      c.out[((t.row + r) << c.log_n) + m] = k4_out(c, m, sm[r * pitch + k4_pad(k, l)]);
    }
  } else if (pass == K4_PASS_A) {   // neighbouring threads on neighbouring j1
    uint64_t* dst = c.scratch + (t.row << c.log_n) + t.first;
    for (int f = tid; f < total; f += nthr) {
      const int r = f & (t.count - 1), k2 = f >> t.log_count;
      const uint64_t w = k4_twiddle(c, (t.first + r) * k2);
      dst[((long long)k2 << c.log_n1) + r] = gl_canon(gl_mul(sm[r * pitch + k4_pad(k2, l)], w));
    }
  } else {   // neighbouring threads on neighbouring k2
    uint64_t* dst = c.out + (t.row << c.log_n);
    const int log_n2 = c.log_n - c.log_n1;
    for (int f = tid; f < total; f += nthr) {
      const int r = f & (t.count - 1), k1 = f >> t.log_count;
      const long long m = k4_dest(c, t.first + r + ((long long)k1 << log_n2));
      dst[m] = k4_out(c, m, sm[r * pitch + k4_pad(k1, l)]);
    }
  }
}
