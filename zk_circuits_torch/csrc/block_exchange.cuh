// Index and field code of the block exchange (K2), __host__ __device__ so
// that tests/test_torch_kernel_host.py runs it on the CPU with g++.
//
// One call of the exchange is described by a BxCall (the wrapper fills it
// in one ctypes buffer).  Source shard s hands a view x_s; destination
// shard d (served as the j-th destination of the launch, d = dst_index[j])
// writes out_j.  The four modes:
//
//   copy        out_d[s, r, :] = x_s[d * blk_stride + r * row_stride + (0..row_len)]
//   dft         out_d[t1, i]   = sum_s W[s, t1] * x_s[d * bm + i]        (W = w_E^(s t1))
//   twiddle     out_d[s bm + i] = x_s[d * bm + i] * w_n^(d (s bm + i))
//   interleave  out_d[i E + t1] = scale * x_t1[src(d * bm + i)],
//               src(k) = k forward, (m - k) mod m inverse
//
// with m = E * bm the shard length (the fused modes are the four-step's
// three exchanges, see parallel/ntt_exchange.py).
#pragma once

#include "goldilocks.cuh"

#define BX_MAX_SHARDS 32

enum BxMode { BX_COPY = 0, BX_DFT = 1, BX_TWIDDLE = 2, BX_INTERLEAVE = 3 };

struct BxCall {
  const uint64_t* src[BX_MAX_SHARDS];   // source shard s's view base
  uint64_t* dst[BX_MAX_SHARDS];         // output of the j-th destination served
  const uint64_t* table;                // twiddle: per destination lo[L] then hi[m / L]
  long long blk_stride, rows, row_len, row_stride;   // copy's view
  long long bm;                         // fused modes: block length m / E
  unsigned long long scale;             // interleave: n^-1 (inverse) or 1
  int dst_index[BX_MAX_SHARDS];         // shard index d of the j-th destination
  int mode, n_src, n_dst, inverse;
  int tw_log;                           // twiddle: log2 L
  unsigned char wshift[BX_MAX_SHARDS * BX_MAX_SHARDS];  // dft: W[s, t1] = 2^wshift (< 192)
};

// ---------------------------------------------------------------------------
// field helpers
// ---------------------------------------------------------------------------

// x * 2^j mod p for any u64 x and 0 <= j < 96, non-canonical.  One 128-bit
// reduction below 64, two from 64 (x 2^(j-64), then times 2^64); shifts
// and adds, no multiply.
GL_HD uint64_t gl_shl96(uint64_t x, int j) {
  if (j >= 64) {
    const int s = j - 64;
    const uint64_t r = s ? gl_reduce128(x << s, x >> (64 - s)) : x;
    return gl_reduce128(0, r);
  }
  return j ? gl_reduce128(x << j, x >> (64 - j)) : x;
}

// Canonical x * 2^k mod p for 0 <= k < 192: 2^96 = -1, so k >= 96 negates.
GL_HD uint64_t gl_mul_pow2(uint64_t x, int k) {
  const uint64_t v = gl_canon(gl_shl96(x, k >= 96 ? k - 96 : k));
  return (k >= 96 && v) ? GL_P - v : v;
}

// ---------------------------------------------------------------------------
// copy: the tile walk
// ---------------------------------------------------------------------------

// One tile of the copy: a contiguous run of a source row and the matching
// run of a destination row.  head/body/tail split the run so that the body
// starts 16-byte aligned on both sides and is a whole number of 16-byte
// units (the kernel's 16-byte loads and stores); head and tail (at most one
// element each) take the 8-byte path.  When the two sides sit 8 bytes apart
// modulo 16 no body exists and the whole run takes the 8-byte path.
struct BxTile {
  const uint64_t* src;
  uint64_t* dst;
  long long len, head, body;   // tail = len - head - body
};

// The copy walks tiles of TILE elements (the kernel's BX_COPY_TILE; the
// host tests take smaller ones), TILE even.
template <int TILE>
GL_HD long long bx_tiles_per_row(const BxCall& c) {
  return (c.row_len + TILE - 1) / TILE;
}

template <int TILE>
GL_HD long long bx_num_tiles(const BxCall& c) {
  return (long long)c.n_dst * c.n_src * c.rows * bx_tiles_per_row<TILE>(c);
}

// Tile t of the walk, in (destination, source, row, chunk) order: one
// destination's output is written front to back.  32-bit index arithmetic
// (the launch keeps the walk below 2^31 tiles).
template <int TILE>
GL_HD BxTile bx_tile(const BxCall& c, unsigned t) {
  const unsigned tpr = (unsigned)bx_tiles_per_row<TILE>(c), rows = (unsigned)c.rows;
  const unsigned chunk = t % tpr;
  unsigned rest = t / tpr;
  const unsigned r = rest % rows;
  rest /= rows;
  const int s = (int)(rest % (unsigned)c.n_src);
  const int j = (int)(rest / (unsigned)c.n_src);
  const int d = c.dst_index[j];
  const long long off = (long long)chunk * TILE;
  BxTile tile;
  tile.src = c.src[s] + d * c.blk_stride + (long long)r * c.row_stride + off;
  tile.dst = c.dst[j] + ((long long)s * c.rows + r) * c.row_len + off;
  tile.len = c.row_len - off < TILE ? c.row_len - off : TILE;
  const unsigned long long a = (unsigned long long)tile.src, b = (unsigned long long)tile.dst;
  if ((a ^ b) & 15) {
    tile.head = tile.len;
    tile.body = 0;
  } else {
    tile.head = (a & 15) ? 1 : 0;
    if (tile.head > tile.len) tile.head = tile.len;
    tile.body = (tile.len - tile.head) & ~1LL;
  }
  return tile;
}

// ---------------------------------------------------------------------------
// the fused modes, one column (or element) of one destination
// ---------------------------------------------------------------------------

// The fused modes take the shard count as a template argument (EC = 2, 4,
// 8 unrolls the loops over shards and keeps a column in registers) or at
// run time (EC = 0).
#define BX_E (EC ? EC : c.n_src)

// W[s, t1] * v = v * 2^wshift[s, t1]: every entry of the E-point DFT matrix
// is a power of two for E | 64 (the wrapper checks it).
GL_HD uint64_t bx_dft_term(const BxCall& c, int e, int s, int t1, uint64_t v) {
  return gl_mul_pow2(v, c.wshift[s * e + t1]);
}

// a with its log2(n) low bits reversed.
GL_HD constexpr int bx_bitrev(int a, int n) {
  int r = 0;
  for (int b = 1; b < n; b <<= 1, a >>= 1) r = (r << 1) | (a & 1);
  return r;
}

// The size-EC DFT of v in place, out[t] = sum_s w^(s t) v[s] with
// w = W[1, 1] = 2^sh: a radix-2 decimation-in-time FFT whose twiddles
// w^k are shifts (E/2 log2 E butterflies, a shift in each but those with
// twiddle 1; E = 4 needs one shift).  v canonical in and out.
template <int EC>
GL_HD void bx_fft_pow2(uint64_t* v, int sh) {
#pragma unroll
  for (int a = 0; a < EC; a++) {   // bit-reversed order
    const int b = bx_bitrev(a, EC);
    if (a < b) {
      const uint64_t t = v[a];
      v[a] = v[b];
      v[b] = t;
    }
  }
#pragma unroll
  for (int len = 2; len <= EC; len <<= 1)
#pragma unroll
    for (int start = 0; start < EC; start += len)
#pragma unroll
      for (int k = 0; k < len / 2; k++) {
        const uint64_t u = v[start + k];
        uint64_t t = v[start + k + len / 2];
        if (k) t = gl_mul_pow2(t, sh * (EC / len) * k % 192);
        v[start + k] = gl_add(u, t);
        v[start + k + len / 2] = gl_sub(u, t);
      }
}

// dft: column i of the j-th destination, all E outputs.  With EC set, the
// FFT; else the sum over W's entries (E = 1, 16, 32).
template <int EC>
GL_HD void bx_dft_column(const BxCall& c, int j, long long i) {
  const int e = BX_E, d = c.dst_index[j];
  uint64_t v[EC ? EC : BX_MAX_SHARDS];
#pragma unroll
  for (int s = 0; s < e; s++) v[s] = gl_canon(c.src[s][d * c.bm + i]);
  if (EC) {
    bx_fft_pow2<EC ? EC : 1>(v, c.wshift[e + 1]);
#pragma unroll
    for (int t1 = 0; t1 < e; t1++) c.dst[j][t1 * c.bm + i] = v[t1];
    return;
  }
  for (int t1 = 0; t1 < e; t1++) {
    uint64_t acc = bx_dft_term(c, e, 0, t1, v[0]);
    for (int s = 1; s < e; s++) acc = gl_add(acc, bx_dft_term(c, e, s, t1, v[s]));
    c.dst[j][t1 * c.bm + i] = acc;
  }
}

// twiddle: w_n^(d k) = lo[k mod L] * hi[k / L], with lo = destination d's
// tables (at table + d * (L + m / L)); non-canonical.
GL_HD uint64_t bx_twiddle_factor(const BxCall& c, const uint64_t* lo, long long k) {
  const long long l = 1LL << c.tw_log;
  return gl_mul(lo[k & (l - 1)], lo[l + (k >> c.tw_log)]);
}

GL_HD const uint64_t* bx_twiddle_table(const BxCall& c, int d) {
  const long long l = 1LL << c.tw_log, m = c.bm * c.n_src;
  return c.table + d * (l + (m >> c.tw_log));
}

// twiddle: element i of source block s, k = s bm + i of a destination
// whose tables are lo, loaded as v.
GL_HD uint64_t bx_twiddle_apply(const BxCall& c, const uint64_t* lo, int s, long long i,
                                uint64_t v) {
  return gl_canon(gl_mul(v, bx_twiddle_factor(c, lo, s * c.bm + i)));
}

// interleave: output o = i E + t1 of destination d reads row t1 at
// d bm + i (forward) or its negation mod m (inverse).
template <int EC>
GL_HD const uint64_t* bx_interleave_from(const BxCall& c, int d, long long o) {
  const int e = BX_E;
  const long long i = o / e, t1 = o - i * e, m = c.bm * e, k = d * c.bm + i;
  return c.src[t1] + ((c.inverse && k) ? m - k : k);
}

GL_HD uint64_t bx_interleave_value(const BxCall& c, uint64_t v) {
  return c.inverse ? gl_canon(gl_mul(v, c.scale)) : v;
}
