// The permutation argument's products over H (K6), shared by the CUDA
// kernels (permutation.cu) and a host build for testing.
//
// For each proof b, challenge c and point i of H (x = w^i), with the
// routed wires' values w_j (the NTT of the committed coefficients) and
// their sigmas s_j:
//   num_j = w_j + beta k_j x + gamma,  den_j = w_j + beta s_j + gamma,
//   ratio_t = prod_{j in chunk t} num_j / prod_{j in chunk t} den_j
// over chunks of q wires (the last one shorter where q does not divide
// the routed wires), total = prod_t ratio_t, Z = the exclusive prefix
// product of total over H (Z(0) = 1), and the partial products
// Z ratio_0 ... ratio_t for t < chunks - 1.  1/0 is 0, as in the plain
// version: a chunk whose denominator is 0 has ratio 0.
//
// The points are cut into tiles of c.tile consecutive points (32 to 128
// on the card, sized from the SM count by plonk/permutation_cuda.py), and
// each launch runs a block a tile of a proof:
//   k6_point_block: the block's warps (lanes on consecutive points) split
//     the (chunk, run of a warp's lanes of points) pairs, every
//     challenge's num_t and den_t into shared memory; then a thread a
//     (point, challenge) inverts the point's chunk denominators as one
//     batch (Montgomery's trick: the prefix products, one inverse, and
//     back, each zero put as 1 and its ratio masked back to 0, so the
//     running products equal the plain version's), writes the running
//     products ratio_0 ... ratio_t into the partial-product rows and the
//     total into Z's row, and a tree in shared memory writes the tile's
//     product of totals a challenge to the call's scratch c.tiles (batch,
//     nc, tiles);
//   k6_scan_block: the product of the earlier tiles' entries, the tile's
//     own inclusive scan of its totals, Z (the exclusive product) and the
//     partial-product rows times Z, in place; the last tile writes the
//     closing product (the inclusive product at the last point, 1 for a
//     valid witness).
// Output rows (B, nc (1 + pp), n): Z_0 .. Z_{nc-1}, then challenge 0's pp
// rows, challenge 1's, ...  A call takes at most k6_max_ch challenges
// (K6_MAX_CH, fewer where a tile's chunk values outgrow shared memory); a
// circuit of more is launched once a group, its pointers at the group's
// first challenge (Z row c of the call, its partial products at rows
// pp_row + c pp, its closing products fin_bs apart a proof;
// plonk/permutation_cuda.py).
#pragma once

#include "perm_chunk.cuh"

#define K6_MAX_CH 4          // challenges a launch (the point kernel's products in registers)
#define K6_MAX_TILE 256      // points a tile: up to 32, or a multiple of 32 up to this
#define K6_SMEM_MAX 232448   // bytes of shared memory a block may have (after opting in)

struct K6Call {
  const uint64_t* wv;                     // (batch, routed, n) wire values on H
  long long wv_rs, wv_ps;
  const uint64_t* sig;                    // (routed, n)
  long long sig_rs;
  const uint64_t* x;                      // (n,) the subgroup
  const uint64_t* kis;                    // (routed,) coset shifts
  const uint64_t* betas;                  // (nc, batch) each
  const uint64_t* gammas;
  uint64_t* out;                          // (batch, rows, n), rows n apart
  long long out_ps, pp_row;
  uint64_t* finals;                       // (batch, fin_bs)
  long long fin_bs;
  uint64_t* tiles;                        // (batch, nc, k6_tiles) scratch: each tile's product
  long long n;
  int routed, q, nc, batch, tile;
};

GL_HD int k6_chunks(const K6Call& c) { return (c.routed + c.q - 1) / c.q; }

GL_HD long long k6_tiles(const K6Call& c) { return (c.n + c.tile - 1) / c.tile; }

// u64 of the point block's shared memory for nc challenges: beta_c k_j
// (perm_bk_table's stride), each (chunk, challenge, point)'s num and den,
// each (challenge, point)'s total.
GL_HD long long k6_point_smem(int chunks, int nc, int tile) {
  return (long long)nc * PERM_MAX_ROUTED + (2LL * chunks + 1) * nc * tile;
}

// Challenges a launch for `routed` wires in chunks of q and tiles of
// `tile` points: K6_MAX_CH, or fewer where the point block's shared memory
// would pass K6_SMEM_MAX; 0 where even one would (never for tiles of up to
// 32 points and routed <= PERM_MAX_ROUTED).
GL_HD int k6_max_ch(int routed, int q, int tile) {
  const int chunks = (routed + q - 1) / q;
  int nc = K6_MAX_CH;
  while (nc >= 1 && k6_point_smem(chunks, nc, tile) * 8 > K6_SMEM_MAX) nc--;
  return nc;
}

// A tile's runs of lanes: a warp's 32 (or the whole tile, up to 32 points).
GL_HD int k6_lanes(int tile) { return tile < 32 ? tile : 32; }

// a^(p-2) = 1/a (0 for 0) by an addition chain: a^(2^k - 1) for k = 2, 3,
// 6, 12, 24, 30, 31, 32, then (a^(2^31 - 1))^(2^33) a^(2^32 - 1), since
// p - 2 = (2^31 - 1) 2^33 + 2^32 - 1: 64 squarings and 9 products.
GL_HD uint64_t k6_sqn(uint64_t a, int n) {
  for (int k = 0; k < n; k++) a = gl_mul_m(a, a);
  return a;
}

GL_HD uint64_t k6_inverse(uint64_t a) {
  const uint64_t x2 = gl_mul_m(k6_sqn(a, 1), a);
  const uint64_t x3 = gl_mul_m(k6_sqn(x2, 1), a);
  const uint64_t x6 = gl_mul_m(k6_sqn(x3, 3), x3);
  const uint64_t x12 = gl_mul_m(k6_sqn(x6, 6), x6);
  const uint64_t x24 = gl_mul_m(k6_sqn(x12, 12), x12);
  const uint64_t x30 = gl_mul_m(k6_sqn(x24, 6), x6);
  const uint64_t x31 = gl_mul_m(k6_sqn(x30, 1), a);
  const uint64_t x32 = gl_mul_m(k6_sqn(x31, 1), a);
  return gl_mul_m(k6_sqn(x31, 33), x32);
}

// Point p of the tile at base, challenge ch, from its chunk values num
// and den ((chunk, challenge, point) in shared memory, NC challenges, T
// points): the running products into the partial-product rows, the total
// into Z's row; returns the total.  One batch inversion of the chunk
// denominators: D_t = prod_{s <= t} den_s with each zero put as 1, one
// inverse of the last, then D_t^-1 from the last down (D_(t-1)^-1 = D_t^-1
// den_t), so ratio_0 ... ratio_t = N_t D_t^-1 (N_t the prefix of num), and
// 0 from the first zero on.  num is overwritten with N_t, den's zeros
// with 1.
template <int NC>
GL_HD uint64_t k6_point_ratios(const K6Call& c, int b, long long base, int ch, int p,
                               uint64_t* num, uint64_t* den, int T) {
  const int chunks = k6_chunks(c), pp = chunks - 1;
  uint64_t nr = 1, dr = 1;
  int zero = chunks;                      // the first chunk whose denominator is 0
  for (int t = 0; t < chunks; t++) {
    uint64_t* nt = num + (t * NC + ch) * T + p;
    uint64_t* dt = den + (t * NC + ch) * T + p;
    if (gl_canon(*dt) == 0) {
      if (zero == chunks) zero = t;
      *dt = 1;
    }
    nr = t ? gl_mul_m(nr, *nt) : *nt;
    dr = t ? gl_mul_m(dr, *dt) : *dt;
    *nt = nr;
  }
  uint64_t inv = k6_inverse(dr), total = 0;
  uint64_t* out = c.out + b * c.out_ps + base + p;
  for (int t = chunks - 1; t >= 0; t--) {
    const uint64_t r = t >= zero ? 0 : gl_mul_m(num[(t * NC + ch) * T + p], inv);
    if (t < pp)
      out[(c.pp_row + ch * pp + t) * c.n] = gl_canon(r);
    else
      total = r;
    if (t) inv = gl_mul_m(inv, den[(t * NC + ch) * T + p]);
  }
  out[ch * c.n] = gl_canon(total);
  return total;
}

// The point block of tile g of proof b: blk.threads() threads, a multiple
// of k6_lanes(c.tile) (each run of them a "warp", its threads on
// consecutive points); blk.each(f) runs f(tid) for each thread, blk.sync()
// is the barrier; sm: k6_point_smem(chunks, NC, c.tile) u64 of shared
// memory.
template <int NC, class Blk>
GL_HD void k6_point_block(Blk& blk, const K6Call& c, int b, long long g, uint64_t* sm) {
  const int T = c.tile, L = k6_lanes(T), runs = T / L, nthr = blk.threads(), nw = nthr / L;
  const int chunks = k6_chunks(c);
  uint64_t* bk = sm;                                  // beta_c k_j
  uint64_t* num = bk + NC * PERM_MAX_ROUTED;          // (chunk, challenge, point)
  uint64_t* den = num + (long long)chunks * NC * T;
  uint64_t* tot = den + (long long)chunks * NC * T;   // (challenge, point)
  const long long base = g * T;
  blk.each([&](int tid) {
    perm_bk_table<NC>(c.kis, c.routed, c.betas, c.batch, b, bk, tid, nthr);
  });
  blk.sync();
  // every challenge's chunk products: warp w takes the (chunk, run) pairs
  // w, w + nw, ..., lane l the run's point l
  blk.each([&](int tid) {
    uint64_t be[NC], ga[NC], nm[NC], dn[NC];
#pragma unroll
    for (int ch = 0; ch < NC; ch++) {
      be[ch] = gl_ld(c.betas + ch * c.batch + b);
      ga[ch] = gl_ld(c.gammas + ch * c.batch + b);
    }
    for (int pair = tid / L; pair < chunks * runs; pair += nw) {
      const int t = pair / runs, p = pair % runs * L + tid % L;
      const long long i = base + p;
      if (i >= c.n) continue;
      const int lo = t * c.q, hi = lo + c.q < c.routed ? lo + c.q : c.routed;
      perm_chunk<NC>(c.wv + b * c.wv_ps + i, c.wv_rs, c.sig + i, c.sig_rs, lo, hi,
                     gl_ld(c.x + i), bk, be, ga, nm, dn);
#pragma unroll
      for (int ch = 0; ch < NC; ch++) {
        num[(t * NC + ch) * T + p] = nm[ch];
        den[(t * NC + ch) * T + p] = dn[ch];
      }
    }
  });
  blk.sync();
  // a thread a (challenge, point), the points of a challenge side by side
  blk.each([&](int tid) {
    for (int v = tid; v < NC * T; v += nthr) {
      const int ch = v / T, p = v % T;
      tot[v] = base + p < c.n ? k6_point_ratios<NC>(c, b, base, ch, p, num, den, T) : 1;
    }
  });
  blk.sync();
  // the tile's product of totals a challenge, a tree
  for (int d = 1; d < T; d <<= 1) {
    blk.each([&](int tid) {
      for (int v = tid; v < NC * T; v += nthr) {
        const int p = v % T;
        if (p % (2 * d) == 0 && p + d < T) tot[v] = gl_mul_m(tot[v], tot[v + d]);
      }
    });
    blk.sync();
  }
  blk.each([&](int tid) {
    for (int ch = tid; ch < NC; ch += nthr) c.tiles[(b * c.nc + ch) * k6_tiles(c) + g] = tot[ch * T];
  });
}

// u64 of the scan block's shared memory: the earlier tiles' products (nc,
// threads), the two buffers of the tile's scan and Z (nc, tile) each.
GL_HD int k6_scan_smem(int nc, int threads, int tile) { return nc * (threads + 3 * tile); }

// The scan block of tile g of proof b by blk.threads() threads; sm:
// k6_scan_smem(c.nc, blk.threads(), c.tile) u64.
template <class Blk>
GL_HD void k6_scan_block(Blk& blk, const K6Call& c, int b, long long g, uint64_t* sm) {
  const int T = c.tile, nthr = blk.threads(), nc = c.nc, pp = k6_chunks(c) - 1;
  const long long tiles = k6_tiles(c), base = g * T;
  uint64_t* part = sm;                                // (challenge, thread)
  uint64_t* buf[2] = {part + nc * nthr, part + nc * (nthr + T)};   // (challenge, point)
  uint64_t* zv = part + nc * (nthr + 2 * T);          // Z at the tile's points
  uint64_t* out = c.out + b * c.out_ps + base;
  // each thread's share of the earlier tiles' products (strided), and the
  // tile's totals (1 past n)
  blk.each([&](int tid) {
    for (int ch = 0; ch < nc; ch++) {
      const uint64_t* ent = c.tiles + (b * nc + ch) * tiles;
      uint64_t acc = 1;
      for (long long k = tid; k < g; k += nthr) acc = gl_mul_m(acc, ent[k]);
      part[ch * nthr + tid] = acc;
    }
    for (int v = tid; v < nc * T; v += nthr) {
      const int ch = v / T, p = v % T;
      buf[0][v] = base + p < c.n ? out[ch * c.n + p] : 1;
    }
  });
  blk.sync();
  // the threads' shares by a tree, the tile's inclusive scan (Hillis-Steele)
  int src = 0;
  for (int d = 1; d < nthr || d < T; d <<= 1) {
    blk.each([&](int tid) {
      if (tid % (2 * d) == 0 && tid + d < nthr)
        for (int ch = 0; ch < nc; ch++)
          part[ch * nthr + tid] = gl_mul_m(part[ch * nthr + tid], part[ch * nthr + tid + d]);
      if (d < T)
        for (int v = tid; v < nc * T; v += nthr) {
          const int p = v % T;
          buf[1 - src][v] = p >= d ? gl_mul_m(buf[src][v - d], buf[src][v]) : buf[src][v];
        }
    });
    blk.sync();
    if (d < T) src ^= 1;
  }
  const uint64_t* incl = buf[src];
  // Z at each point: the earlier tiles' product times the tile's points'
  // before it; the last tile's closing products
  blk.each([&](int tid) {
    for (int v = tid; v < nc * T; v += nthr) {
      const int ch = v / T, p = v % T;
      zv[v] = p ? gl_mul_m(part[ch * nthr], incl[v - 1]) : part[ch * nthr];
    }
    if (g == tiles - 1)
      for (int ch = tid; ch < nc; ch += nthr)
        c.finals[b * c.fin_bs + ch] = gl_canon(gl_mul_m(part[ch * nthr], incl[ch * T + T - 1]));
  });
  blk.sync();
  // Z's rows, and the partial-product rows times Z, in place
  blk.each([&](int tid) {
    for (int v = tid; v < nc * (1 + pp) * T; v += nthr) {
      const int r = v / T, p = v % T;
      if (base + p >= c.n) continue;
      if (r < nc) {
        out[r * c.n + p] = gl_canon(zv[r * T + p]);
      } else {
        uint64_t* o = out + (c.pp_row + (r - nc)) * c.n + p;
        *o = gl_canon(gl_mul_m(*o, zv[(r - nc) / pp * T + p]));
      }
    }
  });
}

// What the kernels refuse: 0 or 1 (cudaErrorInvalidValue).
GL_HD int k6_valid(const K6Call& c) {
  return c.nc >= 1 && c.nc <= K6_MAX_CH && c.pp_row >= c.nc && c.fin_bs >= c.nc && c.n >= 1 &&
                 c.batch >= 1 && c.batch <= 65535 && c.routed >= 1 &&
                 c.routed <= PERM_MAX_ROUTED && c.q >= 1 && c.tile >= 1 &&
                 c.tile <= K6_MAX_TILE && (c.tile <= 32 || c.tile % 32 == 0) && c.tiles &&
                 c.nc <= k6_max_ch(c.routed, c.q, c.tile)
             ? 0
             : 1;
}
