// The openings' and FRI's field arithmetic (K7, K8, K9), shared by the
// CUDA kernels (fri.cu) and a host build for testing.
//
// Extension elements are pairs (a0, a1) of GF(p^2) = GF(p)[x]/(x^2 - 7).
// The oracles' rows are base polynomials of n coefficients, read in place:
// FriRows lists up to FRI_MAX_SETS sets, each a (batch, rows, n) tensor
// given by its pointer and strides (batch stride 0: the circuit's
// constants/sigmas, one copy for every proof) and a table t (0 or 1).  Row
// r of a call is row r - (rows of the sets before) of its set.
//
// K7, the openings (k7_block, a block a tile of coefficients, a group of
// rows of one point and a proof):
//   e[b, r] = sum_i row_r[b, i] z_t[b]^i
// for the point z_t of proof b: zeta (t = 0) or g zeta (t = 1).  A block
// computes the powers of its tile once for its group of rows (no table
// from the host), each row's sum over the tile is unreduced, and the last
// block of a group adds the tiles' sums.
// K8's point kernel, the alpha reduction (k8_point_block, a block a tile of
// 32 points of a proof):
//   comp_t[b, i] = sum over the rows r of table t of alpha[b]^e_r row_r[b, i]
// where row j of a set takes the exponent e = (the set's exp) + j.  K8's
// scan (k8_seg_block, then k8_finish_block: a block a segment of 256 points
// of a proof), both divisions by a linear factor and their sum, from comp_0
// at zeta (z_0) and comp_1 at g zeta (z_1):
//   q_t[i] = sum_{j > i} comp_t[j] z_t^(j - i - 1),
//   f[i] = q_1[i] + s q_0[i] for i < n - 1,  f[n - 1] = 0  (s = alpha^nz).
//
// What bounds K8 on the H100, and what the design does about it.  Its
// point kernel reads every oracle row once (17.5 MB a wormhole proof,
// 0.0054 ms at 3.35 TB/s) against two products a coefficient: bytes.  A
// thread a point walking all the rows in series, 64 blocks at one proof,
// kept too few loads in flight (0.139 ms); here the 8 warps of a block
// split a 32-point tile's rows (a warp's loads are 256 contiguous bytes),
// each lane loading 8 rows before it uses one, so every SM has thousands
// of independent loads in flight, and the warps' sums meet in shared
// memory.  Two products a coefficient are also some 60 instructions when
// each is reduced and added (the card's instruction rate then binds before its
// bytes at B = 4); a lane keeps each set's sums unreduced (gl_acc_mac, 13
// instructions a product) and reduces them once a set.
// The scan moves 0.4 MB a proof: latency.  One block a proof spent an
// inverse and four square-and-multiply powers a thread on one SM (0.164
// ms); here Horner's form of the division needs no inverse and no power
// but z_t^(2^k): a tree a segment (its level k multiplies by z_t^(2^k)),
// the later segments' sums a tree by z_t^(256 2^k), and a Hillis-Steele
// scan by z_t^(2^k) within the segment, over 32 blocks a proof at 2^13
// points, from one table a proof (block 0 of the first launch writes it).
// K9, the fold, new_c[m] = sum_j beta^j c[A m + j] (A = 2^arity_bits),
// with lanes that share an output (k9_fold_block); and a fold round
// (k9_round_fold, k9_round_gather, k9_ntt: a block a coset, component and
// proof): the fold, the next codeword's coset NTT and its fiber leaves,
// what the JAX package's _make_fold_commit_run computes but the Merkle
// levels.  A round's work is small (0.2 MB a wormhole proof) and its time
// latency: the design keeps its steps few and wide, one pass of loads, one
// barrier over a cluster, and NTT rounds of radix 8 (scripts/k9_variants.py).
// Every value in between is any u64 congruent to it (gl_mul_m,
// gl_add_lazy); the stores canonicalise.
#pragma once

#include "goldilocks.cuh"
#include "ntt.cuh"

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#endif

#define FRI_MAX_SETS 8       // sets a FriRows holds
#define FRI_W 7ULL           // x^2 = 7
#define K8_MAX_POW 1024      // powers of alpha a K8 point block keeps (32 x 32 products)
#define K9_MAX_BITS 62       // a fold's arity bits: any arity of a u64-indexed codeword

// A read-only input, through the read-only path on the card.
GL_HD uint64_t fri_ld(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__ldg((const unsigned long long*)p);
#else
  return *p;
#endif
}

// Orders this thread's earlier writes before its later ones for every
// block of the launch (a no-op on the host, whose blocks run in turn).
GL_HD void fri_fence() {
#ifdef __CUDA_ARCH__
  __threadfence();
#endif
}

// *p += 1; returns the old value.
GL_HD unsigned int fri_ticket(unsigned int* p) {
#ifdef __CUDA_ARCH__
  return atomicAdd(p, 1u);
#else
  return (*p)++;
#endif
}

struct FriExt {
  uint64_t a, b;   // a + b x
};

GL_HD FriExt fri_eadd(FriExt x, FriExt y) {
  return {gl_add_lazy(x.a, y.a), gl_add_lazy(x.b, y.b)};
}

GL_HD FriExt fri_emul(FriExt x, FriExt y) {
  return {gl_add_lazy(gl_mul_m(x.a, y.a), gl_mul_m(gl_mul_m(x.b, y.b), FRI_W)),
          gl_add_lazy(gl_mul_m(x.a, y.b), gl_mul_m(x.b, y.a))};
}

// x^2 = (a^2 + 7 b^2) + 2 a b x: three products side by side, one deep.
GL_HD FriExt fri_esqr(FriExt x) {
  const uint64_t ab = gl_mul_m(x.a, x.b);
  return {gl_add_lazy(gl_mul_m(x.a, x.a), gl_mul7(gl_mul_m(x.b, x.b))), gl_add_lazy(ab, ab)};
}

GL_HD FriExt fri_pow(FriExt x, unsigned long long e) {
  FriExt r = {1, 0};
  for (; e; e >>= 1) {
    if (e & 1) r = fri_emul(r, x);
    x = fri_esqr(x);
  }
  return r;
}

GL_HD FriExt fri_ld_ext(const uint64_t* p0, const uint64_t* p1, long long i) {
  return {fri_ld(p0 + i), fri_ld(p1 + i)};
}

GL_HD void fri_st_ext(uint64_t* p0, uint64_t* p1, long long i, FriExt v) {
  p0[i] = gl_canon(v.a);
  p1[i] = gl_canon(v.b);
}

struct FriSet {
  const uint64_t* ptr;   // row 0 of proof 0
  long long bs, rs;      // batch stride (0: shared by the proofs), row stride
  int rows, table;       // rows; point (K7) or output (K8), 0 or 1
  int exp;               // K8: the power of alpha of row 0
};

struct FriRows {
  FriSet sets[FRI_MAX_SETS];
  long long n;           // coefficients a row, contiguous
  int nsets, rows, batch;
};

// Row r of proof b, and its table.
GL_HD const uint64_t* fri_row(const FriRows& t, int b, int r, int* table) {
  for (int s = 0; s < t.nsets; s++) {
    if (r < t.sets[s].rows) {
      *table = t.sets[s].table;
      return t.sets[s].ptr + b * t.sets[s].bs + r * t.sets[s].rs;
    }
    r -= t.sets[s].rows;
  }
  *table = 0;
  return t.sets[0].ptr;   // not reached for r < t.rows
}

GL_HD int fri_rows_valid(const FriRows& t) {
  int rows = 0;
  for (int s = 0; s < t.nsets; s++) {
    if (t.sets[s].rows < 0 || t.sets[s].table < 0 || t.sets[s].table > 1 ||
        t.sets[s].exp < 0)
      return 1;
    rows += t.sets[s].rows;
  }
  return t.nsets >= 1 && t.nsets <= FRI_MAX_SETS && rows == t.rows && t.rows >= 1 &&
                 t.n >= 1 && t.batch >= 1 && t.batch <= 65535
             ? 0
             : 1;
}

// --- K7: the openings ------------------------------------------------------

struct K7Call {
  FriRows r;
  const uint64_t* pts;     // (tables, 2, batch): component k of z_t[b] at (t 2 + k) batch + b
  uint64_t* out;           // (2, batch, rows): component k of e[b, r] at (k batch + b) rows + r
  uint64_t* part;          // scratch (batch, groups, tiles, group, 2): each block's row sums
  unsigned int* counts;    // (batch, groups): blocks of a row group done, 0 between calls
  int tables;              // 1 or 2
  int tile, group;         // coefficients a block (a multiple of 32), rows a group
};

// Point t of proof b.
GL_HD FriExt fri_point(const uint64_t* pts, int batch, int t, int b) {
  return {fri_ld(pts + 2 * t * batch + b), fri_ld(pts + (2 * t + 1) * batch + b)};
}

// The row groups: the rows in order, cut where the table changes and every
// c.group rows after, so a group's rows share one point.
GL_HD int k7_groups(const K7Call& c) {
  int groups = 0;
  for (int s = 0; s < c.r.nsets;) {
    int run = 0;
    for (const int t = c.r.sets[s].table; s < c.r.nsets && c.r.sets[s].table == t; s++)
      run += c.r.sets[s].rows;
    groups += (run + c.group - 1) / c.group;
  }
  return groups;
}

// Group gi's first row and rows; returns its table.
GL_HD int k7_group_rows(const K7Call& c, int gi, int* first, int* rows) {
  int row0 = 0;
  for (int s = 0; s < c.r.nsets;) {
    const int t = c.r.sets[s].table;
    int run = 0;
    for (; s < c.r.nsets && c.r.sets[s].table == t; s++) run += c.r.sets[s].rows;
    const int g = (run + c.group - 1) / c.group;
    if (gi < g) {
      *first = row0 + gi * c.group;
      *rows = run - gi * c.group < c.group ? run - gi * c.group : c.group;
      return t;
    }
    gi -= g;
    row0 += run;
  }
  *first = *rows = 0;
  return 0;   // not reached for gi < k7_groups
}

GL_HD long long k7_tiles(const K7Call& c) { return (c.r.n + c.tile - 1) / c.tile; }

// u64 of a block's shared memory: z^l (l < 32) and z^(base + 32 k) (k <
// tile / 32), the tile's powers z^(base + i), the group's row pointers, the
// last-block flag.
GL_HD int k7_smem(int tile, int group) { return 64 + 2 * (tile / 32) + 2 * tile + group + 1; }

// A load of data another block wrote in this launch: past the SM's own
// (incoherent) L1 on the card.
GL_HD uint64_t fri_ld_cg(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return (uint64_t)__ldcg((const unsigned long long*)p);
#else
  return *p;
#endif
}

// The block of coefficient tile ti, row group gi and proof b, by
// blk.threads() threads in warps of 32 (a multiple of 32): blk.each(f) runs
// f(tid) for each thread, blk.sync() is the barrier, blk.warp_sum<K>(f, g)
// runs f(tid, v) for each thread (K values each) and g(tid, sums) for lane
// 0 of each warp with the warp's sums; sm: k7_smem(c.tile, c.group) u64.
//   1. The tile's powers of the group's point, once for every row: z^l (l
//      < 32) and z^(base + 32 k) by squaring, then one extension product a
//      coefficient, z^(base + i) = z^(i mod 32) z^(base + 32 (i div 32)).
//   2. Warp w sums rows w, w + warps, ... two at a time: lane l takes
//      coefficients base + l + 32 k (k < tile / 32), each row's products
//      with both components of the powers unreduced (gl_acc_mac), reduced
//      once a row; the warp's lanes meet in warp_sum; the row sums go to
//      c.part.
//   3. The block that finishes its (proof, group) last (a counter a group,
//      after a fence) sums the group's rows over the tiles into c.out and
//      sets the counter back to 0.
template <class Blk>
GL_HD void k7_block(Blk& blk, const K7Call& c, int b, long long ti, int gi, uint64_t* sm) {
  const int nthr = blk.threads(), warps = nthr / 32, hk = c.tile / 32;
  const long long n = c.r.n, base = ti * c.tile, tiles = k7_tiles(c);
  int first, nrows;
  const int table = k7_group_rows(c, gi, &first, &nrows);
  uint64_t* lo = sm;                       // z^l: component 0 at l, 1 at 32 + l
  uint64_t* hi = sm + 64;                  // z^(base + 32 k): component 0 at k, 1 at hk + k
  uint64_t* pw = hi + 2 * hk;              // z^(base + i): component 0 at i, 1 at tile + i
  uint64_t* rowp = pw + 2 * c.tile;        // the group's rows of proof b
  uint64_t* last = rowp + c.group;
  const long long slot = (long long)b * k7_groups(c) + gi;   // (proof, group)
  blk.each([&](int tid) {
    const FriExt z = fri_point(c.pts, c.r.batch, table, b);
    for (int v = tid; v < 32 + hk + nrows; v += nthr) {
      if (v < 32 + hk) {
        const FriExt p = fri_pow(z, v < 32 ? (unsigned long long)v : base + 32LL * (v - 32));
        uint64_t* d = v < 32 ? lo + v : hi + (v - 32);
        d[0] = p.a;
        d[v < 32 ? 32 : hk] = p.b;
      } else {
        int t;
        rowp[v - 32 - hk] = (uint64_t)(uintptr_t)fri_row(c.r, b, first + v - 32 - hk, &t);
      }
    }
  });
  blk.sync();
  blk.each([&](int tid) {
    for (int i = tid; i < c.tile; i += nthr) {
      const FriExt p = fri_emul({lo[i & 31], lo[32 + (i & 31)]}, {hi[i >> 5], hi[hk + (i >> 5)]});
      pw[i] = p.a;
      pw[c.tile + i] = p.b;
    }
  });
  blk.sync();
  uint64_t* part = c.part + slot * tiles * c.group * 2 + ti * c.group * 2;
  const int per_warp = (nrows + warps - 1) / warps;
  for (int j = 0; j < per_warp; j += 2) {
    blk.template warp_sum<4>(
        [&](int tid, uint64_t* v) {
          const int w = tid >> 5, lane = tid & 31;
          const int r0 = w + j * warps, r1 = r0 + warps;
          const uint64_t* x0 = (const uint64_t*)(uintptr_t)rowp[r0 < nrows ? r0 : 0];
          const uint64_t* x1 = (const uint64_t*)(uintptr_t)rowp[r1 < nrows ? r1 : 0];
          GlAcc a0 = gl_acc_zero(), b0 = gl_acc_zero(), a1 = gl_acc_zero(), b1 = gl_acc_zero();
          for (int k0 = 0; k0 < hk; k0 += 8) {
            uint64_t y0[8], y1[8];
#pragma unroll
            for (int u = 0; u < 8; u++) {
              const int k = k0 + u;
              const long long i = base + lane + 32LL * k;
              const bool live = k < hk && i < n;
              y0[u] = live && r0 < nrows ? fri_ld(x0 + i) : 0;
              y1[u] = live && r1 < nrows ? fri_ld(x1 + i) : 0;
            }
#pragma unroll
            for (int u = 0; u < 8; u++) {
              const int k = k0 + u;
              if (k < hk) {
                const uint64_t pa = pw[lane + 32 * k], pb = pw[c.tile + lane + 32 * k];
                gl_acc_mac(a0, y0[u], pa);
                gl_acc_mac(b0, y0[u], pb);
                gl_acc_mac(a1, y1[u], pa);
                gl_acc_mac(b1, y1[u], pb);
              }
            }
          }
          v[0] = gl_acc_value(a0);
          v[1] = gl_acc_value(b0);
          v[2] = gl_acc_value(a1);
          v[3] = gl_acc_value(b1);
        },
        [&](int tid, const uint64_t* v) {
          const int r0 = (tid >> 5) + j * warps;
          for (int h = 0; h < 2; h++) {
            const int r = r0 + h * warps;
            if (r < nrows) {
              part[2 * r] = v[2 * h];
              part[2 * r + 1] = v[2 * h + 1];
            }
          }
          fri_fence();
        });
  }
  blk.sync();
  blk.each([&](int tid) {
    if (tid == 0) *last = fri_ticket(c.counts + slot) == (unsigned int)(tiles - 1);
  });
  blk.sync();
  if (!*last) return;
  blk.each([&](int tid) {
    fri_fence();
    const uint64_t* all = c.part + slot * tiles * c.group * 2;
    for (int v = tid; v < 2 * nrows; v += nthr) {
      uint64_t s = 0;
#pragma unroll 8
      for (long long t = 0; t < tiles; t++) s = gl_add_lazy(s, fri_ld_cg(all + t * c.group * 2 + v));
      c.out[((long long)(v & 1) * c.r.batch + b) * c.r.rows + first + (v >> 1)] = gl_canon(s);
    }
    if (tid == 0) c.counts[slot] = 0;
  });
}

GL_HD int k7_valid(const K7Call& c) {
  if (fri_rows_valid(c.r) || c.tables < 1 || c.tables > 2 || c.tile < 32 || c.tile % 32 ||
      c.group < 1 || !c.part || !c.counts)
    return 1;
  for (int s = 0; s < c.r.nsets; s++)
    if (c.r.sets[s].table >= c.tables) return 1;
  return 0;
}

// --- K8: the alpha reduction and the composition -----------------------------

struct K8Call {
  FriRows r;
  const uint64_t* alpha;   // (1, 2, batch): each proof's alpha, as K7Call's pts
  uint64_t* out;           // (tables, 2, batch, n): comp_t's component k at ((t 2 + k) batch + b) n
  int tables;              // 1 or 2
  int npow;                // powers of alpha the sets take: max of exp + rows
};

// K8's point block: K8_PT_WARPS warps of 32 lanes over a tile of 32
// consecutive points of one proof, lane l on point l (a warp's loads are
// 256 contiguous bytes).  Warp w takes rows w, w + K8_PT_WARPS, ... of
// every set, K8_PT_UNROLL of them loaded before any is used, so a point's
// rows are read by all the block's warps at once with many loads in
// flight; the warps' sums meet in shared memory.
#define K8_PT_WARPS 8
#define K8_PT_THREADS (32 * K8_PT_WARPS)
#define K8_PT_TILE 32
#define K8_PT_UNROLL 8                     // rows a warp loads at once
#define K8_PT_VALS 4                       // a lane's sums: (table, component)
// a point block's shared memory in u64: alpha's powers, the two small
// tables they come from, the warps' sums
#define K8_PT_SMEM (2 * K8_MAX_POW + 128 + K8_PT_WARPS * K8_PT_VALS * 32)

// The point block of tile `tile` of proof b; blk.each(f) runs f(tid) for
// each of its K8_PT_THREADS threads, blk.sync() is the barrier; sm:
// K8_PT_SMEM u64 of shared memory.  alpha^e = alpha^(e mod 32) alpha^(32
// (e div 32)): 64 threads compute those 64 powers, then every thread a
// product for a few e, so the table costs the block two short steps.
template <class Blk>
GL_HD void k8_point_block(Blk& blk, const K8Call& c, int b, long long tile, uint64_t* sm) {
  uint64_t* apow = sm;                     // alpha^e: component 0 at e, 1 at K8_MAX_POW + e
  uint64_t* lohi = sm + 2 * K8_MAX_POW;    // alpha^l (l < 32) at l, alpha^(32 l) at 32 + l; +64: component 1
  uint64_t* red = lohi + 128;              // the warps' sums: (warp, value, lane)
  const FriExt a = fri_point(c.alpha, c.r.batch, 0, b);
  blk.each([&](int tid) {
    if (tid < 64) {
      const FriExt p = fri_pow(a, tid < 32 ? (unsigned long long)tid : 32ULL * (tid - 32));
      lohi[tid] = p.a;
      lohi[64 + tid] = p.b;
    }
  });
  blk.sync();
  blk.each([&](int tid) {
    for (int e = tid; e < c.npow; e += K8_PT_THREADS) {
      const FriExt p = fri_emul({lohi[e & 31], lohi[64 + (e & 31)]},
                                {lohi[32 + (e >> 5)], lohi[96 + (e >> 5)]});
      apow[e] = p.a;
      apow[K8_MAX_POW + e] = p.b;
    }
  });
  blk.sync();
  const long long n = c.r.n, base = tile * K8_PT_TILE;
  blk.each([&](int tid) {
    const int w = tid >> 5, lane = tid & 31;
    const bool live = base + lane < n;
    FriExt acc0 = {0, 0}, acc1 = {0, 0};
    for (int s = 0; s < c.r.nsets; s++) {
      const FriSet& set = c.r.sets[s];
      const uint64_t* x = set.ptr + b * set.bs + base + lane;
      const uint64_t* ap = apow + set.exp;
      GlAcc sa = gl_acc_zero(), sb = gl_acc_zero();   // the set's sum, unreduced
      // K8_PT_UNROLL of the warp's rows loaded at once, the set's last
      // batch predicated (one round trip where a loop over the rest took one
      // a row)
      for (int j = w; j < set.rows; j += K8_PT_UNROLL * K8_PT_WARPS) {
        uint64_t v[K8_PT_UNROLL];
#pragma unroll
        for (int u = 0; u < K8_PT_UNROLL; u++) {
          const int r = j + u * K8_PT_WARPS;
          v[u] = live && r < set.rows ? fri_ld(x + r * set.rs) : 0;
        }
#pragma unroll
        for (int u = 0; u < K8_PT_UNROLL; u++) {
          const int r = j + u * K8_PT_WARPS;
          if (r < set.rows) {
            gl_acc_mac(sa, v[u], ap[r]);
            gl_acc_mac(sb, v[u], ap[K8_MAX_POW + r]);
          }
        }
      }
      const FriExt sum = {gl_acc_value(sa), gl_acc_value(sb)};
      if (set.table == 0)
        acc0 = fri_eadd(acc0, sum);
      else
        acc1 = fri_eadd(acc1, sum);
    }
    uint64_t* mine = red + w * K8_PT_VALS * 32 + lane;
    mine[0] = acc0.a;
    mine[32] = acc0.b;
    mine[64] = acc1.a;
    mine[96] = acc1.b;
  });
  blk.sync();
  // thread (v, lane) adds value v = (table, component) of lane's point over the warps
  blk.each([&](int tid) {
    if (tid < K8_PT_VALS * 32) {
      const int v = tid >> 5, lane = tid & 31, t = v >> 1, k = v & 1;
      const long long i = base + lane;
      if (t < c.tables && i < n) {
        uint64_t s = 0;
        for (int w = 0; w < K8_PT_WARPS; w++)
          s = gl_add_lazy(s, red[(w * K8_PT_VALS + v) * 32 + lane]);
        c.out[((long long)(2 * t + k) * c.r.batch + b) * n + i] = gl_canon(s);
      }
    }
  });
}

GL_HD int k8_valid(const K8Call& c) {
  if (fri_rows_valid(c.r) || c.tables < 1 || c.tables > 2 || c.npow > K8_MAX_POW) return 1;
  for (int s = 0; s < c.r.nsets; s++)
    if (c.r.sets[s].table >= c.tables || c.r.sets[s].exp + c.r.sets[s].rows > c.npow) return 1;
  return 0;
}

// K8's scan: both divisions by a linear factor in Horner's form, which needs
// no inverse: q_t[i] = sum_{j > i} comp_t[j] z_t^(j - i - 1) satisfies
// q_t[n - 1] = 0 and q_t[i] = comp_t[i + 1] + z_t q_t[i + 1], the same
// field elements as E_t[i] z_t^-(i+1).  The points are cut into segments
// of S = 2^LOGS, a block a segment and proof, in two launches:
//   seg (k8_seg_block): segment g's sum A_t,g = sum_{l < S} comp_t[g S + l]
//     z_t^l, a tree whose level k multiplies by z_t^(2^k); block 0 of a
//     proof also writes the proof's table z_t^(2^k), k < K8_ZTAB;
//   finish (k8_finish_block): the later segments' part Y_t,g = q_t at the
//     segment's last point = sum_{h > g} (z_t^S)^(h - g - 1) A_t,h (each
//     thread Horner over every S-th later segment with z_t^(S^2), then a
//     tree by powers of z_t^S), then the inclusive suffix scan of d[l] =
//     comp_t[g S + l + 1] (l < S - 1), d[S - 1] = Y_t,g with the multiplier
//     z_t^(2^k) at step k (Hillis-Steele), which gives q_t at each point;
//     f = q_1 + s q_0, zero past n - 1 by the zeros it reads there.
// At z_t = 0 the two forms part: E_t z_t^-(i+1) with 1/0 = 0 (the plain
// version's) is 0, so q_t is set to 0 there.
// Every power comes from the proof's table: z_t^(2^k), k <= 2 LOGS.
#define K8_LOG_SEG 8          // the card's segments: 256 points, a block of 256 threads
#define K8_ZTAB (2 * K8_LOG_SEG + 1)

struct K8ScanCall {
  const uint64_t* comp[4]; // (batch, n) each: comp_0's components, then comp_1's
  const uint64_t* pts;     // (3, 2, batch): zeta, g zeta and alpha^nz, as K7Call's pts
  uint64_t* f[2];          // (batch, n)
  uint64_t* scratch;       // k8_scratch_words: the segments' sums, then the z tables
  long long n;
  int batch;
};

GL_HD long long k8_segs(long long n, int logs) { return (n + (1LL << logs) - 1) >> logs; }

// u64 of a call's scratch at segments of 2^logs points: (batch, segments,
// 4) sums, then (batch, 2, K8_ZTAB, 2) tables.
GL_HD long long k8_scratch_words(long long n, int batch, int logs) {
  return (long long)batch * (4 * k8_segs(n, logs) + 4 * K8_ZTAB);
}

GL_HD uint64_t* k8_ztab(const K8ScanCall& c, long long nseg, int b, int t) {
  return c.scratch + (long long)c.batch * nseg * 4 + ((long long)b * 2 + t) * K8_ZTAB * 2;
}

GL_HD FriExt k8_comp(const K8ScanCall& c, int t, long long o) {
  return fri_ld_ext(c.comp[2 * t], c.comp[2 * t + 1], o);
}

// Both tables' ext values of thread tid in shared memory: component k of
// table t at buf[(2 t + k) S + tid].
template <int LOGS>
GL_HD FriExt k8_get(const uint64_t* buf, int t, int tid) {
  return {buf[(2 * t) << LOGS | tid], buf[(2 * t + 1) << LOGS | tid]};
}

template <int LOGS>
GL_HD void k8_put(uint64_t* buf, int t, int tid, FriExt v) {
  buf[(2 * t) << LOGS | tid] = v.a;
  buf[(2 * t + 1) << LOGS | tid] = v.b;
}

// In place, x (4 S values, the first 2^levels of them live) <- their sum
// by Horner with base zk[t][0]: after level k the threads at multiples of
// 2^(k+1) hold their window's sum; zk: z_t^(2^k) at (t zstride + k) 2 (the
// level's multiplier).
template <int LOGS, class Blk>
GL_HD void k8_tree(Blk& blk, uint64_t* x, const uint64_t* zk, int zstride, int levels) {
  for (int k = 0; k < levels; k++) {
    const int d = 1 << k;
    blk.each([&](int tid) {
      if ((tid & (2 * d - 1)) == 0) {
        for (int t = 0; t < 2; t++) {
          const FriExt z = {zk[(t * zstride + k) * 2], zk[(t * zstride + k) * 2 + 1]};
          k8_put<LOGS>(x, t, tid, fri_eadd(k8_get<LOGS>(x, t, tid),
                                           fri_emul(z, k8_get<LOGS>(x, t, tid + d))));
        }
      }
    });
    blk.sync();
  }
}

// Segment g of proof b by 2^LOGS threads; sm: 4 2^LOGS + 4 LOGS u64.
template <int LOGS, class Blk>
GL_HD void k8_seg_block(Blk& blk, const K8ScanCall& c, int b, long long g, uint64_t* sm) {
  constexpr int S = 1 << LOGS;
  uint64_t* x = sm;
  uint64_t* zk = sm + 4 * S;               // z_t^(2^k), k < LOGS
  const long long nseg = k8_segs(c.n, LOGS);
  blk.each([&](int tid) {
    const long long i = g * S + tid;
    for (int t = 0; t < 2; t++)
      k8_put<LOGS>(x, t, tid, i < c.n ? k8_comp(c, t, b * c.n + i) : FriExt{0, 0});
    // threads 0 and 1 square z_t for the tree; in block 0 threads 2 and 3
    // square it on into the proof's table, beside the tree
    for (int q = tid; q < (g == 0 ? 4 : 2); q += S) {
      const int t = q & 1;
      FriExt z = fri_point(c.pts, c.batch, t, b);
      uint64_t* tab = k8_ztab(c, nseg, b, t);
      for (int k = 0; k < (q < 2 ? LOGS : K8_ZTAB); k++) {
        if (q < 2) {
          zk[(t * LOGS + k) * 2] = z.a;
          zk[(t * LOGS + k) * 2 + 1] = z.b;
        } else {
          tab[2 * k] = z.a;
          tab[2 * k + 1] = z.b;
        }
        z = fri_emul(z, z);
      }
    }
  });
  blk.sync();
  k8_tree<LOGS>(blk, x, zk, LOGS, LOGS);
  blk.each([&](int tid) {
    for (int v = tid; v < 4; v += S) c.scratch[(b * nseg + g) * 4 + v] = x[v << LOGS];
  });
}

// The rest of the scan for segment g of proof b by 2^LOGS threads; sm: 12
// 2^LOGS + 4 K8_ZTAB u64.
template <int LOGS, class Blk>
GL_HD void k8_finish_block(Blk& blk, const K8ScanCall& c, int b, long long g, uint64_t* sm) {
  constexpr int S = 1 << LOGS;
  uint64_t* buf[2] = {sm, sm + 4 * S};     // the scan's two buffers
  uint64_t* y = sm + 8 * S;
  uint64_t* zt = sm + 12 * S;              // the proof's tables: z_t^(2^k) at (t K8_ZTAB + k) 2
  const long long nseg = k8_segs(c.n, LOGS);
  const uint64_t* sums = c.scratch + (long long)b * nseg * 4;
  blk.each([&](int tid) {
    const uint64_t* tabs = k8_ztab(c, nseg, b, 0);   // both tables
    for (int e = tid; e < 4 * K8_ZTAB; e += S) zt[e] = fri_ld(tabs + e);
    const long long i = g * S + tid + 1;
    for (int t = 0; t < 2; t++) {
      k8_put<LOGS>(buf[0], t, tid, tid < S - 1 && i < c.n ? k8_comp(c, t, b * c.n + i)
                                                          : FriExt{0, 0});
      // the later segments g + 1 + tid + S m, Horner from the last with z_t^(S^2)
      const uint64_t* tab = k8_ztab(c, nseg, b, t);
      const FriExt zss = {fri_ld(tab + 4 * LOGS), fri_ld(tab + 4 * LOGS + 1)};
      FriExt acc = {0, 0};
      const long long first = g + 1 + tid;
      if (first < nseg)
        for (long long h = first + (nseg - 1 - first) / S * S; h >= first; h -= S)
          acc = fri_eadd(fri_emul(acc, zss), fri_ld_ext(sums + 4 * h + 2 * t,
                                                        sums + 4 * h + 2 * t + 1, 0));
      k8_put<LOGS>(y, t, tid, acc);
    }
  });
  blk.sync();
  // the later segments' sums sit at the first min(nseg - 1 - g, S) threads
  const long long later = nseg - 1 - g < S ? nseg - 1 - g : S;
  int levels = 0;
  while ((1LL << levels) < later) levels++;
  k8_tree<LOGS>(blk, y, zt + 2 * LOGS, K8_ZTAB, levels);   // multipliers z_t^(S 2^k)
  blk.each([&](int tid) {
    if (tid == S - 1)
      for (int t = 0; t < 2; t++) k8_put<LOGS>(buf[0], t, tid, k8_get<LOGS>(y, t, 0));
  });
  blk.sync();
  int src = 0;
  for (int k = 0; k < LOGS; k++) {
    const int d = 1 << k;
    blk.each([&](int tid) {
      for (int t = 0; t < 2; t++) {
        FriExt v = k8_get<LOGS>(buf[src], t, tid);
        if (tid + d < S) {
          const FriExt z = {zt[(t * K8_ZTAB + k) * 2], zt[(t * K8_ZTAB + k) * 2 + 1]};
          v = fri_eadd(v, fri_emul(z, k8_get<LOGS>(buf[src], t, tid + d)));
        }
        k8_put<LOGS>(buf[1 - src], t, tid, v);
      }
    });
    blk.sync();
    src ^= 1;
  }
  const FriExt s = fri_point(c.pts, c.batch, 2, b);
  blk.each([&](int tid) {
    const long long i = g * S + tid;
    if (i < c.n) {
      FriExt q[2];
      for (int t = 0; t < 2; t++) {   // z_t = 0: q_t = 0, as 1/0 = 0 gives in the E_t form
        const FriExt z = fri_point(c.pts, c.batch, t, b);
        q[t] = gl_canon(z.a) | gl_canon(z.b) ? k8_get<LOGS>(buf[src], t, tid) : FriExt{0, 0};
      }
      fri_st_ext(c.f[0], c.f[1], b * c.n + i, fri_eadd(q[1], fri_emul(s, q[0])));
    }
  });
}

GL_HD int k8_scan_valid(const K8ScanCall& c) {
  return c.n >= 1 && c.batch >= 1 && c.batch <= 65535 && c.scratch ? 0 : 1;
}

// --- K9: the fold, and a fold round ----------------------------------------
//
// A fold's lanes: L = 2^k9_lane_bits lanes an output coefficient (the
// arity, at most a warp), lane g of output m taking the inputs j = g + L q
// (q < A / L) of c[A m + j]: s_g = sum_q c[A m + g + L q] gamma^q by Horner
// (gamma = beta^L; one term, no product, up to arity 32), then
// new_c[m] = sum_g beta^g s_g, the lanes met by shuffles (group_sum:
// log2 L levels of adds).  The lanes' loads of c are contiguous.  In the
// round mode each thread issues its loads into its registers (blk.regs)
// first; the block's first warp then computes the table of beta^g in
// shared memory while they are in flight; a barrier; the products and the
// sums.  In the fold mode each lane computes its own beta^g.

#define K9_MAX_BATCH 32      // proofs a launch: their betas ride in its parameters
#define K9_FOLD_THREADS 128  // the fold mode's block
#define K9_ROUND_THREADS 256 // the round mode's block (512 at 2^13 points: k9_round_threads)
#define K9_UNROLL 4          // outputs a lane folds at once in the round mode
#define K9_ROUND_MAX_LOG 13  // the round mode's folded polynomial: 2^13 at most (its shared memory)
#define K9_MAX_GROUP_LOG 3   // a cluster's blocks: 8 cosets at most (portable)
#define K9_POW_WORDS 64      // the table of beta^g: 32 pairs
#define K9_RADIX_LOG 3       // the round NTT's radix: 8
#define K9_REGS 16           // u64 a thread keeps in registers across the phases

// Copies one u64 from global to shared memory without waiting for it (cp.async
// on the card); fri_copy_wait waits for this thread's copies.
GL_HD void fri_copy_async(uint64_t* dst, const uint64_t* src) {
#ifdef __CUDA_ARCH__
  __pipeline_memcpy_async(dst, src, sizeof(uint64_t));
#else
  *dst = *src;
#endif
}

GL_HD void fri_copy_wait() {
#ifdef __CUDA_ARCH__
  __pipeline_commit();
  __pipeline_wait_prior(0);
#endif
}

struct K9Call {            // the fold mode
  const uint64_t* c[2];    // (batch, m 2^arity_bits) components, rows c_bs apart
  long long c_bs;
  uint64_t* out[2];        // (batch, m) components
  long long m;
  int arity_bits, batch;
  uint64_t beta[K9_MAX_BATCH][2];   // proof b's beta
};

// The round mode: the fold, the next codeword's coset NTT (2^rate_bits
// cosets of 2^log_m points) and its fiber leaves.  Block (coset, y, b)
// holds component y of proof b's coset `coset`: v[coset + 2^r t] for
// t < 2^log_m is the 2^log_m-point NTT of x_i = f_i (shift w_S^coset)^i
// (w_S the 2^(log_m + r)-th root of unity), and v[k m' + j] goes to leaf j
// at 2 k + y (m' = 2^(log_m + r - next_bits) leaves of 2^(next_bits + 1)).
// A group of 2^group_log cosets (a thread-block cluster on the card) folds
// once: each of its blocks folds 2^(log_m - group_log) of the f_m and reads
// the others' from their shared memory.
struct K9RoundCall {
  const uint64_t* c[2];    // (batch, 2^(log_m + arity_bits)) components, rows c_bs apart
  long long c_bs;
  uint64_t* f[2];          // (batch, 2^log_m): the folded coefficients
  uint64_t* leaves;        // (batch, m', 2^(next_bits + 1))
  const uint64_t* tw;      // the NTT's tables of 2^log_m points (k9_ntt_table_elems)
  const uint64_t* pre;     // (2^rate_bits, 2^log_m): (shift w_S^coset)^i
  int arity_bits, log_m, next_bits, rate_bits, group_log, batch;
  uint64_t beta[K9_MAX_BATCH][2];
};

GL_HD int k9_lane_bits(int arity_bits) { return arity_bits < 5 ? arity_bits : 5; }

// The round mode's threads at 2^l points a coset: K9_ROUND_THREADS, or
// as many as keep a thread's NTT values within K9_REGS.
GL_HD constexpr int k9_round_threads(int l) {
  return (K9_ROUND_THREADS * K9_REGS) >> l ? K9_ROUND_THREADS : (1 << l) / K9_REGS;
}

// The schedule of the round mode's NTT at 2^L points (k9_ntt).
template <int L>
struct K9Ntt {
  static constexpr int rounds = L <= K9_RADIX_LOG ? 1 : (L + K9_RADIX_LOG - 1) / K9_RADIX_LOG;
  static constexpr int radix_log(int r) {
    return r < rounds - 1 ? K9_RADIX_LOG : L - K9_RADIX_LOG * (rounds - 1);
  }
  static constexpr int done_log(int r) { return K9_RADIX_LOG * r; }
  // round r's table, w_(L_r)^(j k) at k M_r + j: after the earlier rounds' L_q
  static constexpr long long table(int r) {
    long long t = 0;
    for (int q = 0; q < r; q++) t += 1LL << (L - done_log(q));
    return t;
  }
};

// u64 of the NTT's tables at 2^l points: each round's but the last.
GL_HD long long k9_ntt_table_elems(int l) {
  const int rounds = l <= K9_RADIX_LOG ? 1 : (l + K9_RADIX_LOG - 1) / K9_RADIX_LOG;
  long long t = 0;
  for (int q = 0; q < rounds - 1; q++) t += 1LL << (l - K9_RADIX_LOG * q);
  return t;
}

// s_g of output m of the row at c0 + row, c1 + row (lane g), gamma =
// beta^L (read only above arity 32).
GL_HD FriExt k9_lane_sum(const uint64_t* c0, const uint64_t* c1, long long row, long long m,
                         int arity_bits, int g, FriExt gamma) {
  const int lb = k9_lane_bits(arity_bits);
  const long long base = row + (m << arity_bits) + g, steps = 1LL << (arity_bits - lb);
  FriExt s = fri_ld_ext(c0, c1, base + ((steps - 1) << lb));
  for (long long q = steps - 2; q >= 0; q--)
    s = fri_eadd(fri_emul(s, gamma), fri_ld_ext(c0, c1, base + (q << lb)));
  return s;
}

// gamma = beta^L where a lane takes more than one input, else unused.
GL_HD FriExt k9_gamma(FriExt beta, int arity_bits) {
  return arity_bits > 5 ? fri_pow(beta, 32) : FriExt{1, 0};
}

// The table of beta^g for each lane g < L (pw, K9_POW_WORDS u64), by the
// first threads: at pw[2 g] the pair (u0, u1) with component y of beta^g s
// = u0 s.a + u1 s.b: (beta^g.a, 7 beta^g.b) for y = 0, (beta^g.b, beta^g.a)
// for y = 1.  The caller's barrier follows.
template <class Blk>
GL_HD void k9_pow_table(Blk& blk, FriExt beta, int arity_bits, int y, uint64_t* pw) {
  blk.each([&](int tid) {
    for (int g = tid; g < (1 << k9_lane_bits(arity_bits)); g += blk.threads()) {
      const FriExt p = fri_pow(beta, (unsigned long long)g);
      pw[2 * g] = y ? p.b : p.a;
      pw[2 * g + 1] = y ? p.a : gl_mul7(p.b);
    }
  });
}

// The fold mode: block x of proof b folds outputs x P .. x P + P - 1
// (P = threads / L).  With a few warps a block, each lane computes its
// beta^g itself while its loads are in flight: no table, no barrier.
template <class Blk>
GL_HD void k9_fold_block(Blk& blk, const K9Call& c, int b, long long x) {
  const int lb = k9_lane_bits(c.arity_bits);
  const long long first = x * (blk.threads() >> lb);
  const FriExt beta = {c.beta[b][0], c.beta[b][1]};
  blk.template group_sum<2>(lb, [&](int tid, uint64_t* v) {
    const long long m = first + (tid >> lb);
    const int g = tid & ((1 << lb) - 1);
    FriExt t = {0, 0};
    if (m < c.m)
      t = fri_emul(k9_lane_sum(c.c[0], c.c[1], b * c.c_bs, m, c.arity_bits, g,
                               k9_gamma(beta, c.arity_bits)),
                   fri_pow(beta, (unsigned long long)g));
    v[0] = t.a;
    v[1] = t.b;
  }, [&](int tid, const uint64_t* v) {
    const long long m = first + (tid >> lb);
    if (m < c.m) fri_st_ext(c.out[0], c.out[1], b * c.m + m, FriExt{v[0], v[1]});
  });
}

GL_HD long long k9_fold_blocks(const K9Call& c, int threads) {
  const long long per = threads >> k9_lane_bits(c.arity_bits);
  return (c.m + per - 1) / per;
}

GL_HD int k9_valid(const K9Call& c) {
  return c.arity_bits >= 1 && c.arity_bits <= K9_MAX_BITS && c.m >= 1 && c.batch >= 1 &&
                 c.batch <= K9_MAX_BATCH
             ? 0
             : 1;
}

// The round mode's shared memory, in u64: the block's share of f, the
// NTT's column (K4's row pitch; the coset's powers, then x_i, first sit at
// i there), the NTT's tables, the table of beta^g.
GL_HD long long k9_round_share(const K9RoundCall& c) { return 1LL << (c.log_m - c.group_log); }
GL_HD long long k9_round_col(const K9RoundCall& c) { return k9_round_share(c); }
GL_HD long long k9_round_tw(const K9RoundCall& c) {
  return k9_round_col(c) + k4_pitch(c.log_m, K4_PASS_ROW);
}
GL_HD long long k9_round_pw(const K9RoundCall& c) {
  return k9_round_tw(c) + k9_ntt_table_elems(c.log_m);
}
GL_HD long long k9_round_smem(const K9RoundCall& c) { return k9_round_pw(c) + K9_POW_WORDS; }

// Phase 0 of block `coset`: the coset's powers pre[coset][i] into the
// column and the NTT's tables behind it, copies that run on while the
// block folds (each thread waits for its own before phase 2's barrier).
template <class Blk>
GL_HD void k9_round_prefetch(Blk& blk, const K9RoundCall& c, int coset, uint64_t* sm) {
  const uint64_t* pre = c.pre + ((long long)coset << c.log_m);
  uint64_t* col = sm + k9_round_col(c);
  uint64_t* tw = sm + k9_round_tw(c);
  const long long n = 1LL << c.log_m, ntw = k9_ntt_table_elems(c.log_m);
  blk.each([&](int tid) {
    for (long long i = tid; i < n; i += blk.threads()) fri_copy_async(col + i, pre + i);
    for (long long i = tid; i < ntw; i += blk.threads()) fri_copy_async(tw + i, c.tw + i);
  });
}

// Phase 1 of block (coset, y, b): component y of f_m (any u64) for the
// block's share of m, rank Mg .. rank Mg + Mg - 1 (rank = coset mod the
// group, Mg = k9_round_share), to share[m - rank Mg] at sm; the first
// group's blocks also store it, canonical, to f.  sm: k9_round_smem u64.
template <class Blk>
GL_HD void k9_round_fold(Blk& blk, const K9RoundCall& c, int b, int y, int coset, uint64_t* sm) {
  const int lb = k9_lane_bits(c.arity_bits);
  const long long mg = k9_round_share(c), per = blk.threads() >> lb;
  const long long first = (long long)(coset & ((1 << c.group_log) - 1)) * mg;
  const FriExt beta = {c.beta[b][0], c.beta[b][1]};
  uint64_t* pw = sm + k9_round_pw(c);
  for (long long base = 0; base < mg; base += per * K9_UNROLL) {
    blk.each([&](int tid) {   // every load before a product
      const FriExt gamma = k9_gamma(beta, c.arity_bits);
#pragma unroll
      for (int u = 0; u < K9_UNROLL; u++) {
        const long long ml = base + (tid >> lb) + u * per;
        const FriExt s = ml < mg ? k9_lane_sum(c.c[0], c.c[1], b * c.c_bs, first + ml,
                                               c.arity_bits, tid & ((1 << lb) - 1), gamma)
                                 : FriExt{0, 0};
        blk.regs(tid)[2 * u] = s.a;
        blk.regs(tid)[2 * u + 1] = s.b;
      }
    });
    if (base == 0) k9_pow_table(blk, beta, c.arity_bits, y, pw);
    blk.sync();
    blk.template group_sum<K9_UNROLL>(lb, [&](int tid, uint64_t* v) {
      const int g = tid & ((1 << lb) - 1);
      const uint64_t u0 = pw[2 * g], u1 = pw[2 * g + 1];
#pragma unroll
      for (int u = 0; u < K9_UNROLL; u++)
        v[u] = gl_add_lazy(gl_mul_m(u0, blk.regs(tid)[2 * u]),
                           gl_mul_m(u1, blk.regs(tid)[2 * u + 1]));
    }, [&](int tid, const uint64_t* v) {
#pragma unroll
      for (int u = 0; u < K9_UNROLL; u++) {
        const long long ml = base + (tid >> lb) + u * per;
        if (ml >= mg) continue;
        sm[ml] = v[u];
        if (coset >> c.group_log == 0) c.f[y][((long long)b << c.log_m) + first + ml] = gl_canon(v[u]);
      }
    });
  }
}

// Phase 2, after the prefetch's copies and a barrier over the group: x_i
// = f_i pre[coset][i] in the column, f_i from the share of rank i / Mg
// (shares[rank]: that block's share, in its shared memory on the card).
template <class Blk>
GL_HD void k9_round_gather(Blk& blk, const K9RoundCall& c, const uint64_t* const* shares,
                           uint64_t* sm) {
  const int ls = c.log_m - c.group_log;
  uint64_t* col = sm + k9_round_col(c);
  blk.each([&](int tid) {
    for (long long i = tid; i < (1LL << c.log_m); i += blk.threads())
      col[i] = gl_mul_m(shares[i >> ls][i & ((1LL << ls) - 1)], col[i]);
  });
  blk.sync();
}

// The round's NTT over the column, 2^L points in rounds of radix
// 2^K9_RADIX_LOG (the last round takes what is left), K4's Stockham
// formulation (ntt.cuh): round r takes Y_r[d][j + M_r m] (Y_0 = x), a
// task (d, j < M_r) its 2^b values, their DFT in registers (K4's k4_dft,
// whose twiddles are powers of w_16, shifts), and hands on
// Y_(r+1)[d + S_r k][j] = A[k] w_(L_r)^(j k) (tables from the wrapper,
// k9_ntt_table_elems); the last round's A[k] is X[d + S k].  Radix 16
// leaves a 2^9-point coset 32 tasks a round, one warp of a block; radix 4,
// 128 a round in more rounds (scripts/k9_variants.py times both).
// Phase 3, round R of the NTT of block (coset, y, b) and the rounds after
// it: each thread's tasks tid, tid + T, ... in its registers (blk.regs), a
// barrier before and after each exchange through the column; round 0
// reads x_i at i, the last round stores X[t] = v[coset + 2^r t],
// canonical, to leaf coset + 2^r (t mod M / A') at 2 (t div M / A') + y
// of proof b.
template <int L, int R, class Blk>
GL_HD void k9_ntt(Blk& blk, const K9RoundCall& c, uint64_t* sm, int b, int y, int coset) {
  using N = K9Ntt<L>;
  constexpr int B = N::radix_log(R), ld = N::done_log(R), lm = L - ld - B;
  constexpr bool last = R == N::rounds - 1;
  constexpr int tasks = 1 << (L - B), per = K9_REGS >> B;
  uint64_t* col = sm + k9_round_col(c);
  const uint64_t* tab = sm + k9_round_tw(c) + N::table(R);
  blk.each([&](int tid) {
    uint64_t* v = blk.regs(tid);
    const int lq = c.log_m - c.next_bits, lw = c.next_bits + 1;
    uint64_t* out = c.leaves + ((long long)b << (c.log_m + c.rate_bits + 1)) + y;
#pragma unroll
    for (int u = 0; u < per; u++) {
      const int tau = tid + blk.threads() * u;
      if (tau >= tasks) continue;
      const int j = tau & ((1 << lm) - 1), d = tau >> lm;
      uint64_t* a = v + (u << B);
#pragma unroll
      for (int m = 0; m < (1 << B); m++)
        a[m] = R == 0 ? col[j + (m << lm)] : col[k4_pad((d << (L - ld)) + j + (m << lm))];
      k4_dft<B, B>(a);
#pragma unroll
      for (int k = 0; k < (1 << B); k++) {
        if (last) {
          const long long t = d + ((long long)k << ld);
          const long long row = coset + ((t & ((1LL << lq) - 1)) << c.rate_bits);
          out[(row << lw) + 2 * (t >> lq)] = gl_canon(a[k]);
        } else if (k) {
          a[k] = gl_mul_m(a[k], tab[(k << lm) + j]);
        }
      }
    }
  });
  if constexpr (!last) {
    blk.sync();   // every read of the column done
    blk.each([&](int tid) {
      const uint64_t* v = blk.regs(tid);
#pragma unroll
      for (int u = 0; u < per; u++) {
        const int tau = tid + blk.threads() * u;
        if (tau >= tasks) continue;
        const int j = tau & ((1 << lm) - 1), d = tau >> lm;
#pragma unroll
        for (int k = 0; k < (1 << B); k++) col[k4_pad(((d + (k << ld)) << lm) + j)] = v[(u << B) + k];
      }
    });
    blk.sync();
    k9_ntt<L, R + 1>(blk, c, sm, b, y, coset);
  }
}

GL_HD int k9_round_valid(const K9RoundCall& c) {
  return c.arity_bits >= 1 && c.arity_bits <= K9_MAX_BITS && c.log_m >= 1 &&
                 c.log_m <= K9_ROUND_MAX_LOG && c.next_bits >= 1 && c.next_bits <= c.log_m &&
                 c.rate_bits >= 0 && c.rate_bits <= 16 && c.group_log >= 0 &&
                 c.group_log <= K9_MAX_GROUP_LOG && c.group_log <= c.rate_bits &&
                 c.group_log <= c.log_m && c.batch >= 1 && c.batch <= K9_MAX_BATCH &&
                 c.log_m + c.arity_bits <= 62
             ? 0
             : 1;
}
