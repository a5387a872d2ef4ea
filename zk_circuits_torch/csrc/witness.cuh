// The witness schedule's per-element arithmetic (K3), shared by the CUDA
// kernels of witness.cu and by a host build for testing.
//
// Every value of the representative table is canonical (the host witness
// matrix is), so every result stored here goes through gl_canon; the
// Poseidon rounds chain non-canonical lanes (poseidon.cuh) and only the
// recorded trace columns and the outputs are made canonical.
#pragma once

#include "poseidon.cuh"

// Generator kinds of one schedule batch (iop/witness_device.py, KINDS).
#define K3_CONST 0
#define K3_ARITH 1
#define K3_ARITH_EXT 2
#define K3_EQ_INV 3
#define K3_EXT_INV 4
#define K3_BASE_SUM 5
#define K3_RANDOM_ACCESS 6

// PoseidonGate's wire layout (iop/gates.py): 12 inputs, 12 outputs, swap,
// then the trace: 4 deltas, full rounds 1-3 (36), the 22 partial rounds'
// lane 0, the last 4 full rounds (48).
#define K3_START_DELTA 25
#define K3_TRACE_COLS 110

// Canonical results for canonical operands.
GL_HD uint64_t k3_mul(uint64_t a, uint64_t b) { return gl_canon(gl_mul(a, b)); }
GL_HD uint64_t k3_sub(uint64_t a, uint64_t b) { return a >= b ? a - b : a - b + GL_P; }
GL_HD uint64_t k3_neg(uint64_t a) { return a == 0 ? 0 : GL_P - a; }

// a^(p-2) by square-and-multiply over the exponent's 64 bits: inverse(0)
// is 0, as the host's gl.inverse.
GL_HD uint64_t k3_inverse(uint64_t a) {
  const uint64_t e = GL_P - 2;
  uint64_t r = 1;
  for (int i = 63; i >= 0; i--) {
    r = gl_mul(r, r);
    if ((e >> i) & 1) r = gl_mul(r, a);
  }
  return gl_canon(r);
}

// (a0 + a1 X)(b0 + b1 X) with X^2 = 7.
GL_HD void k3_ext_mul(uint64_t a0, uint64_t a1, uint64_t b0, uint64_t b1, uint64_t* c0,
                      uint64_t* c1) {
  *c0 = gl_add(k3_mul(a0, b0), k3_mul(7, k3_mul(a1, b1)));
  *c1 = gl_add(k3_mul(a0, b1), k3_mul(a1, b0));
}

// Op i of a batch of m ops of `kind` (k3_ops' thread i): its input reps at
// in[i * k_in ..], its output reps at out[i * k_out ..], read from and
// written to the value table v.  consts: arith and arith_ext's c0 at
// consts[i], c1 at consts[m + i]; the const batch's values at
// consts[i * k_out ..].  nbits: base_sum and random_access's bit count.
GL_HD void k3_op(int kind, long long m, long long i, const int64_t* in, int k_in,
                 const int64_t* out, int k_out, const uint64_t* consts, int nbits,
                 uint64_t* v) {
  in += i * k_in;
  out += i * k_out;
  switch (kind) {
    case K3_CONST:
      for (int j = 0; j < k_out; j++) v[out[j]] = consts[i * k_out + j];
      break;
    case K3_ARITH: {
      uint64_t prod = k3_mul(v[in[0]], v[in[1]]);
      v[out[0]] = gl_add(k3_mul(consts[i], prod), k3_mul(consts[m + i], v[in[2]]));
      break;
    }
    case K3_ARITH_EXT: {
      uint64_t p0, p1;
      k3_ext_mul(v[in[0]], v[in[1]], v[in[2]], v[in[3]], &p0, &p1);
      uint64_t c0 = consts[i], c1 = consts[m + i];
      v[out[0]] = gl_add(k3_mul(p0, c0), k3_mul(v[in[4]], c1));
      v[out[1]] = gl_add(k3_mul(p1, c0), k3_mul(v[in[5]], c1));
      break;
    }
    case K3_EQ_INV:
      v[out[0]] = k3_inverse(v[in[0]]);
      break;
    case K3_EXT_INV: {  // (a0 - a1 X) / (a0^2 - 7 a1^2)
      uint64_t a0 = v[in[0]], a1 = v[in[1]];
      uint64_t ninv = k3_inverse(k3_sub(k3_mul(a0, a0), k3_mul(7, k3_mul(a1, a1))));
      v[out[0]] = k3_mul(a0, ninv);
      v[out[1]] = k3_mul(k3_neg(a1), ninv);
      break;
    }
    case K3_BASE_SUM: {
      uint64_t x = v[in[0]];
      for (int j = 0; j < nbits; j++) v[out[j]] = (x >> j) & 1;
      break;
    }
    case K3_RANDOM_ACCESS: {  // the host refuses an index past the list
      uint64_t idx = v[in[0]];
      v[out[0]] = idx < (uint64_t)(k_in - 1) ? v[in[1 + idx]] : 0;
      for (int j = 0; j < nbits; j++) v[out[1 + j]] = (idx >> j) & 1;
      break;
    }
  }
}

// One PoseidonGate: x = its 12 inputs and the swap flag (canonical).
// Writes the 12 canonical outputs to y and trace column c (of the 110
// after K3_START_DELTA) to trace[c * stride]: the swap deltas, then the
// state after the round constants of full rounds 1-3 (round 0's input is
// the swapped input), of the partial rounds (lane 0) and of the last four
// full rounds, each before its S-box (iop/witness.py::_poseidon_trace).
// rc: the 360 round constants, round-major.
GL_HD void k3_poseidon_trace(const uint64_t x[13], const uint64_t* rc, uint64_t y[12],
                             uint64_t* trace, long long stride) {
  uint64_t s[POSEIDON_WIDTH];
  int c = 0;
  for (int i = 0; i < 4; i++) {
    uint64_t d = k3_mul(x[12], k3_sub(x[4 + i], x[i]));
    s[i] = gl_add(x[i], d);
    s[4 + i] = k3_sub(x[4 + i], d);
    trace[(c++) * stride] = d;
  }
  for (int i = 8; i < POSEIDON_WIDTH; i++) s[i] = x[i];
  for (int r = 0; r < POSEIDON_ROUNDS; r++) {
    for (int k = 0; k < POSEIDON_WIDTH; k++)
      s[k] = gl_add_canon_rhs(s[k], rc[r * POSEIDON_WIDTH + k]);
    if (poseidon_full_round(r)) {
      for (int k = 0; k < POSEIDON_WIDTH && r > 0; k++) trace[(c++) * stride] = gl_canon(s[k]);
      for (int k = 0; k < POSEIDON_WIDTH; k++) s[k] = poseidon_sbox(s[k]);
    } else {
      trace[(c++) * stride] = gl_canon(s[0]);
      s[0] = poseidon_sbox(s[0]);
    }
    poseidon_mds_freq(s);
  }
  for (int k = 0; k < POSEIDON_WIDTH; k++) y[k] = gl_canon(s[k]);
}

// Gate i of a Poseidon batch (k3_poseidon's thread i): inputs and swap at
// the reps in[i * 13 ..], outputs to the reps out[i * 12 ..], the trace
// into row rows[i] of the wire matrix w (W, n), column-major.
GL_HD void k3_poseidon_gate(long long i, const int64_t* in, const int64_t* out,
                            const int64_t* rows, uint64_t* v, uint64_t* w, long long n,
                            const uint64_t* rc) {
  uint64_t x[13], y[POSEIDON_WIDTH];
  for (int k = 0; k < 13; k++) x[k] = v[in[i * 13 + k]];
  k3_poseidon_trace(x, rc, y, w + K3_START_DELTA * n + rows[i], n);
  for (int k = 0; k < POSEIDON_WIDTH; k++) v[out[i * POSEIDON_WIDTH + k]] = y[k];
}

// k3_cells' thread t: cell t of the wire matrix w from its rep, or, past
// the ncells cells, public input t - ncells.
GL_HD void k3_cell(long long t, long long ncells, const int64_t* cell_pos,
                   const int64_t* cell_rep, long long npis, const int64_t* pi_rep,
                   const uint64_t* v, uint64_t* w, uint64_t* pis) {
  if (t < ncells)
    w[cell_pos[t]] = v[cell_rep[t]];
  else if (t < ncells + npis)
    pis[t - ncells] = v[pi_rep[t - ncells]];
}
