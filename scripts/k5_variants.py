"""Device times of K5 (zk_circuits_torch/csrc/quotient.cu) against variants
of its own design on one GPU; one JSON line a variant.

    python scripts/k5_variants.py

Each variant is the source with one design choice changed, built with
nvcc beside the port's build (``zk_circuits_torch/_build/k5_variants``):
one launch in place of two (a thread runs its point's permutation terms
and then its gates); the permutation kernel's register cap at 64 or 128
in place of 85, the gate kernel's at 85 or none in place of 128; the
gates' constraints folded by Horner's rule (a reduced product and an add
each, then alpha^(M-K)) in place of the unreduced multiply-adds; the
Poseidon gate's partial rounds in Plonky2's fast form (FAST_PARTIAL) in
place of the naive form; the S-box x^7 as (x^2)^2 (x^2 x), three
products deep in place of four; and, as measures of where the time goes (their
values differ from the source's), the Poseidon gate without its MDS
layers or its S-boxes, the constraints folded into nothing (a word of the
sum flipped), and the permutation argument's chunks left out.  Each is
timed (graph_ms, as chip_smoke times K5) at the wormhole's shape, one
proof of 2^16 coset points, on the wormhole's gate table and on the
Poseidon gate's alone (chip_smoke.k5_gate_tables); a design variant's
values must equal the unchanged build's.  The times of variants are
comparable within one run only.
"""

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zk_circuits_torch.hash import poseidon_cuda  # noqa: E402
from zk_circuits_torch.iop import gates as G  # noqa: E402
from zk_circuits_torch.plonk import config, quotient_cuda  # noqa: E402
from zk_circuits_torch.utils import nvcc  # noqa: E402

SOURCES = ("goldilocks.cuh", "perm_chunk.cuh", "poseidon.cuh", "quotient.cuh", "quotient.cu")
NEW_FOLD = """  K5_MEMBER void put(uint64_t t) {
#pragma unroll
    for (int ch = 0; ch < NC; ch++) gl_acc_mac(g[ch], t, apow[ch * K5_MAX_POW + e]);
    e--;
  }"""
HORNER_FOLD = """  uint64_t h[NC], al[NC];

  K5_MEMBER void put(uint64_t t) {
#pragma unroll
    for (int ch = 0; ch < NC; ch++) h[ch] = gl_add_lazy(gl_mul_m(h[ch], al[ch]), t);
    e--;
  }"""
NEW_INIT = """    for (int ch = 0; ch < NC; ch++) f.g[ch] = gl_acc_zero();"""
HORNER_INIT = """    for (int ch = 0; ch < NC; ch++) {
      f.h[ch] = 0;
      f.al[ch] = gl_ld(c.alphas + ch * c.batch + b);
    }"""
NEW_SCALE = "gl_acc_value(f.g[ch])"
HORNER_SCALE = "gl_mul_m(f.h[ch], apow[ch * K5_MAX_POW + k5_field(g + K5_G_SHIFT)])"
NAIVE_PARTIAL = """#pragma unroll 1
  for (int r = H; r < H + R; r++) {
#pragma unroll
    for (int k = 0; k < W; k++) s[k] = gl_add_canon_rhs(s[k], rc[r * W + k]);
    const uint64_t wv = p.wire(65 + r - H);
    f.put(gl_sub_lazy(s[0], wv));
    s[0] = poseidon_sbox(wv);
    poseidon_mds_freq(s);
  }
"""
# The partial rounds in Plonky2's fast form (compat/poseidon_fast.py): the
# first round's constants on every lane and one dense 11x11 layer, then a
# round constant on lane 0 and a sparse layer a round, lane 0 a sum of 12
# products kept unreduced (gl_acc_mac); the tables follow the round
# constants in the block's shared copy (k5_fast.h, written by fast_header).
FAST_PARTIAL = """  {
    const uint64_t* m = rc + K5F_INIT;
    uint64_t t[W];
#pragma unroll
    for (int k = 0; k < W; k++) s[k] = gl_add_canon_rhs(s[k], rc[K5F_FIRST + k]);
#pragma unroll
    for (int c = 1; c < W; c++) {
      GlAcc a = gl_acc_zero();
#pragma unroll
      for (int r = 1; r < W; r++) gl_acc_mac(a, s[r], m[(r - 1) * (W - 1) + c - 1]);
      t[c] = gl_acc_value(a);
    }
#pragma unroll
    for (int c = 1; c < W; c++) s[c] = t[c];
  }
#pragma unroll 1
  for (int r = 0; r < R; r++) {
    const uint64_t wv = p.wire(65 + r);
    f.put(gl_sub_lazy(s[0], wv));
    const uint64_t s0 = gl_add_canon_rhs(poseidon_sbox(wv), rc[K5F_PRC + r]);
    const uint64_t* wh = rc + K5F_WHAT + r * (W - 1);
    const uint64_t* v = rc + K5F_VS + r * (W - 1);
    GlAcc d = gl_acc_zero();
    gl_acc_mac(d, s0, K5F_MDS00);
#pragma unroll
    for (int k = 1; k < W; k++) {
      gl_acc_mac(d, s[k], wh[k - 1]);
      s[k] = gl_add_lazy(s[k], gl_mul_m(s0, v[k - 1]));
    }
    s[0] = gl_acc_value(d);
  }
"""
RC_TABLE = "POSEIDON_WIDTH * POSEIDON_ROUNDS"
# x^7 as (x^2)^2 x^2 x: the same four products, three deep in place of four
SBOX3 = """GL_HD uint64_t k5_sbox3(uint64_t x) {
  const uint64_t x2 = gl_mul(x, x);
  return gl_mul(gl_mul(x2, x2), gl_mul(x2, x));
}

// The width-12 Poseidon permutation in one row,"""
PERM_LB = "__launch_bounds__(K5_THREADS, 3) k5_perm_kernel"
GATE_LB = "__launch_bounds__(K5_THREADS, 2) k5_gate_kernel"
T256 = "constexpr int K5_THREADS = 256;"
LAUNCHES = """  k5_perm_kernel<NC><<<grid, K5_THREADS, 0, stream>>>(c);
  k5_gate_kernel<NC><<<grid, K5_THREADS, 0, stream>>>(c);"""
# both halves in one launch, a thread running its point's permutation terms
# and then its gates (the value passing through c.out, which it wrote)
FUSED = """template <int NC>
__global__ void __launch_bounds__(K5_THREADS, 2) k5_fused_kernel(const K5Call c) {
  __shared__ uint64_t am[NC];
  __shared__ uint64_t bk[NC * PERM_MAX_ROUTED];
  __shared__ uint64_t apow[NC * K5_MAX_POW];
  __shared__ uint64_t rc[POSEIDON_WIDTH * POSEIDON_ROUNDS];
  for (int k = threadIdx.x; k < POSEIDON_WIDTH * POSEIDON_ROUNDS; k += K5_THREADS)
    rc[k] = K5_RC[k];
  k5_perm_tables<NC>(c, blockIdx.y, am, bk, threadIdx.x, K5_THREADS);
  k5_alpha_table<NC>(c, blockIdx.y, apow, threadIdx.x, K5_THREADS);
  __syncthreads();
  const long long i = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
  if (i < c.points) {
    k5_perm_point<NC>(c, blockIdx.y, i, am, bk);
    k5_gate_point<NC>(c, blockIdx.y, i, apow, rc);
  }
}

template <int NC>
static cudaError_t k5_launch("""


def fast_header(directory: Path) -> None:
    """k5_fast.h: the round constants and the fast partial rounds' tables
    in one initializer (K5F_INIT_ALL) and their offsets."""
    from zk_circuits_torch.compat import poseidon_fast as pf
    from zk_circuits_torch.hash.constants import ALL_ROUND_CONSTANTS

    parts = [("RC", ALL_ROUND_CONSTANTS), ("FIRST", pf.FAST_PARTIAL_FIRST_ROUND_CONSTANT),
             ("PRC", pf.FAST_PARTIAL_ROUND_CONSTANTS),
             ("INIT", pf.FAST_PARTIAL_ROUND_INITIAL_MATRIX),
             ("WHAT", pf.FAST_PARTIAL_ROUND_W_HATS), ("VS", pf.FAST_PARTIAL_ROUND_VS)]
    lines, words, at = ["#pragma once"], [], 0
    for name, table in parts:
        flat = [int(v) for v in np.asarray(table, dtype=np.uint64).reshape(-1)]
        lines.append(f"#define K5F_{name} {at}")
        words += flat
        at += len(flat)
    lines += [f"#define K5F_WORDS {at}", f"#define K5F_MDS00 {int(pf.MDS0TO0)}ULL",
              "#define K5F_INIT_ALL {" + ", ".join(f"{w}ULL" for w in words) + "}"]
    (directory / "k5_fast.h").write_text("\n".join(lines) + "\n")


# (file, text, replacement) of each variant, applied in turn; "base" is the
# source as it is (two launches of 256 threads: the permutation argument at
# most 85 registers, the gates at most 128)
VARIANTS = {
    "base": [],
    "one_launch": [("quotient.cu", "template <int NC>\nstatic cudaError_t k5_launch(", FUSED),
                   ("quotient.cu", LAUNCHES,
                    "  k5_fused_kernel<NC><<<grid, K5_THREADS, 0, stream>>>(c);")],
    "perm_regs64": [("quotient.cu", PERM_LB, "__launch_bounds__(K5_THREADS, 4) k5_perm_kernel")],
    "perm_regs128": [("quotient.cu", PERM_LB, "__launch_bounds__(K5_THREADS, 2) k5_perm_kernel")],
    "gate_uncapped": [("quotient.cu", GATE_LB, "__launch_bounds__(K5_THREADS) k5_gate_kernel")],
    "gate_regs85": [("quotient.cu", GATE_LB, "__launch_bounds__(K5_THREADS, 3) k5_gate_kernel")],
    "horner_fold": [("quotient.cuh", NEW_FOLD, HORNER_FOLD), ("quotient.cuh", NEW_INIT, HORNER_INIT),
                    ("quotient.cuh", NEW_SCALE, HORNER_SCALE)],
    "fast_partial": [("quotient.cuh", NAIVE_PARTIAL, FAST_PARTIAL),
                     ("quotient.cuh", '#include "poseidon.cuh"\n',
                      '#include "poseidon.cuh"\n#include "k5_fast.h"\n'),
                     ("quotient.cu", "K5_RC[" + RC_TABLE + "] = POSEIDON_RC_INIT",
                      "K5_RC[K5F_WORDS] = K5F_INIT_ALL"),
                     ("quotient.cu", "rc[" + RC_TABLE + "];", "rc[K5F_WORDS];"),
                     ("quotient.cu", "k < " + RC_TABLE + ";", "k < K5F_WORDS;")],
    "sbox_depth3": [("quotient.cuh", "poseidon_sbox(", "k5_sbox3("),
                    ("quotient.cuh", "// The width-12 Poseidon permutation in one row,", SBOX3)],
    "mds_removed": [("quotient.cuh", "    poseidon_mds_freq(s);\n", "")],
    "fold_removed": [("quotient.cuh", "gl_acc_mac(g[ch], t, apow[ch * K5_MAX_POW + e]);",
                      "g[ch].w[0] ^= (uint32_t)t;")],
    "perm_removed": [("quotient.cuh", "for (long long t = 0; t < chunks; t++) {",
                      "for (long long t = 0; t < 0; t++) {")],
    "sbox_removed": [("quotient.cuh", "poseidon_sbox(", "(")],
}
MEASURES = {name for name in VARIANTS if name.endswith("_removed")}


def build(name: str) -> tuple:
    """Patch and build one variant; returns (name, bound library, nvcc's
    output)."""
    out = nvcc.BUILD_DIR / "k5_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
        (out / src).write_text((nvcc.CSRC / src).read_text())
    for src, old, new in VARIANTS[name]:
        text = (out / src).read_text()
        old = old(text) if callable(old) else old
        if old not in text:
            raise RuntimeError(f"variant {name}: {src} no longer holds the text it changes")
        (out / src).write_text(text.replace(old, new))
    poseidon_cuda.write_constants_header(out)
    fast_header(out)
    lib = out / "libk5.so"
    res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
                          str(out / "quotient.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, quotient_cuda.bind(ctypes.CDLL(str(lib))), res.stdout + res.stderr


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, together
        libs = list(pool.map(build, VARIANTS))
    cfg = config.CircuitConfig.standard_recursion_zk_config()
    worm = chip_smoke.k5_gate_common(
        [G.PoseidonGate(), G.ArithmeticGate(num_ops=20), G.BaseSum2Gate(num_limbs=32),
         G.BaseSum2Gate(num_limbs=5), G.ConstantGate(num_consts=2), G.PublicInputGate(),
         G.NoopGate()], cfg, 13)
    tables = dict(chip_smoke.k5_gate_tables(worm)[:2])   # the wormhole's, Poseidon's
    gen = torch.Generator(device="cuda").manual_seed(2047)
    ins = {name: [chip_smoke.k5_inputs(c, gen, 1) for _ in range(chip_smoke.K5_TIMED_CALLS)]
           for name, c in tables.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    base = {}
    real = quotient_cuda._LIB
    for name, lib, log in libs:
        quotient_cuda._LIB = lib
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        row = {"variant": name, "card": smi.strip(), "ptxas": regs}
        for tname, common in tables.items():
            got = chip_smoke.k5_call(common, ins[tname][0])
            base.setdefault(tname, got)
            row[f"{tname}_equal"] = bool(torch.equal(got, base[tname]))
            row[f"{tname}_ms"] = chip_smoke.graph_ms(
                [lambda i=i: chip_smoke.k5_call(common, i) for i in ins[tname]])
        print(json.dumps(row), flush=True)
        if name not in MEASURES and not all(row[f"{t}_equal"] for t in tables):
            raise AssertionError(f"variant {name}: its values differ from the source's")
    quotient_cuda._LIB = real


if __name__ == "__main__":
    main()
