"""Device times of K4's leaf mode (zk_circuits_torch/csrc/ntt.cuh, the
staged store of whole fiber leaves) against variants of its own design on
one GPU; one JSON line a variant.

    python scripts/k4_leaf_variants.py

Each variant is the source with one design choice changed, built with
nvcc beside the port's build (``zk_circuits_torch/_build/k4_leaf_variants``):
the flush one word a thread at a time, each loaded from shared memory just
before its store (``word_stores``, the first design), in place of pairs of
words loaded first and stored as 16 bytes; the flush's addresses through
``k4_slot`` in place of the runs of whole leaves (``slot_addresses``); the
staged last round's tasks column by column as the coset NTT's
(``column_order``); and, as measures of where the time goes (their values
differ from the source's), the flush's stores left out
(``flush_stores_removed``) and the staging and the flush left out
(``staging_removed``).  Each is timed (graph_ms, as chip_smoke's k4_time
times K4) at the leaf mode's main-path shapes: FRI's round-0 codeword of
one wormhole proof (2 x (1, 2^13) -> 2^16), of B=4 and of the level-1
batch (2 x (4, 2^14) -> 2^17), each beside K4's coset NTT of the same rows
to the same size (the same words as contiguous rows, which no variant
changes).  A design variant's leaves must equal the source's.  The source
runs first and last; times are comparable within one run only.
"""

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zk_circuits_torch.ntt import ntt_cuda  # noqa: E402
from zk_circuits_torch.utils import nvcc  # noqa: E402

SOURCES = ("goldilocks.cuh", "ntt.cuh", "ntt.cu")
# the flush of one word a thread at a time, each loaded just before its store
WORD_FLUSH = """  const int words = 1 << (t.l + t.lc);
#pragma unroll
  for (int u = 0; u < K4_V; u++) {
    const int e = tid + nthr * u, cl = e >> (t.l + 1);
    if (e >= words || (pass == K4_PASS_ROW && cl >= t.count)) break;
    uint64_t* dst;
    if (pass == K4_PASS_ROW) {
      dst = base + e;
    } else if (c.leaf_log <= t.l) {
      const long long leaf = t.first + cl + ((long long)((e >> ll) & ((1 << g) - 1)) << log_n2);
      dst = base + (leaf << ll) + (e & ((1 << ll) - 1));
    } else {
      const int r = (e >> 1) & ((1 << t.l) - 1);
      const long long k1 = ((long long)(r & ((1 << kb) - 1)) << g) | (r >> kb);
      dst = k4_slot(c, (e & 1) ? t.row + c.half : t.row, t.first + cl + (k1 << log_n2));
    }
    *dst = sm[k4_stage_pad(e)];
  }
}"""
FLUSH_START = "#pragma unroll\n  for (int u = 0; u < K4_V / 2; u++) {\n    const int p = tid + nthr * u;\n"
FLUSH_END = "    k4_store2(dst, v + 2 * u);\n  }\n}"


def flush_patch(body: str) -> tuple:
    """The patch that puts ``body`` in place of k4_flush's loops."""
    text = (nvcc.CSRC / "ntt.cuh").read_text()
    start = text.index(FLUSH_START)
    return ("ntt.cuh", text[start:text.index(FLUSH_END, start) + len(FLUSH_END)], body)


VARIANTS = {
    "base": [],
    "word_stores": [flush_patch(WORD_FLUSH)],
    "slot_addresses": [("ntt.cuh", "    } else if (c.leaf_log <= t.l) {",
                        "    } else if (c.leaf_log < 0) {")],
    "column_order": [("ntt.cuh", "(pass == K4_PASS_B && !t.staged && r > 0",
                      "(pass == K4_PASS_B && r > 0")],
    "two_columns": [],   # the leaf mode's pass B tiles down to 2 columns (SETTINGS)
    "stage_apart": [
        ("ntt.cuh", "#pragma once\n", "#pragma once\n#define STAGE0 (k4_rounds(t.l) > 1 ? "
                    "(long long)k4_pitch(t.l, pass) << t.lc : 0)\n"),
        ("ntt.cuh", "        sm[k4_stage_pad(head", "        sm[STAGE0 + k4_stage_pad(head"),
        ("ntt.cuh", "k4_load2(sm + k4_stage_pad(2 * p)", "k4_load2(sm + STAGE0 + k4_stage_pad(2 * p)"),
        ("ntt.cuh", "  return st > ex ? st : ex;", "  return st + ex;"),
        ("ntt.cuh", "    if constexpr (k > 1) blk.sync();\n    blk.template store",
         "    blk.template store")],
    "components_apart": [
        ("ntt.cuh", "  return (((cl << t.l) | k4_rot(k1, g, t.l)) << 1) | comp;",
         "  return (comp << (t.l + t.lc - 1)) | (cl << t.l) | k4_rot(k1, g, t.l);"),
        ("ntt.cuh", "        sm[k4_stage_pad(head | (k4_rot(q << ls, g, t.l) << 1))] = gl_canon(a[q]);",
         "        sm[k4_pad(head | k4_rot(q << ls, g, t.l))] = gl_canon(a[q]);"),
        ("ntt.cuh", "    if (p < pairs) k4_load2(sm + k4_stage_pad(2 * p), v + 2 * u);",
         "    if (p < pairs) {\n      v[2 * u] = sm[k4_pad(p)];\n"
         "      v[2 * u + 1] = sm[k4_pad(p + pairs)];\n    }")],
    "block_runs": [("ntt.cuh", "    k4_store2(dst, v + 2 * u);",
                    "    k4_store2(base + (t.first << (t.l + 1)) + e, v + 2 * u);")],
    "flush_stores_removed": [("ntt.cuh", "    k4_store2(dst, v + 2 * u);",
                              "    if (v[2 * u] == 12345) *dst = v[2 * u + 1];")],
    "staging_removed": [
        ("ntt.cuh", "        sm[k4_stage_pad(head | (k4_rot(q << ls, g, t.l) << 1))] = gl_canon(a[q]);",
         "        if (gl_canon(a[q]) == 12345) sm[(head | (k4_rot(q << ls, g, t.l) << 1)) & 7] = "
         "0;"),
        ("ntt.cuh", "    blk.sync();\n    blk.flush();", "")],
}
MEASURES = {"block_runs", "flush_stores_removed", "staging_removed"}
# the wrapper's mirrors of a variant's settings, set while it runs
SETTINGS = {"two_columns": {"LEAF_COLS_MIN_LOG": 1}}


def build(name: str) -> tuple:
    """Patch and build one variant; returns (name, bound library, nvcc's
    output)."""
    out = nvcc.BUILD_DIR / "k4_leaf_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
        (out / src).write_text((nvcc.CSRC / src).read_text())
    for src, old, new in VARIANTS[name]:
        text = (out / src).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {src} no longer holds the text it changes")
        (out / src).write_text(text.replace(old, new))
    lib = out / "libntt.so"
    res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
                          str(out / "ntt.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, ntt_cuda.bind(ctypes.CDLL(str(lib))), res.stdout + res.stderr


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, together
        libs = list(pool.map(build, VARIANTS))
    rng = np.random.default_rng(2071)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    shapes, shape_rows, shape_points = [], {}, {}
    for name, b, n_in, size, a in (("fri_leaves_0", 1, 1 << 13, 1 << 16, 4),
                                   ("batch_fri_leaves_0", 4, 1 << 13, 1 << 16, 4),
                                   ("level_fri_leaves_0", 4, 1 << 14, 1 << 17, 4)):
        fs = chip_smoke.k4_inputs(rng, (2, b, n_in), chip_smoke.K4_TIMED_CALLS)
        shape_rows[name], shape_points[name] = b, size
        shapes.append((name, [lambda f=f, size=size, a=a: ntt_cuda.coset_leaves(
                                  f[0], f[1], 7, size, a) for f in fs],
                       [lambda f=f, size=size, rows=2 * b, n_in=n_in: ntt_cuda.transform(
                           f.view(rows, n_in), "coset_ntt", shift=7, size=size)
                        for f in fs]))
    base, real = {}, ntt_cuda._LIB
    try:
        for name, lib, log in libs + libs[:1]:
            ntt_cuda._LIB = lib
            saved = {k: getattr(ntt_cuda, k) for k in SETTINGS.get(name, {})}
            for k, v in SETTINGS.get(name, {}).items():
                setattr(ntt_cuda, k, v)
            lines = log.splitlines()
            row = {"variant": name, "card": smi.strip(),   # pass lengths 2^8 and 2^9
                   "ptxas": [" ".join(x.strip() for x in lines[i:i + 3])
                             for i, ln in enumerate(lines)
                             if "Compiling entry function" in ln and
                             ("k4_kernelILi8E" in ln or "k4_kernelILi9E" in ln)]}
            try:
                for shape, leaves, coset in shapes:
                    got = leaves[0]().clone()
                    base.setdefault(shape, got)
                    row[f"{shape}_equal"] = bool(torch.equal(got, base[shape]))
                    row[shape] = chip_smoke.paired_ms(leaves, coset)   # coset, leaf, leaf, coset
                    row[f"{shape}_log_cols"] = list(ntt_cuda.tiles(
                        2 * shape_rows[shape], shape_points[shape],
                        ntt_cuda.leaf_plan(shape_points[shape]), 132, leaf=True))
            finally:
                for k, v in saved.items():
                    setattr(ntt_cuda, k, v)
            print(json.dumps(row), flush=True)
            if name not in MEASURES and not all(row[f"{s}_equal"] for s, _, _ in shapes):
                raise AssertionError(f"variant {name}: its leaves differ from the source's")
    finally:
        ntt_cuda._LIB = real


if __name__ == "__main__":
    main()
