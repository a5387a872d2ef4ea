"""Device times of K9 (the fold rounds in zk_circuits_torch/csrc/fri.cu)
against variants of its own design on one GPU; one JSON line a variant.

    python scripts/k9_variants.py

Each variant is the source with one design choice changed, built with
nvcc beside the port's build (``zk_circuits_torch/_build/k9_variants``):
the round mode's NTT in rounds of radix 4 or 16 (K4's radix) in place of
8 (K9_RADIX_LOG), its lanes folding 2 or 8 outputs at once in place of 4
(K9_UNROLL; the clusters the wrapper picks grow as a block folds fewer),
its blocks of 512 threads in place of 256 (the wrapper's mirror of each
constant set to match); and, as measures of where the round mode's time
goes (their values differ from the source's), the kernel cut short at its
start, after the prefetch, after the fold and before the NTT (after the
cluster's barrier and the gather; each phase's time the difference of
two cuts), its fold left out, and its leaf stores left out.  The source
is also timed with each group of cosets that folds once: 1 block (every
block folds the whole polynomial), 2, 4 and 8 (a thread-block cluster
whose blocks read each other's shares from shared memory), in place of
``fri_cuda.round_group_log``'s choice.  Each is timed (graph_ms, as
chip_smoke's fri_time times K9) at the round mode's main-path rounds: the wormhole's
2^13 -> 2^9 fold with its 2^12-point codeword at one proof and at B=4,
and the level-1 batch's (B=4) 2^14 -> 2^10 and 2^10 -> 2^6; and at the
fold mode's: the wormhole's last fold, 2^9 -> 2^5, at one proof and at
B=4.  A design variant's values must equal the source's.  The source
runs first and last; the times of variants are comparable within one run
only.
"""

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zk_circuits_torch.fri import fri_cuda  # noqa: E402
from zk_circuits_torch.utils import nvcc  # noqa: E402

SOURCES = ("goldilocks.cuh", "ntt.cuh", "fri.cuh", "fri.cu")

# (file, text, replacement) of each variant, applied in turn; "base" is the
# source as it is
def define(name: str, old: int, new: int) -> tuple:
    """The patch of one of fri.cuh's K9 constants."""
    return ("fri.cuh", f"#define {name} {old} ", f"#define {name} {new} ")


VARIANTS = {
    "base": [],
    "radix_4": [define("K9_RADIX_LOG", 3, 2)],
    "radix_16": [define("K9_RADIX_LOG", 3, 4)],
    "threads_512": [define("K9_ROUND_THREADS", 256, 512)],
    "unroll_2": [define("K9_UNROLL", 4, 2)],
    "unroll_8": [define("K9_UNROLL", 4, 8)],
    "cut_at_start": [("fri.cu", "  k9_round_prefetch(blk, c, coset, k9_smem);",
                      "  if (c.batch) return;\n  k9_round_prefetch(blk, c, coset, k9_smem);")],
    "cut_after_prefetch": [("fri.cu", "  k9_round_fold(blk, c, b, y, coset, k9_smem);",
                            "  fri_copy_wait();\n  if (c.batch) return;\n"
                            "  k9_round_fold(blk, c, b, y, coset, k9_smem);")],
    "cut_after_fold": [("fri.cu", "  const uint64_t* shares[1 << K9_MAX_GROUP_LOG];",
                        "  if (c.batch) return;\n  const uint64_t* shares[1 << K9_MAX_GROUP_LOG];")],
    "cut_before_ntt": [("fri.cu", "  k9_ntt<L, 0>(blk, c, k9_smem, b, y, coset);",
                        "  if (c.group_log) asm volatile(\"barrier.cluster.wait.acquire.aligned;\" "
                        "::: \"memory\");\n  if (c.batch) return;\n"
                        "  k9_ntt<L, 0>(blk, c, k9_smem, b, y, coset);")],
    "fold_removed": [("fri.cuh", "  for (long long base = 0; base < mg; base += per * K9_UNROLL)",
                      "  for (long long base = mg; base < mg; base += per * K9_UNROLL)")],
    "stores_removed": [("fri.cuh", "          out[(row << lw) + 2 * (t >> lq)] = gl_canon(a[k]);",
                        "          if (a[k] == 12345) out[(row << lw) + 2 * (t >> lq)] = a[k];")],
}
# the wrapper's mirrors of a variant's constants, set while it runs
SETTINGS = {"radix_4": {"RADIX_LOG": 2}, "radix_16": {"RADIX_LOG": 4},
            "threads_512": {"ROUND_THREADS": 512}, "unroll_2": {"ROUND_UNROLL": 2},
            "unroll_8": {"ROUND_UNROLL": 8}}
MEASURES = {name for name in VARIANTS if name.endswith("_removed") or name.startswith("cut_")}
GROUPS = (0, 1, 2, 3)
SHIFT = pow(7, 16, chip_smoke.P)   # the round-1 codeword's shift


def build(name: str) -> tuple:
    """Patch and build one variant; returns (name, bound library, nvcc's
    output)."""
    out = nvcc.BUILD_DIR / "k9_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
        (out / src).write_text((nvcc.CSRC / src).read_text())
    for src, old, new in VARIANTS[name]:
        text = (out / src).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {src} no longer holds the text it changes")
        (out / src).write_text(text.replace(old, new))
    lib = out / "libfri.so"
    res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
                          str(out / "fri.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, fri_cuda.bind(ctypes.CDLL(str(lib))), res.stdout + res.stderr


def cases(gen) -> list:
    """(name, FRI_TIMED_CALLS closures on inputs of their own) of each
    timed shape."""
    def calls(batch, n, a, nxt):
        out = []
        for _ in range(chip_smoke.FRI_TIMED_CALLS):
            c = (chip_smoke.gl_random(gen, (batch, n)), chip_smoke.gl_random(gen, (batch, n)))
            beta = chip_smoke.host_betas(gen, batch)
            out.append((lambda c=c, beta=beta: fri_cuda.fold_round(*c, beta, a, nxt, 3, SHIFT))
                       if nxt else (lambda c=c, beta=beta: fri_cuda.fold(*c, beta, a)))
        return out

    return [("wormhole_round", calls(1, 1 << 13, 4, 4)),
            ("wormhole_batch_round", calls(4, 1 << 13, 4, 4)),
            ("level1_round1", calls(4, 1 << 14, 4, 4)),
            ("level1_round2", calls(4, 1 << 10, 4, 1)),
            ("wormhole_fold", calls(1, 1 << 9, 4, None)),
            ("wormhole_batch_fold", calls(4, 1 << 9, 4, None))]


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, together
        libs = list(pool.map(build, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(2057)
    shapes = cases(gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    base = {}
    real, real_group = fri_cuda._LIB, fri_cuda.round_group_log

    def row_of(name: str, extra: dict) -> dict:
        row = {"variant": name, "card": smi.strip(), **extra}
        for shape, calls in shapes:
            got = [t.clone() for t in chip_smoke._flat(calls[0]())]
            base.setdefault(shape, got)
            row[f"{shape}_equal"] = all(torch.equal(g, w) for g, w in zip(got, base[shape]))
            row[shape] = chip_smoke.graph_ms(calls)
        print(json.dumps(row), flush=True)
        return row

    try:
        for name, lib, log in libs + libs[:1]:
            fri_cuda._LIB = lib
            saved = {k: getattr(fri_cuda, k) for k in SETTINGS.get(name, {})}
            for k, v in SETTINGS.get(name, {}).items():
                setattr(fri_cuda, k, v)
            try:
                row = row_of(name, {"ptxas": [ln.strip() for ln in log.splitlines()
                                              if "k9" in ln or "registers" in ln or
                                              "spill" in ln]})
            finally:
                for k, v in saved.items():
                    setattr(fri_cuda, k, v)
            if name not in MEASURES and not all(row[f"{s}_equal"] for s, _ in shapes):
                raise AssertionError(f"variant {name}: its values differ from the source's")
        fri_cuda._LIB = libs[0][1]
        for g in GROUPS:   # every shape's group forced to 2^g cosets (fewer where it has fewer)
            fri_cuda.round_group_log = lambda rate, log_m, _a, g=g: min(g, rate, log_m)
            row = row_of(f"group_{1 << g}", {"group_log": g})
            if not all(row[f"{s}_equal"] for s, _ in shapes):
                raise AssertionError(f"group of {1 << g}: its values differ from the source's")
    finally:
        fri_cuda._LIB, fri_cuda.round_group_log = real, real_group


if __name__ == "__main__":
    main()
