"""Device times of K3 (zk_circuits_torch/csrc/witness.cu) against variants
of its own design on one GPU; one JSON line a variant, then one of the
lower figures they give.

    python scripts/k3_variants.py

Each variant is the source with one design choice changed, built with
nvcc beside the port's build (``zk_circuits_torch/_build/k3_variants``):
a Poseidon gate on a team of 12 or of 1 thread (one thread runs the whole
state with the team form's MDS) in place of 4, and a team of 12 in walk
blocks of 512 threads (one pass over a wormhole Poseidon level); walk
blocks of 512 or 1024 threads in place of 256; every level in the walk
(``witness_cuda.WIDE_OPS`` raised past the widest level, no ``ops``
launch); the S-box chain of four products (poseidon.cuh's) in place of
three; no L2 hints of the walk's rows when a block starts; each level's
rows loaded after the level before's work in place of during it; the
level records read from the blob in place of the block's shared copy.
Each is timed (graph_ms, as chip_smoke times K3) on the zk wormhole's
witness at B=1 and B=4, over chip_smoke's three level ranges at B=1, and
a level of a one-op arith chain and of a one-gate Poseidon chain; its
witness must equal the unchanged build's.  One more build, with the arith
op's body removed, times what an arith level costs without its values:
a barrier with the next level's loads in flight.  The last line puts the
schedule's levels at that cost and its Poseidon levels at the shortest
lone-gate level measured.  The times of variants are comparable within
one run only.
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
from zk_circuits_torch.hash import poseidon_cuda  # noqa: E402
from zk_circuits_torch.iop import builder as t_builder  # noqa: E402
from zk_circuits_torch.iop import witness_cuda  # noqa: E402
from zk_circuits_torch.iop import witness_device as wdev  # noqa: E402
from zk_circuits_torch.iop.witness import PartialWitness  # noqa: E402
from zk_circuits_torch.plonk.config import CircuitConfig  # noqa: E402
from zk_circuits_torch.utils import nvcc  # noqa: E402

TEAM12 = ("witness.cu", "constexpr int K3_TEAM = 4;", "constexpr int K3_TEAM = 12;")
THREADS512 = ("witness.cu", "constexpr int K3_WALK_THREADS = 256;",
              "constexpr int K3_WALK_THREADS = 512;")
PREFETCH = "    k3_prefetch(blob, record(l + 1), l + 1, last, threadIdx.x, next, fnext);\n"
LEVEL_OPS = "      k3_level_ops(d, threadIdx.x, K3_WALK_THREADS, f, v);\n"
ARITH_OP = """      uint64_t prod = k3_mul(v[f.in[0]], v[f.in[1]]);
      v[f.out[0]] = gl_add(k3_mul(f.c0, prod), k3_mul(f.c1, v[f.in[2]]));
"""
# (file, text, replacement) of each variant, applied in turn; "base" is
# the source as it is
VARIANTS = {
    "base": [],
    "team12": [TEAM12],
    "team1": [("witness.cu", "constexpr int K3_TEAM = 4;", "constexpr int K3_TEAM = 1;")],
    "team12_threads512": [TEAM12, THREADS512],
    "threads512": [THREADS512],
    "threads1024": [("witness.cu", "constexpr int K3_WALK_THREADS = 256;",
                     "constexpr int K3_WALK_THREADS = 1024;")],
    "wide_in_walk": [],
    "sbox_chain4": [("witness.cuh", "  uint64_t x3 = gl_mul(x2, x), x4 = gl_mul(x2, x2);\n"
                                    "  return gl_mul(x4, x3);",
                     "  uint64_t x3 = gl_mul(x2, x), x6 = gl_mul(x3, x3);\n"
                     "  return gl_mul(x6, x);")],
    "no_l2_hints": [("witness.cu", "  if (first < last)\n    k3_warm_l2(",
                     "  if (false)\n    k3_warm_l2(")],
    "rows_after_work": [("witness.cu", PREFETCH, ""),
                        ("witness.cu", LEVEL_OPS, LEVEL_OPS + PREFETCH)],
    "records_in_blob": [("witness.cu", "return l - first < K3_SMEM_LEVELS ?",
                         "return false ?")],
    # not a design choice but a measure: an arith level's op removed, so
    # that the arith chain times a level's barrier and loads of rows alone
    # (its witness differs, and only arith_level_us means anything)
    "arith_op_removed": [("witness.cuh", ARITH_OP, "")],
}
WIDE_OPS = {"wide_in_walk": 1 << 62}   # witness_cuda.WIDE_OPS of a variant, if not its own
MEASURES = {"arith_op_removed"}        # variants whose witness is not the source's


def build(name: str) -> tuple:
    """Patch and build one variant; returns (name, bound library)."""
    out = nvcc.BUILD_DIR / "k3_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in ("goldilocks.cuh", "poseidon.cuh", "witness.cuh", "witness.cu"):
        (out / src).write_text((nvcc.CSRC / src).read_text())
    for src, old, new in VARIANTS[name]:
        text = (out / src).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {src} no longer holds the text it changes")
        (out / src).write_text(text.replace(old, new))
    poseidon_cuda.write_constants_header(out)
    lib = out / "libk3.so"
    res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
                          str(out / "witness.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, witness_cuda.bind(ctypes.CDLL(str(lib)))


def timed(lib, data, pws, first=0, last=None, cells=True) -> float:
    table = wdev.device_table(data, "cuda")
    seeded = [table.seeded_values(*wdev.seed_batch(data, pws))
              for _ in range(chip_smoke.K3_TIMED_CALLS)]
    calls = [lambda v=v: chip_smoke.k3_call(table, v, first, last, cells, lib) for v in seeded]
    return chip_smoke.graph_ms(calls)["ms"]


def chain(circuit, depth, kind, seeds):
    """A chain circuit built on the card, its seeded witness and the span
    of its levels of ``kind``."""
    b = t_builder.CircuitBuilder(CircuitConfig.standard_recursion_config())
    targets = circuit(b, depth)
    data = b.build(device="cuda")
    levels = [i for i, st in enumerate(data.prover_only.schedule) if st.kind == kind]
    return data, chip_smoke.seed(PartialWitness, targets, seeds), levels[0], levels[-1] + 1


def main() -> None:
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.circuits.wormhole import golden_fixtures

    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, together
        libs = list(pool.map(build, VARIANTS))
    prover = WormholeProver(CircuitConfig.standard_recursion_zk_config(), device="cuda")
    cd = prover.circuit_data
    pw = prover.commit(golden_fixtures.test_inputs()).partial_witness
    chains = {"arith": chain(chip_smoke.arith_chain_circuit, chip_smoke.K3_CHAIN_DEPTH,
                             "arith", (3,)),
              "poseidon": chain(chip_smoke.poseidon_chain_circuit, 24, "poseidon", (3, 5))}
    table = wdev.device_table(cd, "cuda")
    tables = [table] + [wdev.device_table(data, "cuda") for data, *_ in chains.values()]
    ranges = chip_smoke.k3_ranges(cd)
    seeded = wdev.seed_batch(cd, [pw] * 4)
    wide_ops = witness_cuda.WIDE_OPS
    base, rows = None, {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    for name, lib in libs:
        witness_cuda.WIDE_OPS = WIDE_OPS.get(name, wide_ops)
        for t in tables:    # the launch plans follow WIDE_OPS
            t.launch_plans.clear()
        got = chip_smoke.k3_call(table, table.seeded_values(*seeded), lib=lib)
        base = got if base is None else base
        row = {"variant": name, "card": smi.strip(),
               "equal": all(torch.equal(g, b) for g, b in zip(got, base))}
        for batch in (1, 4):
            row[f"ms_b{batch}"] = timed(lib, cd, [pw] * batch)
        for rname, first, last in ranges:
            row[f"{rname}_ms"] = timed(lib, cd, [pw], first, last, False)
        for kind, (data, cpw, first, last) in chains.items():
            row[f"{kind}_level_us"] = 1e3 * timed(lib, data, [cpw], first, last, False) / \
                (last - first)
        rows[name] = row
        print(json.dumps(row), flush=True)
        if not row["equal"] and name not in MEASURES:
            raise AssertionError(f"variant {name}: its witness differs from the source's")
    witness_cuda.WIDE_OPS = wide_ops
    # the lower figures: every level at a narrow level's barrier with its
    # loads in flight, the Poseidon levels at the shortest lone gate's
    kinds = [st.kind for st in cd.prover_only.schedule]
    n_pos = kinds.count("poseidon")
    narrow_us = rows["arith_op_removed"]["arith_level_us"]
    fastest = min((r for r in rows.values() if r["variant"] not in MEASURES),
                  key=lambda r: r["poseidon_level_us"])
    print(json.dumps({"lower_figures": {
        "levels": len(kinds), "poseidon_levels": n_pos,
        "narrow_level_us": narrow_us, "narrow_from": "arith_op_removed",
        "poseidon_level_us": fastest["poseidon_level_us"], "poseidon_from": fastest["variant"],
        "ms": ((len(kinds) - n_pos) * narrow_us + n_pos * fastest["poseidon_level_us"]) / 1e3,
        "card": smi.strip()}}), flush=True)


if __name__ == "__main__":
    main()
