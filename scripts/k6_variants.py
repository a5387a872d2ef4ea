"""Device times of K6 (zk_circuits_torch/csrc/permutation.cu) against
variants of its own design on one GPU; one JSON line a variant.

    python scripts/k6_variants.py

Each variant is the source with one design choice changed, built with
nvcc beside the port's build (``zk_circuits_torch/_build/k6_variants``):
point blocks of 256 threads (8 warps, no register cap) in place of 320 (a
warp a chunk of a 32-point tile, at most 102 registers); scan blocks of
128 threads in place of 256; and, as measures of where the time goes
(their values differ from the source's), the inverse left out (the
chain's 73 products) and the chunk products left out.  The source and the
256-thread variant are also timed with their tiles forced to 32, 64, 128
and 256 points.  Each is timed (graph_ms, as chip_smoke times K6: both
launches, and the point kernel alone) at one wormhole proof (2^13
points), at B=4 and at B=4 on 2^14 points (the level-1 batch's points; a
common of the wormhole's gates stands in for the level circuit, whose K6
shape is the same: 80 routed wires in chunks of 8, two challenges); a
design variant's values must equal the source's.  The source runs first
and last; the times of variants are comparable within one run only.
"""

import ctypes
import json
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zk_circuits_torch.iop import gates as G  # noqa: E402
from zk_circuits_torch.plonk import config, permutation_cuda  # noqa: E402
from zk_circuits_torch.utils import nvcc  # noqa: E402

SOURCES = ("goldilocks.cuh", "perm_chunk.cuh", "permutation.cuh", "permutation.cu")
CHUNK = """      perm_chunk<NC>(c.wv + b * c.wv_ps + i, c.wv_rs, c.sig + i, c.sig_rs, lo, hi,
                     gl_ld(c.x + i), bk, be, ga, nm, dn);"""

# (file, text, replacement) of each variant, applied in turn; "base" is the
# source as it is
VARIANTS = {
    "base": [],
    "threads_256": [("permutation.cu", "constexpr int K6_POINT_THREADS = 320;",
                     "constexpr int K6_POINT_THREADS = 256;"),
                    ("permutation.cu", "__launch_bounds__(K6_POINT_THREADS, 2) k6_point_kernel",
                     "__launch_bounds__(K6_POINT_THREADS) k6_point_kernel")],
    "scan_128": [("permutation.cu", "constexpr int K6_SCAN_THREADS = 256;",
                  "constexpr int K6_SCAN_THREADS = 128;")],
    "inverse_removed": [("permutation.cuh", "uint64_t inv = k6_inverse(dr), total = 0;",
                         "uint64_t inv = dr, total = 0;")],
    "chunks_removed": [("permutation.cuh", CHUNK,
                        "for (int ch = 0; ch < NC; ch++) { nm[ch] = be[ch] + lo; "
                        "dn[ch] = ga[ch] + hi; }")],
}
MEASURES = {name for name in VARIANTS if name.endswith("_removed")}
TILES = (32, 64, 128, 256)
TILED = ("base", "threads_256")   # the variants timed at each tile too


def build(name: str) -> tuple:
    """Patch and build one variant; returns (name, bound library, nvcc's
    output)."""
    out = nvcc.BUILD_DIR / "k6_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
        (out / src).write_text((nvcc.CSRC / src).read_text())
    for src, old, new in VARIANTS[name]:
        text = (out / src).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {src} no longer holds the text it changes")
        (out / src).write_text(text.replace(old, new))
    lib = out / "libk6.so"
    res = subprocess.run([nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I", str(out), "-o", str(lib),
                          str(out / "permutation.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return name, permutation_cuda.bind(ctypes.CDLL(str(lib))), res.stdout + res.stderr


def shapes() -> list:
    """(name, K6 data, B) of the three timed shapes: the wormhole's gates
    at 2^13 rows (one proof, B=4) and at 2^14 (B=4); seeded sigmas and
    points (chip_smoke.k6_inputs draws them where the data has none)."""
    cfg = config.CircuitConfig.standard_recursion_zk_config()
    gates = [G.PoseidonGate(), G.ArithmeticGate(num_ops=20), G.BaseSum2Gate(num_limbs=32),
             G.BaseSum2Gate(num_limbs=5), G.ConstantGate(num_consts=2), G.PublicInputGate(),
             G.NoopGate()]
    none = types.SimpleNamespace(sigmas_values=np.zeros((0, 1), dtype=np.uint64))
    out = []
    for name, bits, batch in (("wormhole", 13, 1), ("wormhole_batch", 13, 4),
                              ("level1_batch", 14, 4)):
        data = types.SimpleNamespace(common=chip_smoke.k5_gate_common(gates, cfg, bits),
                                     prover_only=none)
        out.append((name, data, batch))
    return out


def timed(data, ins) -> dict:
    g = chip_smoke.graph_ms([lambda i=i: chip_smoke.k6_call(data, i) for i in ins])
    g["point_ms"] = chip_smoke.graph_ms(
        [lambda i=i: chip_smoke.k6_point_launch(data, i) for i in ins])["ms"]
    return g


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, together
        libs = list(pool.map(build, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(2048)
    cases = [(name, data, [chip_smoke.k6_inputs(data, gen, batch)
                           for _ in range(chip_smoke.K6_TIMED_CALLS)])
             for name, data, batch in shapes()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    base = {}
    real = permutation_cuda._LIB
    for name, lib, log in libs + libs[:1]:
        permutation_cuda._LIB = lib
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        row = {"variant": name, "card": smi.strip(), "ptxas": regs}
        for shape, data, ins in cases:
            got = chip_smoke.k6_call(data, ins[0])[0]
            base.setdefault(shape, got)
            row[f"{shape}_equal"] = bool(torch.equal(got, base[shape]))
            row[shape] = timed(data, ins)
        print(json.dumps(row), flush=True)
        if name not in MEASURES and not all(row[f"{s}_equal"] for s, _, _ in cases):
            raise AssertionError(f"variant {name}: its values differ from the source's")
    saved = permutation_cuda.MIN_TILE, permutation_cuda.MAX_TILE
    for name, lib, _ in libs:
        if name not in TILED:
            continue
        permutation_cuda._LIB = lib
        for tile in TILES:
            permutation_cuda.MIN_TILE = permutation_cuda.MAX_TILE = tile
            row = {"variant": f"{name}/tile_{tile}", "card": smi.strip()}
            for shape, data, ins in cases:
                row[f"{shape}_equal"] = bool(torch.equal(chip_smoke.k6_call(data, ins[0])[0],
                                                         base[shape]))
                row[shape] = timed(data, ins)
            print(json.dumps(row), flush=True)
    permutation_cuda.MIN_TILE, permutation_cuda.MAX_TILE = saved
    permutation_cuda._LIB = real


if __name__ == "__main__":
    main()
