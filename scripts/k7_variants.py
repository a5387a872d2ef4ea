"""Device times of K7 (the openings in zk_circuits_torch/csrc/fri.cu)
against variants of its own design on one GPU; one JSON line a variant.

    python scripts/k7_variants.py

Each variant is the source with one design choice changed, built with
nvcc beside the port's build (``zk_circuits_torch/_build/k7_variants``):
two or four blocks an SM in place of three (the register cap); the
powers' squarings by fri_emul in place of fri_esqr; and, as measures of
where the time goes (their values differ from the source's), the powers
left out (each coefficient's power a constant) and the last block's sum
over the tiles left out.  The source is also timed with its tiles forced
to 256, 512, 1024 and 2048 coefficients.  Each is timed (graph_ms, as
chip_smoke's fri_time times K7) at one wormhole proof (267 rows of 2^13
at zeta, 2 at g zeta), at B=4 (the constants/sigmas shared) and at B=4
on 2^14 coefficients (the wormhole's widths at the level-1 batch's
length); a design variant's values must equal the source's.  The source
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

SOURCES = ("goldilocks.cuh", "fri.cuh", "fri.cu")
BOUNDS = "__launch_bounds__(K7_THREADS, 3) k7_kernel"
WORMHOLE_WIDTHS = (84, 139, 24, 20)   # constants/sigmas, wires, zs and partial products, quotient

# (file, text, replacement) of each variant, applied in turn; "base" is the
# source as it is
VARIANTS = {
    "base": [],
    "blocks_2": [("fri.cu", BOUNDS, "__launch_bounds__(K7_THREADS, 2) k7_kernel")],
    "blocks_4": [("fri.cu", BOUNDS, "__launch_bounds__(K7_THREADS, 4) k7_kernel")],
    "emul_squares": [("fri.cuh", "    x = fri_esqr(x);", "    x = fri_emul(x, x);")],
    "powers_removed": [("fri.cuh", "const FriExt p = fri_pow(z, v < 32",
                        "const FriExt p = fri_point(c.pts, 0, 0, 0); (void)(v < 32")],
    "last_sum_removed": [("fri.cuh", "  if (!*last) return;", "  return;")],
}
MEASURES = {name for name in VARIANTS if name.endswith("_removed")}
TILES = (256, 512, 1024, 2048)


def build(name: str) -> tuple:
    """Patch and build one variant; returns (name, bound library, nvcc's
    output)."""
    out = nvcc.BUILD_DIR / "k7_variants" / name
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


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc a variant, together
        libs = list(pool.map(build, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(2054)
    cases = [(name, [chip_smoke.fri_calls(chip_smoke.fri_inputs(gen, WORMHOLE_WIDTHS, n, b, 2))
                     ["k7"] for _ in range(chip_smoke.FRI_TIMED_CALLS)])
             for name, n, b in (("wormhole", 1 << 13, 1), ("wormhole_batch", 1 << 13, 4),
                                ("level1_batch", 1 << 14, 4))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    base = {}
    real = fri_cuda._LIB

    def row_of(name: str, extra: dict) -> dict:
        fri_cuda._COUNTS.clear()   # fresh counters: last_sum_removed never sets them back
        row = {"variant": name, "card": smi.strip(), **extra}
        for shape, calls in cases:
            got = torch.stack(calls[0]())
            base.setdefault(shape, got)
            row[f"{shape}_equal"] = bool(torch.equal(got, base[shape]))
            row[shape] = chip_smoke.graph_ms(calls)
        print(json.dumps(row), flush=True)
        return row

    for name, lib, log in libs + libs[:1]:
        fri_cuda._LIB = lib
        row = row_of(name, {"ptxas": [ln.strip() for ln in log.splitlines()
                                      if "k7" in ln or "registers" in ln or "spill" in ln]})
        if name not in MEASURES and not all(row[f"{s}_equal"] for s, _ in cases):
            raise AssertionError(f"variant {name}: its values differ from the source's")
    fri_cuda._LIB = libs[0][1]
    saved = fri_cuda.K7_MIN_TILE, fri_cuda.K7_MAX_TILE
    for tile in TILES:
        fri_cuda.K7_MIN_TILE = fri_cuda.K7_MAX_TILE = tile
        row_of(f"tile_{tile}", {})
    fri_cuda.K7_MIN_TILE, fri_cuda.K7_MAX_TILE = saved
    fri_cuda._LIB = real


if __name__ == "__main__":
    main()
