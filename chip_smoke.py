#!/usr/bin/env python3
"""Smoke run of the torch/CUDA port (zk_circuits_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. card     -- the card's name and power limit; build the Poseidon leaf
               kernel (K1) from csrc/ with nvcc, timed.
2. k1_check -- K1 against its plain torch version on the card, at the main
               path's widths and a ragged row count, both layouts.
3. square   -- a one-gate square circuit under both standard configs: the
               proof from device="cuda" must equal the proof from
               device="cpu" byte for byte, and verify.
4. wormhole -- the zk wormhole proof as bench.py proves it (circuit built
               on the card, one cold and three warm proves), verified,
               tamper-checked, and its sha256 held to the digest of the JAX
               package's host-path proof of the same inputs (pinned below).
               K1's launch counter must rise during the proves.
5. profile  -- one more warm wormhole proof under torch.profiler: device
               busy time and idle share, device operations, top kernels.
6. k1_time  -- K1 timed with CUDA events at the main path's shapes beside
               its plain version and its roofline bound.

The last lines are the card line, the kernels line and
{"ok": true, "device": {...}}.  Needs no network; imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

# sha256(proof_to_bytes(...)) of the zk wormhole proof of
# golden_fixtures.test_inputs() from the JAX package's host path
# (WormholeProver(standard_recursion_zk_config).commit(...).prove(
# use_device=False)); tests/test_torch_wormhole_golden.py re-derives it.
GOLDEN_WORMHOLE_ZK_SHA256 = (
    "abae70517381a5cdd5f80b799826384523d496154711225438ad35f48aa4ca67")

P = 2**64 - 2**32 + 1
GRIND_ROWS = 1 << 17   # candidates per PoW sweep (fri.GRIND_BATCH["cuda"])

# Roofline of one H100 SXM.  Memory: 3.35 TB/s (NVIDIA data sheet).
# Integer: 132 SMs x 64 x 1.98 GHz = 1.67e13 32-bit integer multiply(-add)
# instructions per second (CUDA C++ Programming Guide, arithmetic
# instruction throughput: 64 results per clock per SM for compute
# capability 9.0; 1.98 GHz is the boost clock behind the data sheet's
# 67 TFLOP/s FP32 figure = 132 x 128 x 2 x 1.98e9).
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
# 32-bit multiply instructions per Poseidon permutation, counted from
# csrc/poseidon.cuh: 118 S-boxes (8 full rounds x 12 + 22 partial) of four
# 64x64->128 products, each four 32x32->64 partial products = 8 mul.lo/hi;
# plus 30 MDS layers of 144 coefficient products, each on two 32-bit halves.
SBOX_MULS = (8 * 12 + 22) * 4 * 8
MDS_MULS = 30 * 144 * 2
MULS_PER_PERM = SBOX_MULS + MDS_MULS

K1_SOURCE = "zk_circuits_torch/csrc/poseidon_leaf.cu"
K1_REPLACES = "zk_circuits_tpu/hash/poseidon_pallas.py:164"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def k1_bound_ms(n: int, cols: int) -> tuple[float, str]:
    bytes_moved = n * cols * 8 + n * 32
    perms = n * ((cols + 7) // 8)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = perms * MULS_PER_PERM / INT32_MUL_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def leaf_matrix(rng, n: int, cols: int):
    """(n, cols) u64 leaf matrix with edge values in the first rows."""
    import numpy as np

    x = rng.integers(0, P, (n, cols), dtype=np.uint64)
    edge = np.array([0, 1, P - 1, 2**64 - 1], dtype=np.uint64)
    for i, v in enumerate(edge):
        x[i] = v
    x[len(edge), : min(cols, 4)] = edge[: min(cols, 4)]
    return x


def phase_card(state) -> None:
    import torch

    from zk_circuits_torch.hash import poseidon_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    state["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    t0 = time.perf_counter()
    poseidon_cuda.build()
    ptxas = [ln.strip() for ln in poseidon_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "card", "nvidia_smi": state["smi"],
          "name": torch.cuda.get_device_name(0),
          "k1_build_s": time.perf_counter() - t0, "ptxas": ptxas})


def phase_k1_check(state) -> None:
    import numpy as np
    import torch

    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.hash import poseidon as plain
    from zk_circuits_torch.hash import poseidon_pallas as pp

    rng = np.random.default_rng(2026)
    cases = ([(GRIND_ROWS, c) for c in (5, 8, 32, 135, 139)]
             + [(GRIND_ROWS // 2, 139), (GRIND_ROWS - 37, 139), (1000, 5)])
    max_err = 0
    t0 = time.perf_counter()
    for n, cols in cases:
        host = leaf_matrix(rng, n, cols)
        rows = torch.from_numpy(host.view(np.int64)).cuda()
        vals = rows.t().contiguous()                  # column-major (cols, n)
        want = gf.to_u64(plain.batch_hash_no_pad(rows))
        got_rows = gf.to_u64(pp.hash_leaves(rows))
        got_vals = gf.to_u64(pp.hash_values(vals))
        torch.cuda.synchronize()
        for got in (got_rows, got_vals):
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            max_err = max(max_err, float(diff.max()))
            if not np.array_equal(got, want):
                raise AssertionError(f"K1 != plain at n={n} cols={cols}")
        if not (got_vals < np.uint64(P)).all():
            raise AssertionError("K1 digest not canonical")
    state["k1_max_abs_err"] = max_err
    emit({"phase": "k1_check", "cases": [list(c) for c in cases],
          "layouts": ["row-major", "column-major"], "equal": True,
          "max_abs_err": max_err, "s": time.perf_counter() - t0})


def _square_proof(cfg, device):
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness

    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    data = b.build(device=device)
    pw = PartialWitness()
    pw.set_target(x, 3)
    return data, data.prove(pw, device=device)


def phase_square(state) -> None:
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    for name, cfg in (("standard", CircuitConfig.standard_recursion_config()),
                      ("zk", CircuitConfig.standard_recursion_zk_config())):
        t0 = time.perf_counter()
        data, gpu = _square_proof(cfg, "cuda")
        t1 = time.perf_counter()
        _, cpu = _square_proof(cfg, "cpu")
        t2 = time.perf_counter()
        if proof_to_bytes(gpu) != proof_to_bytes(cpu):
            raise AssertionError(f"square/{name}: cuda proof != cpu proof")
        data.verify(gpu)
        emit({"phase": "square", "config": name, "bytes_equal": True,
              "verified": True, "cuda_s": t1 - t0, "cpu_s": t2 - t1})


def phase_wormhole(state) -> None:
    import torch

    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.circuits.wormhole import golden_fixtures
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils import profiling
    from zk_circuits_torch.utils.serialization import proof_from_bytes, proof_to_bytes

    cfg = CircuitConfig.standard_recursion_zk_config()
    t0 = time.perf_counter()
    prover = WormholeProver(cfg, device="cuda")
    build_s = time.perf_counter() - t0
    cd, targets = prover.circuit_data, prover.targets
    inputs = golden_fixtures.test_inputs()

    def one_proof(p):
        t = time.perf_counter()
        proof = p.commit(inputs).prove(device="cuda")
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t

    profiling.reset_timings()
    poseidon_cuda.launches = 0          # main path starts here
    proof, cold_s = one_proof(prover)
    per_proof = poseidon_cuda.launches
    warm = []
    for _ in range(3):
        proof_w, dt = one_proof(WormholeProver(circuit_data=cd, targets=targets))
        warm.append(dt)
    launches = poseidon_cuda.launches   # main path ends here
    if per_proof <= 0 or launches != 4 * per_proof:
        raise AssertionError(f"K1 launches: {per_proof} per proof, {launches} in all")

    data = proof_to_bytes(proof)
    if proof_to_bytes(proof_w) != data:
        raise AssertionError("warm proof bytes differ from the cold proof")
    digest = hashlib.sha256(data).hexdigest()
    if digest != GOLDEN_WORMHOLE_ZK_SHA256:
        raise AssertionError(f"wormhole proof sha256 {digest} != pinned "
                             f"{GOLDEN_WORMHOLE_ZK_SHA256}")
    cd.verify(proof)
    bad = bytearray(data)   # flip a bit of the wires cap's first element
    bad[16 + 8 * len(proof.public_inputs)] ^= 1
    try:
        cd.verify(proof_from_bytes(bytes(bad), cd.common))
    except ValueError:
        pass
    else:
        raise AssertionError("tampered wormhole proof was accepted")
    state["wormhole"] = (cd, targets, inputs)
    state["lde_size"] = cd.common.lde_size
    state["fri_arity"] = 1 << cfg.fri_config.reduction_arity_bits
    state["k1_launches"] = launches
    state["k1_launches_per_proof"] = per_proof
    timings = {k: statistics.median(v) for k, v in profiling.get_timings().items()}
    emit({"phase": "wormhole", "config": "standard_recursion_zk_config",
          "degree_bits": cd.common.degree_bits, "proof_bytes": len(data),
          "sha256": digest, "golden": True, "verified": True,
          "tamper_rejected": True, "build_s": build_s, "cold_s": cold_s,
          "warm_s": warm, "warm_proofs_per_s": 1.0 / statistics.median(warm),
          "k1_launches_per_proof": per_proof, "k1_launches": launches,
          "stage_median_s": timings})


def phase_profile(state) -> None:
    """One more warm wormhole proof under torch.profiler: device busy time
    (CUDA kernels and copies, one stream), idle share, device operations,
    the leaf kernel's share and the top kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zk_circuits_torch.api.prover import WormholeProver

    cd, targets, inputs = state["wormhole"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        WormholeProver(circuit_data=cd, targets=targets).commit(inputs).prove(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            s = by_name.setdefault(e.name, [0.0, 0])
            s[0] += e.time_range.elapsed_us() / 1e6
            s[1] += 1
    if not by_name:
        raise AssertionError("the profiler recorded no device time")
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy,
          "device_idle_share": 1.0 - busy / wall,
          "device_ops": sum(v[1] for v in by_name.values()),
          "leaf_kernel_s": sum(v[0] for k, v in by_name.items()
                               if "poseidon_leaf" in k),
          "top_device_ops": [{"name": k[:100], "s": v[0], "count": v[1]}
                             for k, v in top]})


def phase_k1_time(state) -> None:
    import numpy as np
    import torch

    from zk_circuits_torch.hash import poseidon as plain
    from zk_circuits_torch.hash import poseidon_pallas as pp

    rng = np.random.default_rng(7)
    # the wormhole proof's own shapes: the zk wires commit (135 wires + 4
    # salts) over the LDE, the first FRI fold tree, one PoW sweep
    # (plus the wires commit at twice the LDE: the reference Rust circuit's
    # degree 2^14)
    lde, arity = state["lde_size"], state["fri_arity"]
    shapes = [("wires", lde, 139, "column-major"),
              ("fri_tree", lde // arity, 2 * arity, "row-major"),
              ("grind", GRIND_ROWS, 5, "row-major"),
              ("wires_2x", 2 * lde, 139, "column-major")]
    rows_out = []
    for name, n, cols, layout in shapes:
        x = torch.from_numpy(leaf_matrix(rng, n, cols).view(np.int64)).cuda()
        arg = x.t().contiguous() if layout == "column-major" else x
        fn = (lambda a=arg: pp.hash_values(a)) if layout == "column-major" \
            else (lambda a=arg: pp.hash_leaves(a))
        ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(lambda a=x: plain.batch_hash_no_pad(a), reps=3, warmup=1)
        bound, by = k1_bound_ms(n, cols)
        rows_out.append({"shape": name, "n": n, "cols": cols, "layout": layout,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "share_of_bound": bound / ms})
    emit({"phase": "k1_time", "muls_per_permutation": MULS_PER_PERM,
          "int32_mul_per_s": INT32_MUL_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "shapes": rows_out})
    main = rows_out[0]
    state["kernels"] = [{
        "name": "poseidon_leaf_hash", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": state["k1_launches"],
        "max_abs_err": state["k1_max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None}]


PHASES = {"card": phase_card, "k1_check": phase_k1_check,
          "square": phase_square, "wormhole": phase_wormhole,
          "profile": phase_profile, "k1_time": phase_k1_time}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import zk_circuits_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the zk_circuits_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    state: dict = {}
    for name in PHASES:
        t0 = time.perf_counter()
        try:
            PHASES[name](state)
        except Exception as e:  # any failing phase fails the run
            import traceback

            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e),
                  "s": time.perf_counter() - t0})
            return 1
    print(state["smi"], flush=True)
    emit({"kernels": state["kernels"]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
