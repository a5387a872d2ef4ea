#!/usr/bin/env python3
"""Smoke run of the torch/CUDA port (zk_circuits_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. card     -- the card's name and power limit; build the Poseidon kernel
               (K1), the block exchange (K2) and the witness schedule (K3)
               from csrc/, one nvcc each, all started together, timed.
2. square   -- a one-gate square circuit under both standard configs: the
               proof from device="cuda" must equal the proof from
               device="cpu" byte for byte, and verify.
3. wormhole -- the zk wormhole proof as bench.py proves it (circuit built
               on the card, one cold and three warm proves), verified,
               tamper-checked, and its sha256 held to the digest of the JAX
               package's host-path proof of the same inputs (pinned below).
               K1's launches per proof, by mode (sponge / tree / top), must
               be the count the circuit's trees give; K3's, by kernel, the
               plan's (a walk over each run of levels, an ops launch for
               each wide level, one cells launch), and no host witness.
4. batch    -- the batched prover: prove_batch of B=4 zk wormhole proofs
               (one cold batch, two warm), each proof's sha256 == the pinned
               digest, proof 0 verified and a tampered copy refused; K1's
               launches per batch by mode == those of one proof (tree, top)
               and the PoW sweeps the found witnesses need, K3's == those of
               one proof, no host witness; stage times, the
               second warm batch under torch.profiler and bench.py's JSON
               keys; then the square circuit at B=4 with distinct witnesses
               under a zk config with FRI fold rounds, each proof == a
               sequential prove on the card.
5. witness_check -- K3 against its plain torch version on the card and
               the host witness, equal integers: the zk wormhole's witness
               alone and at B=4 (the golden seeds, and copies with a few
               seeds changed where the host witness still accepts them),
               the circuit of every generator kind at B=3 and a deep
               arith_ext/Poseidon chain at B=2, each whole and one level
               a walk launch against the plain version of that level;
               K3's launches by kernel; then its time (graph_ms) at B=1
               and 4, its launches over three level ranges (the wide
               prefix, the Poseidon-interleaved middle, the arith tail),
               one entry-point call split into its parts, its device
               operations, the plain version's and the host witness's
               time, its byte bound, and its chain cost (the levels at
               the walk's cost of a one-op level and of a one-gate
               Poseidon level, each timed on a chain circuit of such
               levels; the design's candidates are
               scripts/k3_variants.py's).
6. k1_check -- K1 against its plain torch version on the card: the sponge
               at every team size at the edges (n below the team, n not a
               multiple of the block's rows, cols 1 to 139, both layouts)
               and at the main path's widths; hash_tree against the plain
               level loop at the three commit shapes and the FRI trees, for
               one proof and for a batch of B=4; the sharded commit's
               per-shard sponge on every card.
7. profile  -- one more warm wormhole proof under torch.profiler: device
               busy time and idle share, device operations (beside the
               count with the host witness), top kernels, K3's launches.
8. k2_check -- K2 against its plain versions at E = 2, 4, 8 shards on one
               card (and spread over the cards when there are several):
               copy with even and odd block sizes and edge values, and at E=4 every fiber regroup and
               commit re-shard of the sharded phase; dft, twiddle and
               interleave, forward and inverse, at bm = 1 and 2^12 and at
               E=4 at every four-step of the sharded phase.  One launch
               per card and mode; equal integers.
9. sharded  -- the multi-device path on a mesh of E=4 shards, in the order
               of the JAX package's multi-chip dryrun: the batch-sharded
               wires commit (cap == the single-device commit's), the
               sharded FRI commit chain at the production shape (caps,
               betas, final poly == the single-device chain's), the
               four-step NTT, INTT and coset LDE at 2^22 points (== the
               single-device transforms; one dft, twiddle and interleave
               launch per card each, no copy), and prove_sharded of the zk
               wormhole (cold and warm; sha256 == the pinned digest,
               verified, tamper-checked).  K2's launch counter must rise in
               every sub-step, K1's in every sub-step that hashes leaves.
               Then the device operations of one profiled 2^22 four-step,
               fused and as the sequence it replaced (K2 copies with eager
               torch field operations between them), each with its K2
               launches by mode.
10. k1_time -- K1's device time (graph_ms) at the main path's shapes and
               the whole wires tree against the 13 launches of the level
               loop, the B=4 batch's wires and FRI trees, beside the plain
               version and the bound; every team
               size and block size as a candidate, at those shapes and at
               the sharded path's per-shard ones; the permutation's
               multiply and instruction counts from the built library's
               SASS (cuobjdump).  A share of the bound above 1.05 fails.
11. k2_time -- K2's device time (graph_ms) by mode: copy at the
               four-step's 2^22 exchange shape, the wires re-shard and the
               first FRI fiber regroup, beside its plain version, one
               PyTorch call (transpose + contiguous) and its byte bound;
               dft, twiddle and interleave (forward and inverse) at 2^22
               points beside their plain versions and the sequence each
               replaced (a K2 copy and the torch operations it absorbs),
               the forward interleave also beside one PyTorch call (stack
               viewed (E, E, bm), permuted, contiguous; equal to K2's
               result); each with the min and max of its replays and the
               host time per wrapper call; each kernel's instruction,
               load and store counts from the built library's SASS
               (cuobjdump).  A share of the bound above 1.05 fails.
12. aggregate -- the reference's default tree aggregation (b=2, d=3: 8
               leaves) of the wormhole phase's zk proof through the
               port's WormholeProofAggregator on the card: 3 pushes, 5
               dummies (the proof is its own dummy), once cold (3 level
               circuits built) and once warm (the level cache hit).  The
               root's sha256 == the JAX host path's root (pinned below),
               cold == warm, verified, tamper-checked, and its 8 leaves'
               public inputs extract equal to the leaf's.  Every level
               prove (a batch of 4, a batch of 2, one proof) launches K1 by
               mode and K3 by kernel as many times as its level circuit
               gives, with no host witness.  Then the host's part of a
               level-1 prove (the chunk witnesses, seed_batch), one warm
               level-1 prove_level under torch.profiler, and K1 (the
               level-1 wires tree, alone and at B=4) and K3 (the level-1
               witness at B=4, the level-3 witness alone) at the level
               circuits' shapes, each held to its plain version and timed
               as in k1_time and witness_check.
13. voting  -- the vote circuit of tests/test_voting.py under
               standard_recursion_config built and proved on the card (cold
               and warm), sha256 == the JAX host path's (pinned below),
               verified, tamper-checked, K1's and K3's launches as the
               circuit gives, no host witness; a vote with the wrong
               Merkle depth refused by the device witness on the card.
14. api     -- the zk wormhole's common.bin, verifier.bin and prover.bin
               written to a temporary directory; WormholeProver.new_from_files
               proves the golden inputs on the card (sha256 == the pinned
               zk digest) and WormholeVerifier.new_from_files verifies it;
               then api/example.py's main (the non-zk wormhole): its hex
               decodes to a proof with the JAX host path's sha256 (pinned
               below), which a freshly built verifier accepts, whose public
               inputs are the golden fixture's.

The last lines are the card line, the kernels line and
{"ok": true, "device": {...}}.  Needs no network; imports no JAX.
"""

from __future__ import annotations

import contextlib
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
# The same under standard_recursion_config, the proof api/example.py
# writes (tests/test_torch_artifacts.py re-derives it).
GOLDEN_WORMHOLE_SHA256 = (
    "d0ebfeac9197a170ed55a0305c57014b4c262e60eb320418f4b079194cf427b3")
# The vote proof of vote_inputs() under standard_recursion_config from the
# JAX package's host path (tests/test_torch_voting.py re-derives it).
GOLDEN_VOTE_SHA256 = (
    "433bab1c569c31cbea3b9b8264f37e89a880e682c15a1d17fde2aa69af253ac5")
# The root proof of the JAX package's host-path aggregation of the zk
# wormhole proof above: TreeAggregationConfig(2, 3), the proof pushed 3
# times and its own dummy (5 pads).  scripts/golden_digests.py prints it;
# tests/test_torch_wormhole_golden.py re-derives it (slow: minutes).
GOLDEN_AGGREGATE_ZK_SHA256 = (
    "dddb26e8e1c2b44875703e2ed25ce6ecf87a54b2e79b826eda45b2bf29bf0702")

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
# 32-bit multiply instructions per Poseidon permutation, in the cheapest
# formulation K1 runs (csrc/poseidon.cuh): 118 S-boxes (8 full rounds x 12
# + 22 partial) of four 64x64->128 products, each four 32x32->64 partial
# products (IMAD.WIDE.U32, two 32-bit results each) = 8; the MDS layer in
# the frequency domain (poseidon_mds_freq, one thread per row) is shifts
# and adds, no multiply.  (The team form, poseidon_mds_rows, spends 288
# IMAD.WIDE.U32 a layer; the direct circulant, 144 x 2 products a layer,
# would come to 12416.)  k1_time checks this against the SASS.
SBOX_MULS = (8 * 12 + 22) * 4 * 8
MDS_MULS = 0
MULS_PER_PERM = SBOX_MULS + MDS_MULS

K1_SOURCE = "zk_circuits_torch/csrc/poseidon_leaf.cu"
K1_REPLACES = "zk_circuits_tpu/hash/poseidon_pallas.py:164"
K1_TIMED_CALLS = 8     # back-to-back calls per K1 timing (graph_ms)
K2_SOURCE = "zk_circuits_torch/csrc/block_exchange.cu"
K2_REPLACES = "zk_circuits_tpu/parallel/ntt_exchange.py:52"
K3_SOURCE = "zk_circuits_torch/csrc/witness.cu"
K3_REPLACES = "zk_circuits_tpu/iop/witness_device.py:227"
K3_TIMED_CALLS = 4     # back-to-back witnesses per K3 timing (graph_ms)
# 64x64 products an op of each kind (8 32-bit multiplies each, as above):
# arith c0*m0*m1 + c1*ad; arith_ext an extension product (5) and 4 scalings;
# the Fermat inverse 64 squarings and 63 multiplies; ext_inv its norm (3),
# an inverse and 2; a Poseidon gate 4 deltas and 118 S-boxes of 4.
K3_PRODUCTS = {"const": 0, "arith": 3, "arith_ext": 9, "eq_inv": 127, "ext_inv": 132,
               "base_sum": 0, "random_access": 0, "poseidon": 4 + 118 * 4}
K3_CHAIN_DEPTH = 128   # levels of the arith chain circuit that times a narrow level
# a warm wormhole proof's device operations with the host witness (PERF.md)
DEVICE_OPS_BEFORE = 80945
SHARDS = 4             # E of the sharded phase
BATCH = 4              # proofs per prove_batch call (bench.py's ZKT_BENCH_BATCH)
NTT_LOG = 22           # SCALING.md's size of one sharded polynomial
K2_TIMED_CALLS = 32    # back-to-back calls per K2 timing (graph_ms)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def k1_bound_ms(perms: int, nbytes: int) -> tuple[float, str]:
    """The least time for ``perms`` permutations moving ``nbytes``: the
    larger of the multiply bound and the byte bound, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = perms * MULS_PER_PERM / INT32_MUL_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_work(n: int, cols: int, cap_height: int | None = None) -> tuple[int, int]:
    """(permutations, bytes) of hashing n rows of cols felts, each row read
    once and each digest written once; with ``cap_height`` also the tree's
    compress levels up to the cap."""
    perms, nbytes = n * ((cols + 7) // 8), n * cols * 8 + n * 32
    if cap_height is not None:
        inner = n - (1 << cap_height)       # nodes above the leaves
        perms, nbytes = perms + inner, nbytes + inner * 32
    return perms, nbytes


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


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def graph_ms(calls: list, replays: int = 8) -> dict:
    """Milliseconds of device time per call on cuda:0: ``calls`` are N
    closures, each on inputs of its own, captured back to back into one
    CUDA graph with every result kept; the graph's replay is timed with
    CUDA events, after a 256 MB read that empties the 50 MB L2 cache.  So
    each call reads its inputs from HBM, the earlier calls' outputs are
    written back to HBM while later calls run (only the last ~50 MB of N
    outputs may reach HBM after the window), and the host's launch time,
    which exceeds the device's for a copy of tens of MB, is left out.
    Median, min and max of ``replays`` replays after one, over N."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up outside the capture
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [fn() for fn in calls]
    flush = torch.zeros(1 << 25, dtype=torch.int64, device="cuda")
    times = []
    for _ in range(replays + 1):
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    del kept, graph
    return {"ms": statistics.median(times[1:]), "min_ms": min(times[1:]),
            "max_ms": max(times[1:])}


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
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.parallel import exchange_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    state["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""

    def timed(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    poseidon_cuda.write_constants_header(poseidon_cuda.BUILD_DIR)   # K1's and K3's
    with ThreadPoolExecutor(3) as pool:   # one nvcc per source, together
        k1, k2, k3 = pool.map(timed, (poseidon_cuda.build, exchange_cuda.build,
                                      witness_cuda.build))
    ptxas = [ln.strip() for mod in (poseidon_cuda, exchange_cuda, witness_cuda)
             for ln in mod.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "card", "nvidia_smi": state["smi"],
          "name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "k1_build_s": k1, "k2_build_s": k2, "k3_build_s": k3, "ptxas": ptxas})


def wormhole_trees(common) -> list:
    """(name, leaves, cols, layout) of every Merkle tree of one wormhole
    proof: the wires, zs and quotient commits (column-major LDE values, 4
    salt columns each in the zk config) and one FRI tree per fold round
    (row-major fiber leaves of 2 * arity felts)."""
    cfg, lde = common.config, common.lde_size
    salts = 4 if cfg.zero_knowledge else 0
    trees = [("wires", lde, cfg.num_wires + salts, "column-major"),
             ("zs", lde, common.num_zs_partial_products_polys + salts, "column-major"),
             ("quotient", lde, common.num_quotient_polys + salts, "column-major")]
    size = lde
    for r, a_bits in enumerate(cfg.fri_config.reduction_arities(common.degree_bits)):
        size >>= a_bits
        trees.append((f"fri_tree_{r}", size, 2 << a_bits, "row-major"))
    return trees


def expected_k1_launches(common, batch: int = 1) -> dict:
    """K1's launches per proof, or per batch of ``batch`` proofs, by mode:
    one tree launch per tree (a batch's B trees share it), one top launch
    per tree whose blocks' subtrees end below the cap, and the PoW grind's
    sweeps (at least one) in sponge mode."""
    from zk_circuits_torch.hash import poseidon_cuda as pc

    cap = common.config.fri_config.cap_height
    trees = wormhole_trees(common)
    top = sum(bool(pc.tree_plan(n, cap, min(pc.config(batch * n)[1], n))["top_threads"])
              for _, n, _, _ in trees)
    return {"tree": len(trees), "top": top, "sponge_min": 1}


def _as_layout(rows, layout):
    """The (n, cols) or (B, n, cols) view K1 is given: row-major rows, or
    the transpose of a column-major (cols, n) or (B, cols, n) copy."""
    if layout == "row-major":
        return rows
    return rows.transpose(-1, -2).contiguous().transpose(-1, -2)


def phase_k1_check(state) -> None:
    import numpy as np
    import torch

    from zk_circuits_torch.hash import poseidon_cuda as pc

    rng = np.random.default_rng(2026)
    cd = state["wormhole"][0]
    max_err, cases, t0 = 0.0, [], time.perf_counter()

    def compare(got, want, what, canonical=True):
        nonlocal max_err
        a = got.cpu().numpy().view(np.uint64)
        b = want.cpu().numpy().view(np.uint64)
        max_err = max(max_err, float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()))
        if not np.array_equal(a, b):
            raise AssertionError(f"K1 != plain: {what}")
        if canonical and not (a < np.uint64(P)).all():
            raise AssertionError(f"K1 digest not canonical: {what}")

    # the sponge at every team size and block size, at the edges
    edge_cases = [(n, cols) for n in (1, 3, 33, 517)
                  for cols in (1, 5, 8, 9, 16, 32, 135, 139)]
    for n, cols in edge_cases:
        x = torch.from_numpy(leaf_matrix(rng, max(n, 5), cols)[:n].view(np.int64)).cuda()
        want = pc.hash_rows_plain(x)
        for team in pc.TEAMS:
            for rows in (32, 256):
                if -(-rows // (32 // team)) * 32 > pc.max_threads(team):
                    continue
                for layout in ("row-major", "column-major"):
                    compare(pc.hash_rows(_as_layout(x, layout), team, rows), want,
                            f"sponge team={team} rows={rows} n={n} cols={cols} {layout}")
    cases.append(f"sponge: every team {list(pc.TEAMS)} x rows (32, 256) x both layouts "
                 f"at {len(edge_cases)} (n, cols) edge cases")
    # the sponge at the PoW sweep's shape and a ragged one, the configured
    # team (the trees below cover the commits' widths)
    for n, cols in ((GRIND_ROWS, 5), (GRIND_ROWS - 37, 24)):
        x = torch.from_numpy(leaf_matrix(rng, n, cols).view(np.int64)).cuda()
        want = pc.hash_rows_plain(x)
        for layout in ("row-major", "column-major"):
            compare(pc.hash_rows(_as_layout(x, layout)), want,
                    f"sponge n={n} cols={cols} {layout}")
        cases.append(f"sponge {n} x {cols}, both layouts")
    def check_tree(name, x, layout, c, want):
        got = pc.hash_tree(_as_layout(x, layout), c)
        if len(got) != len(want):
            raise AssertionError(f"hash_tree {name}: {len(got)} levels, want {len(want)}")
        for lvl, (g, w) in enumerate(zip(got, want)):
            # narrow leaves are their own digests (hash_or_noop), edge values and all
            compare(g, w, f"hash_tree {name} level {lvl}", canonical=lvl > 0 or x.shape[-1] > 4)
        cases.append(f"hash_tree {name}: {x.shape[-2]} x {x.shape[-1]} {layout}, "
                     f"cap height {c}")

    # hash_tree at every tree of the wormhole proof, for one proof and for a
    # batch of BATCH proofs (one tree launch and at most one top launch for
    # all of them), against one plain run over the batch (proof 0's
    # matrix is the single tree's)
    cap = cd.common.config.fri_config.cap_height
    for name, n, cols, layout in wormhole_trees(cd.common):
        x = torch.from_numpy(np.stack([leaf_matrix(rng, n, cols) for _ in range(BATCH)])
                             .view(np.int64)).cuda()
        want = pc.hash_tree_plain(x, cap)
        check_tree(name, x[0], layout, cap, [w[0] for w in want])
        before = dict(pc.launches_by_mode)
        check_tree(f"B={BATCH} x {name}", x, layout, cap, want)
        if pc.launches_by_mode["tree"] - before["tree"] != 1 or \
                pc.launches_by_mode["top"] - before["top"] > 1:
            raise AssertionError(f"batched hash_tree {name}: not one tree launch")
    # small trees at every cap height
    for n, cols, layout in ((256, 8, "row-major"), (1024, 139, "column-major"),
                            (64, 3, "row-major")):
        x = torch.from_numpy(leaf_matrix(rng, n, cols).view(np.int64)).cuda()
        for c in (0, 2, 4):
            check_tree(f"small {n} x {cols} cap {c}", x, layout, c, pc.hash_tree_plain(x, c))
    # every card, at a sharded commit's per-shard shape (one thread a row,
    # above 48 KB of shared memory: an opt-in that holds card by card)
    n, cols = cd.common.lde_size // SHARDS, cd.common.config.num_wires + 4
    x = leaf_matrix(rng, n, cols).view(np.int64)
    for i in range(torch.cuda.device_count()):
        xi = torch.from_numpy(x).to(torch.device("cuda", i))
        compare(pc.hash_rows(_as_layout(xi, "column-major")), pc.hash_rows_plain(xi),
                f"sponge {n} x {cols} on cuda:{i}")
        cases.append(f"sponge {n} x {cols} column-major on cuda:{i}")
    _sync_all()
    state["k1_max_abs_err"] = max_err
    emit({"phase": "k1_check", "cases": cases, "equal": True,
          "max_abs_err": max_err, "s": time.perf_counter() - t0})


def k2_bound_ms(nbytes: int, muls: int = 0) -> tuple[float, str]:
    """The least time for K2 moving ``nbytes`` (each element read once and
    written once, all shards on one card) and doing ``muls`` 32-bit
    multiplies: the larger of the two, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def k2_fused_work(mode: str, n: int, e: int, inverse: bool) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one fused K2 call over n points on E
    shards: every element read and written once, plus twiddle's tables
    (E x (L + m/L) values); 8 multiplies a 64x64 product: twiddle 2 an
    element, the inverse interleave 1, dft none (shifts)."""
    from zk_circuits_torch.parallel import exchange_cuda

    nbytes, muls = 2 * 8 * n, 0
    if mode == "twiddle":
        split, table = exchange_cuda._twiddle_tables(n, e, inverse, "cpu")
        nbytes += 8 * table.numel()
        muls = 2 * 8 * n
    elif mode == "interleave" and inverse:
        muls = 8 * n
    return nbytes, muls


def _blocks(x):
    """Contiguous (E, B) blocks, as the four-step hands them to K2."""
    return x


def _fibers(x):
    """A FRI fiber regroup's source, as fri_sharded.fiber_leaves_sharded
    builds it: (arity/E, E, 2m/E) -> the strided (E, arity/E, 2m/E) view."""
    return x.permute(1, 0, 2)


def _reshard(x):
    """A commit's poly->row re-shard source, as prover_sharded.rows_from_polys
    builds it: (k/E, L) LDE values -> the strided (E, k/E, L/E) view."""
    kps, lde = x.shape
    return x.reshape(kps, SHARDS, lde // SHARDS).permute(1, 0, 2)


def _four_step_sizes(common) -> list:
    """(name, n) of every four-step the sharded phase runs: 2^22 points,
    the quotient's coset INTT and each FRI round's coset NTT."""
    cfg, lde = common.config, common.lde_size
    sizes, size = [("four-step 2^22", 1 << NTT_LOG), ("quotient INTT four-step", lde)], lde
    for r, a_bits in enumerate(cfg.fri_config.reduction_arities(common.degree_bits)):
        sizes.append((f"FRI round {r} four-step", size))
        size >>= a_bits
    return sizes


def _k2_cases(e: int, common=None) -> list:
    """(name, per-shard base shape, view) of K2's copy check cases at E
    shards: contiguous (E, B) blocks with B even and odd; and, given the
    wormhole's ``common`` (E = SHARDS), every copy the sharded phase gives
    K2, built as the path builds it: each FRI round's fiber regroup and
    each commit's re-shard."""
    cases = [(f"B={b}", (e, b), _blocks) for b in (1 << 16, (1 << 16) + 1, 7)]
    if common is None:
        return cases
    cfg, lde = common.config, common.lde_size
    size = lde
    for r, a_bits in enumerate(cfg.fri_config.reduction_arities(common.degree_bits)):
        arity, m = 1 << a_bits, size >> a_bits
        cases.append((f"FRI round {r} fiber regroup", (arity // e, e, 2 * m // e), _fibers))
        size = m
    salts = 4 if cfg.zero_knowledge else 0
    for name, k in (("constants/sigmas", common.num_constants_sigmas_polys),
                    ("wires", cfg.num_wires + salts),
                    ("zs/partial products", common.num_zs_partial_products_polys + salts),
                    ("quotient", common.num_quotient_polys + salts)):
        cases.append((f"{name} re-shard", (-(-k // e), lde), _reshard))
    return cases


def _fused_calls(xs_blocks, xs_rows, n, inverse):
    """(mode, kernel call, plain call) of K2's three fused modes on the
    same shards: (E, bm) blocks for dft and twiddle, (m,) rows for
    interleave."""
    from zk_circuits_torch.parallel import exchange_cuda as xc

    return (("dft", lambda: xc.exchange_dft(xs_blocks, inverse),
             lambda: xc.dft_plain(xs_blocks, inverse)),
            ("twiddle", lambda: xc.exchange_twiddle(xs_blocks, n, inverse),
             lambda: xc.twiddle_plain(xs_blocks, n, inverse)),
            ("interleave", lambda: xc.exchange_interleave(xs_rows, inverse),
             lambda: xc.interleave_plain(xs_rows, inverse)))


def phase_k2_check(state) -> None:
    import numpy as np
    import torch

    from zk_circuits_torch.parallel import exchange_cuda

    rng = np.random.default_rng(2027)
    edge = np.array([0, 1, P - 1, 2**64 - 1], dtype=np.uint64)
    common = state["wormhole"][0].common
    count = torch.cuda.device_count()
    layouts = [("one card", lambda e: [torch.device("cuda", 0)] * e)]
    if count >= 2:
        layouts.append(("spread", lambda e: [torch.device("cuda", i % count)
                                             for i in range(e)]))
    max_err, cases = 0.0, []
    t0 = time.perf_counter()

    def compare(got, want, what, devices):
        nonlocal max_err
        for d in set(devices):
            torch.cuda.synchronize(d)
        for g, w in zip(got, want, strict=True):
            a = g.cpu().numpy().view(np.uint64).astype(np.float64)
            b = w.cpu().numpy().view(np.uint64).astype(np.float64)
            max_err = max(max_err, float(np.abs(a - b).max()))
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"K2 != plain ({what})")
        cases.append(what)

    def launched(mode, before, devices, what):
        got = exchange_cuda.launches_by_mode[mode] - before
        if got != len(set(devices)):
            raise AssertionError(f"K2 {what}: {got} {mode} launches, want one per card")

    for layout, devices_of in layouts:
        for e in (2, 4, 8):
            devices = devices_of(e)
            # copy: edge values in every row
            for name, shape, view in _k2_cases(e, common if e == SHARDS else None):
                host = rng.integers(0, 2**64 - 1, (e, *shape), dtype=np.uint64)
                host[..., : min(shape[-1], 4)] = edge[: min(shape[-1], 4)]   # every row
                xs = [view(torch.from_numpy(host[s].view(np.int64)).to(d))
                      for s, d in enumerate(devices)]
                want = exchange_cuda.exchange_plain(xs)
                what = f"{layout}: E={e} copy {name} {list(xs[0].shape)}"
                before = exchange_cuda.launches_by_mode["copy"]
                got = exchange_cuda.exchange(xs)
                launched("copy", before, devices, what)
                compare(got, want, what, devices)
                if view is _blocks and not np.array_equal(
                        np.stack([g.cpu().numpy() for g in got]).view(np.uint64),
                        np.swapaxes(host, 0, 1)):
                    raise AssertionError(f"K2 is not the block transpose ({what})")
            # the fused modes, forward and inverse: bm = 1 and 2^12, and at
            # E = SHARDS every four-step of the sharded phase
            sizes = [(f"bm={bm}", e * e * bm) for bm in (1, 1 << 12)]
            if e == SHARDS:
                sizes += _four_step_sizes(common)
            for name, n in sizes:
                m = n // e
                host = rng.integers(0, P, (e, m), dtype=np.uint64)
                host[:, : min(m, 4)] = np.array([0, 1, P - 2, P - 1],
                                                dtype=np.uint64)[: min(m, 4)]
                rows = [torch.from_numpy(host[s].view(np.int64)).to(d)
                        for s, d in enumerate(devices)]
                blocks = [r.reshape(e, m // e) for r in rows]
                for inverse in (False, True):
                    for mode, run, plain in _fused_calls(blocks, rows, n, inverse):
                        what = (f"{layout}: E={e} {mode}{' inverse' if inverse else ''} "
                                f"{name} n={n}")
                        before = exchange_cuda.launches_by_mode[mode]
                        got = run()
                        launched(mode, before, devices, what)
                        compare(got, plain(), what, devices)
    state["k2_max_abs_err"] = max_err
    emit({"phase": "k2_check", "cases": cases, "equal": True,
          "max_abs_err": max_err, "s": time.perf_counter() - t0})


def _square_circuit(cfg, device):
    """The one-gate square circuit and a maker of its witnesses."""
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness

    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))

    def witness(v):
        pw = PartialWitness()
        pw.set_target(x, v)
        return pw

    return b.build(device=device), witness


def kinds_circuit(b, generator_op) -> list:
    """Give the CircuitBuilder ``b`` (of either package; ``generator_op``
    its GeneratorOp) one generator of every kind the witness schedule
    has: const, arith, base_sum, poseidon and eq_inv (a square, a range
    check, an equality, a hash), arith_ext and random_access, and ext_inv,
    which only the recursion gadgets emit, appended as they append it.
    Returns the targets to seed, in the order of KINDS_SEEDS' values."""
    x = b.add_virtual_target()
    y = b.mul(x, x)
    b.range_check(y, 32)
    eq = b.is_equal(x, y)
    b.hash_n_to_hash_no_pad([x, y, eq.target])
    b.register_public_input(y)
    a, c = b.add_virtual_target(), b.add_virtual_target()
    o = b.arithmetic_extension(3, 5, (a, c), (c, a), (a, a))
    o2 = b.arithmetic_extension(1, 1, o, (a, c), o)
    inv = (b.add_virtual_target(), b.add_virtual_target())
    b.generators.append(generator_op("ext_inv", inputs=tuple(o2), outputs=inv))
    idx = b.add_virtual_target()
    vals = [b.add_virtual_target() for _ in range(4)]
    b.register_public_input(b.random_access(idx, vals))
    b.register_public_inputs(list(o2) + list(inv))
    return [x, a, c, idx, *vals]


# Seed values of kinds_circuit: x (its square below 2^32), the extension
# pair, the index and the 4-element list; x = 0 takes eq_inv's inverse(0).
KINDS_SEEDS = ((7, 9, 100, 2, 200, 300, 400, 500), (0, 1, 2, 0, 3, 4, 5, 6),
               (65535, P - 1, P - 2, 3, P - 1, 1, 0, P - 3))


def chain_circuit(b) -> list:
    """A deep schedule: five alternating arith_ext and Poseidon levels,
    then eight dependent arith_ext levels (tests/test_witness_device.py's
    scan-segment circuit).  Returns the two targets to seed."""
    a, c = b.add_virtual_target(), b.add_virtual_target()
    h = [a, c] + [b.zero()] * 10
    for k in range(5):
        e = b.arithmetic_extension(1 + k, 7, (h[0], h[1]), (h[2], h[3]), (h[4], h[5]))
        h = b.permute_poseidon([e[0], e[1]] + h[2:])
    o = (h[0], h[1])
    for k in range(8):
        o = b.arithmetic_extension(2 + k, 3 + k, o, (h[2], h[3]), o)
    b.register_public_inputs(list(o))
    b.register_public_inputs(h[:4])
    return [a, c]


def vote_inputs():
    """The vote of tests/test_voting.py::create_test_inputs (a depth-2
    tree of four keys, the first one voting yes on proposal 42), made with
    the port's modules."""
    import numpy as np

    from zk_circuits_torch.circuits.voting import (
        VoteCircuitData, VotePrivateInputs, VotePublicInputs, compute_nullifier)
    from zk_circuits_torch.host import poseidon as hposeidon
    from zk_circuits_torch.utils import codecs

    keys = [bytes([i] * 32) for i in (1, 2, 3, 4)]
    leaves = [hposeidon.hash_no_pad(codecs.digest_bytes_to_felts(k)) for k in keys]
    level1 = [hposeidon.hash_no_pad(np.concatenate([leaves[0], leaves[1]])),
              hposeidon.hash_no_pad(np.concatenate([leaves[2], leaves[3]]))]
    root = hposeidon.hash_no_pad(np.concatenate([level1[0], level1[1]]))
    voter_key = codecs.digest_bytes_to_felts(keys[0])
    proposal_id = codecs.digest_bytes_to_felts(bytes([42] * 32))
    return VoteCircuitData(
        VotePublicInputs(proposal_id, root, True, compute_nullifier(voter_key, proposal_id)),
        VotePrivateInputs(voter_key, [leaves[1], level1[1]], [False, False], 2))


def seed(witness_cls, targets, values):
    """A PartialWitness (of ``witness_cls``) setting ``targets`` to ``values``."""
    pw = witness_cls()
    for t, v in zip(targets, values, strict=True):
        pw.set_target(t, v)
    return pw


def _square_proof(cfg, device):
    data, witness = _square_circuit(cfg, device)
    return data, data.prove(witness(3), device=device)


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
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils import profiling
    from zk_circuits_torch.utils.serialization import proof_to_bytes

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
    with host_witness_calls() as host_witnesses:
        poseidon_cuda.reset_launches()      # main path starts here
        witness_cuda.reset_launches()
        proof, cold_s = one_proof(prover)
        per_proof = poseidon_cuda.launches
        by_mode = dict(poseidon_cuda.launches_by_mode)
        k3_per_proof = dict(witness_cuda.launches_by_kernel)
        warm = []
        for _ in range(3):
            proof_w, dt = one_proof(WormholeProver(circuit_data=cd, targets=targets))
            warm.append(dt)
        launches = poseidon_cuda.launches   # main path ends here
        k3_launches = witness_cuda.launches
    if per_proof <= 0 or launches != 4 * per_proof:
        raise AssertionError(f"K1 launches: {per_proof} per proof, {launches} in all")
    want = expected_k1_launches(cd.common)
    if (by_mode["tree"], by_mode["top"]) != (want["tree"], want["top"]) or \
            by_mode["sponge"] < want["sponge_min"]:
        raise AssertionError(f"K1 launches per proof by mode {by_mode}, want {want}")
    k3_want = expected_k3_launches(cd)
    if k3_per_proof != k3_want or k3_launches != 4 * sum(k3_want.values()) or host_witnesses:
        raise AssertionError(f"K3 launches {k3_per_proof} per proof ({k3_launches} in all), "
                             f"want {k3_want}; {len(host_witnesses)} host witnesses")

    data = proof_to_bytes(proof)
    if proof_to_bytes(proof_w) != data:
        raise AssertionError("warm proof bytes differ from the cold proof")
    digest = hashlib.sha256(data).hexdigest()
    if digest != GOLDEN_WORMHOLE_ZK_SHA256:
        raise AssertionError(f"wormhole proof sha256 {digest} != pinned "
                             f"{GOLDEN_WORMHOLE_ZK_SHA256}")
    cd.verify(proof)
    _refuses_tampering(cd, proof)
    state["wormhole"] = (cd, targets, inputs)
    state["wormhole_proof"] = proof
    state["wormhole_warm_proofs_per_s"] = 1.0 / statistics.median(warm)
    state["lde_size"] = cd.common.lde_size
    state["fri_arity"] = 1 << cfg.fri_config.reduction_arity_bits
    state["k1_launches"] = launches
    state["k1_launches_per_proof"] = per_proof
    state["k1_launches_by_mode"] = dict(poseidon_cuda.launches_by_mode)
    state["k3_launches"] = k3_launches
    state["k3_launches_by_kernel"] = dict(witness_cuda.launches_by_kernel)
    timings = {k: statistics.median(v) for k, v in profiling.get_timings().items()}
    emit({"phase": "wormhole", "config": "standard_recursion_zk_config",
          "degree_bits": cd.common.degree_bits, "proof_bytes": len(data),
          "sha256": digest, "golden": True, "verified": True,
          "tamper_rejected": True, "build_s": build_s, "cold_s": cold_s,
          "warm_s": warm, "warm_proofs_per_s": 1.0 / statistics.median(warm),
          "k1_launches_per_proof": per_proof, "k1_launches_per_proof_by_mode": by_mode,
          "k1_launches_per_proof_expected": want, "k1_launches": launches,
          "k1_launches_by_mode": state["k1_launches_by_mode"],
          "k3_launches_per_proof_by_kernel": k3_per_proof, "k3_launches": k3_launches,
          "host_witnesses": len(host_witnesses), "stage_median_s": timings})


@contextlib.contextmanager
def host_witness_calls():
    """A list that grows by one for every host witness the prover makes
    (plonk/prover_batch.py's generate_witness) inside the block."""
    from zk_circuits_torch.plonk import prover_batch

    real, calls = prover_batch.generate_witness, []

    def counted(*args):
        calls.append(1)
        return real(*args)

    prover_batch.generate_witness = counted
    try:
        yield calls
    finally:
        prover_batch.generate_witness = real


def expected_k3_launches(cd) -> dict:
    """K3's launches a witness, or a batch of witnesses, by kernel: an ops
    launch for each level of more than WIDE_OPS ops, a walk over each run
    of levels between them, and one for the cells."""
    from zk_circuits_torch.iop import witness_cuda

    sch = cd.prover_only.schedule
    kernels = [k for k, _, _ in witness_cuda.plan(
        [(b.kind, len(b.data["out_reps"])) for b in sch], 0, len(sch))]
    return {"walk": kernels.count("walk"), "ops": kernels.count("ops"), "cells": 1}


def profiled(fn) -> tuple:
    """Run ``fn`` under torch.profiler, tracing the card only (host
    operations are not recorded: they would double the wall time and the
    trace's processing); returns fn's result and its wall time, device
    busy time (CUDA kernels and copies), idle share, device operations,
    the time of the port's own kernels and the top kernels by time.  The
    profiler's raw events are read, without building its event tree."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync_all()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and \
                not getattr(e, "is_hidden_event", lambda: False)():
            s = by_name.setdefault(e.name(), [0.0, 0])
            s[0] += e.duration_ns() / 1e9
            s[1] += 1
    if not by_name:
        raise AssertionError("the profiler recorded no device time")
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return out, {
        "wall_s": wall, "trace_read_s": time.perf_counter() - t1, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "device_ops": sum(v[1] for v in by_name.values()),
        "leaf_kernel_s": sum(v[0] for k, v in by_name.items() if "k1_" in k),
        "exchange_kernel_s": sum(v[0] for k, v in by_name.items()
                                 if "block_exchange" in k),
        "top_device_ops": [{"name": k[:100], "s": v[0], "count": v[1]}
                           for k, v in top]}


def _refuses_tampering(cd, proof) -> None:
    """A bit flipped in the wires cap's first element must fail to verify."""
    from zk_circuits_torch.utils.serialization import proof_from_bytes, proof_to_bytes

    bad = bytearray(proof_to_bytes(proof))
    bad[16 + 8 * len(proof.public_inputs)] ^= 1
    try:
        cd.verify(proof_from_bytes(bytes(bad), cd.common))
    except ValueError:
        return
    raise AssertionError("a tampered proof was accepted")


# FRI fold rounds on the square circuit (arity 4 down to 2 coefficients,
# few queries and PoW bits), as tests/test_torch_batch.py proves it: with
# distinct witnesses, the batched commit chain, betas, folds and fold-tree
# gathers of every proof are its own.
SQUARE_FRI_ROUNDS = dict(proof_of_work_bits=2, num_query_rounds=3,
                         reduction_arity_bits=2, final_poly_bits=1)


def phase_batch(state) -> None:
    """The batched prover at B=BATCH (see the module doc)."""
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils import profiling
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cd, targets, inputs = state["wormhole"]
    t_phase = time.perf_counter()

    def witnesses():
        return [WormholeProver(circuit_data=cd, targets=targets).commit(inputs)
                .partial_witness for _ in range(BATCH)]

    want = expected_k1_launches(cd.common, BATCH)
    k3_want = expected_k3_launches(cd)
    profiling.reset_timings()
    poseidon_cuda.reset_launches()      # the batch path starts here
    witness_cuda.reset_launches()
    batch_s, per_batch, k3_per_batch, prof = [], [], [], None
    for i in range(3):                  # one cold batch, two warm
        pws = witnesses()
        before = dict(poseidon_cuda.launches_by_mode)
        k3_before = dict(witness_cuda.launches_by_kernel)
        with host_witness_calls() as host_witnesses:
            if i < 2:
                proofs, dt = _synced(lambda: prove_batch(cd, pws))
                batch_s.append(dt)
                timings = {k: list(v) for k, v in profiling.get_timings().items()}
            else:                       # the last warm batch under the profiler
                proofs, prof = profiled(lambda: prove_batch(cd, pws))
        modes = {k: v - before[k] for k, v in poseidon_cuda.launches_by_mode.items()}
        sweeps = max(p.proof.opening_proof.pow_witness for p in proofs) // GRIND_ROWS + 1
        if (modes["tree"], modes["top"], modes["sponge"]) != (want["tree"], want["top"], sweeps):
            raise AssertionError(f"K1 launches per batch by mode {modes}, want {want} "
                                 f"and {sweeps} sweeps")
        per_batch.append(modes)
        k3 = {k: v - k3_before[k] for k, v in witness_cuda.launches_by_kernel.items()}
        if k3 != k3_want or host_witnesses:
            raise AssertionError(f"K3 launches per batch {k3}, want {k3_want}; "
                                 f"{len(host_witnesses)} host witnesses")
        k3_per_batch.append(k3)
        digests = [hashlib.sha256(proof_to_bytes(p)).hexdigest() for p in proofs]
        if len(proofs) != BATCH or set(digests) != {GOLDEN_WORMHOLE_ZK_SHA256}:
            raise AssertionError(f"batched wormhole sha256s {digests} != pinned "
                                 f"{GOLDEN_WORMHOLE_ZK_SHA256}")
    launches = poseidon_cuda.launches   # the batch path ends here
    state["k1_launches_batch"] = launches
    state["k3_launches_batch"] = witness_cuda.launches
    t_verify = time.perf_counter()
    cd.verify(proofs[0])
    _refuses_tampering(cd, proofs[0])
    verify_s = time.perf_counter() - t_verify
    # stage times of the two batches outside the profiler
    stages = {k: statistics.median(v) for k, v in timings.items()}
    warm_s = batch_s[1]
    single = state["wormhole_warm_proofs_per_s"]
    emit({"metric": "wormhole_prove_warm_batched", "value": BATCH / warm_s,
          "unit": "proofs/s/chip", "single_proofs_per_s": single, "batch_size": BATCH})
    wormhole_s = time.perf_counter() - t_phase

    # the square circuit with distinct witnesses, zk, with FRI fold rounds
    # (the standard configs' square proofs are below the first fold; they
    # and this one are held to the JAX package's proofs on the CPU,
    # tests/test_torch_batch*.py)
    values = (3, 7, 11, 255)
    data, witness = _square_circuit(
        CircuitConfig(zero_knowledge=True, fri_config=FriConfig(**SQUARE_FRI_ROUNDS)), "cuda")
    got, dt = _synced(lambda: prove_batch(data, [witness(v) for v in values]))
    rounds = len(got[0].proof.opening_proof.commit_phase_caps)
    if rounds < 1:
        raise AssertionError("square: the config made no FRI fold round")
    sequential_s = []
    for v, proof in zip(values, got):
        seq, secs = _synced(lambda: data.prove(witness(v)))
        sequential_s.append(secs)
        if proof_to_bytes(proof) != proof_to_bytes(seq):
            raise AssertionError(f"square: batched proof of {v} != sequential")
    if len({proof_to_bytes(p) for p in got}) != len(values):
        raise AssertionError("square: distinct witnesses gave equal proofs")
    data.verify(got[-1])
    square = {"config": {"zero_knowledge": True, **SQUARE_FRI_ROUNDS},
              "witnesses": list(values), "fri_rounds": rounds,
              "bytes_equal_sequential": True, "batch_s": dt, "sequential_s": sequential_s}
    emit({"phase": "batch", "batch_size": BATCH, "config": "standard_recursion_zk_config",
          "sha256": GOLDEN_WORMHOLE_ZK_SHA256, "golden": True, "verified": True,
          "tamper_rejected": True, "cold_batch_s": batch_s[0], "warm_batch_s": warm_s,
          "warm_proofs_per_s": BATCH / warm_s,
          "single_proofs_per_s": single, "k1_launches_per_batch_by_mode": per_batch,
          "k1_launches_per_batch_expected": want, "k1_launches": launches,
          "k3_launches_per_batch_by_kernel": k3_per_batch,
          "k3_launches": state["k3_launches_batch"], "host_witnesses": 0,
          "device_ops_before": DEVICE_OPS_BEFORE,
          "stage_median_s": stages, "stage_s": timings, "profile_warm_batch": prof,
          "square": square, "wormhole_part_s": wormhole_s, "verify_and_tamper_s": verify_s,
          "square_part_s": time.perf_counter() - t_phase - wormhole_s})


def varied_witnesses(cd, pw, count: int, changes: int = 4) -> tuple[list, list]:
    """``pw`` and ``count`` - 1 copies of it, each with ``changes`` seed
    values changed: seeded targets alone in their rep that no generator
    sets, tried in turn, a change kept where the host witness still
    accepts the copy (it refuses one that breaks an equality the circuit
    wires in).  The proofs would not verify, which a check of the witness
    does not need.  Returns the witnesses and, for each copy, the reps
    whose seeds it changed."""
    import numpy as np

    from zk_circuits_torch.iop.witness import PartialWitness, WitnessConflict, generate_witness

    po = cd.prover_only
    produced = set(np.concatenate([np.ravel(b.data["out_reps"]) for b in po.schedule]).tolist())
    reps = [po.rep_of_target[t] for t in pw.values]
    free = sorted(t for t, r in zip(pw.values, reps)
                  if r not in produced and reps.count(r) == 1)
    rng = np.random.default_rng(5)
    pws, changed = [pw], []
    for k in range(1, count):
        copy, picked = PartialWitness(), []
        copy.values = dict(pw.values)
        for t in free[k::max(1, len(free) // 64)]:
            old = copy.values[t]
            copy.values[t] = int(rng.integers(0, P, dtype=np.uint64))
            try:
                generate_witness(cd, copy)
            except WitnessConflict:
                copy.values[t] = old
                continue
            picked.append(po.rep_of_target[t])
            if len(picked) == changes:
                break
        if len(picked) < changes:
            raise AssertionError(f"only {len(picked)} seeds of copy {k} could change")
        pws.append(copy)
        changed.append(picked)
    return pws, changed


def k3_work(table, batch: int) -> tuple[int, int]:
    """(64x64 products, bytes) of the witnesses of ``batch`` proofs over
    the circuit's WitnessTable: the products of every op (K3_PRODUCTS);
    the bytes of the table as K3 reads it, the seeded value tables (B, R),
    and the wire matrices and public inputs written, each once."""
    products = sum(K3_PRODUCTS[st.kind] * st.m for st in table.steps) * batch
    read = sum(t.numel() for st in table.steps for t in (st.ins, st.outs, st.consts, st.rows))
    read += table.cell_pos.numel() + table.cell_rep.numel() + table.pi_reps.numel()
    out = batch * (table.num_wires * table.n + table.pi_reps.numel())
    return products, 8 * (read + batch * table.num_reps + out)


def k3_bound_ms(products: int, nbytes: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * 8 / INT32_MUL_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_ranges(cd) -> list:
    """(name, first, last) of three spans of the schedule's levels: the
    wide prefix (through the last level of more than WIDE_OPS ops and the
    Poseidon levels right after it), the Poseidon-interleaved middle
    (through the last Poseidon level) and the chain of arith levels after
    that."""
    from zk_circuits_torch.iop.witness_cuda import WIDE_OPS

    sch = cd.prover_only.schedule
    kinds = [b.kind for b in sch]
    a = max(i for i, b in enumerate(sch) if len(b.data["out_reps"]) > WIDE_OPS) + 1
    while a < len(kinds) and kinds[a] == "poseidon":
        a += 1
    z = max(i for i, k in enumerate(kinds) if k == "poseidon") + 1
    return [("wide_prefix", 0, a), ("poseidon_middle", a, z), ("arith_tail", z, len(kinds))]


def k3_chain_ms(cd, ms_per_level: dict) -> tuple[float, int, int]:
    """The chain cost of ``cd``'s schedule: its levels at the walk's cost
    of a one-op arith level and of a one-gate Poseidon level
    (``ms_per_level``, from witness_check's chain circuits); with the
    number of levels and of Poseidon levels."""
    kinds = [b.kind for b in cd.prover_only.schedule]
    n_pos = kinds.count("poseidon")
    ms = (len(kinds) - n_pos) * ms_per_level["arith"] + n_pos * ms_per_level["poseidon"]
    return ms, len(kinds), n_pos


def arith_chain_circuit(b, depth: int) -> list:
    """``depth`` dependent arith levels of one op each (a chain of
    squarings).  Returns the target to seed."""
    x = b.add_virtual_target()
    y = x
    for _ in range(depth):
        y = b.mul(y, y)
    b.register_public_input(y)
    return [x]


def poseidon_chain_circuit(b, depth: int) -> list:
    """``depth`` dependent Poseidon levels of one gate each.  Returns the
    two targets to seed."""
    a, c = b.add_virtual_target(), b.add_virtual_target()
    h = [a, c] + [b.zero()] * 10
    for _ in range(depth):
        h = b.permute_poseidon(h)
    b.register_public_inputs(h[:4])
    return [a, c]


def k3_call(table, values, first=0, last=None, cells=True, lib=None):
    """One K3 run over ``values`` (levels [first, last), then the cells),
    uncounted, on the current stream (a graph's capture stream inside
    graph_ms), through ``lib`` (default: the built witness.cu).  Returns
    the wire matrix (B, W, n) and the public inputs."""
    import torch

    from zk_circuits_torch.iop import witness_cuda

    b = values.shape[0]
    wires = torch.zeros((b, table.num_wires, table.n), dtype=torch.int64, device=values.device)
    pis = torch.empty((b, table.pi_reps.numel()), dtype=torch.int64, device=values.device)
    done = witness_cuda.launch_schedule(lib or witness_cuda._lib(), table, values, wires, pis,
                                        torch.cuda.current_stream().cuda_stream, first, last,
                                        cells)
    if any(err for _, err in done):
        raise RuntimeError(f"K3 launch failed: {done}")
    return wires, pis


def phase_witness_check(state) -> None:
    """K3 against its plain version on the card and the host witness, as
    integers: the full-width wormhole alone and at B=BATCH (the golden
    witness and copies with changed seeds), the circuit of every
    generator kind at B=3 and the deep arith_ext/Poseidon chain at B=2,
    each whole and one level a launch; then K3's time (graph_ms), its
    level ranges, the entry point's parts, the plain version's and the
    host witness's time, K3's bound, and the schedule's levels at this
    design's per-level cost on chain circuits."""
    import numpy as np
    import torch

    from zk_circuits_torch.iop import builder as t_builder
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev
    from zk_circuits_torch.iop.witness import PartialWitness, generate_witness
    from zk_circuits_torch.plonk.config import CircuitConfig

    cd, targets, inputs = state["wormhole"]
    from zk_circuits_torch.api.prover import WormholeProver

    golden = WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness
    pws, changed = varied_witnesses(cd, golden, BATCH)
    lib = witness_cuda._lib()

    def by_level(table, seeded, what):
        """K3 one level a launch (the walk, or a wide level's ops launch)
        on the values the levels before it left, against the plain version
        of that level (the value table and a Poseidon level's trace
        columns)."""
        values, want_v = seeded.clone(), seeded.clone()
        b, n = values.shape[0], table.n
        wires = torch.zeros((b, table.num_wires * n), dtype=torch.int64, device="cuda")
        want_w = wires.clone()
        pis = torch.empty((b, table.pi_reps.numel()), dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for i, st in enumerate(table.steps):
            out = wdev._step_plain(st, want_v, want_w, n).reshape(b, -1)
            want_v[:, st.outs.reshape(-1)] = out
            done = witness_cuda.launch_schedule(lib, table, values, wires, pis, stream, i, i + 1,
                                                cells=False)
            kernel = "ops" if st.m > witness_cuda.WIDE_OPS and st.kind != "poseidon" else "walk"
            if done != [(kernel, 0)] or not (torch.equal(values, want_v)
                                             and torch.equal(wires, want_w)):
                raise AssertionError(f"{what}: the walk differs from the plain version at "
                                     f"level {i} ({st.kind}, {st.m} ops): {done}")

    def check(data, pws, what):
        """K3, its plain version on the card and the host witness of each
        of ``pws``, whole and level by level; returns the plain version's
        CUDA-event ms."""
        table = wdev.device_table(data, "cuda")
        seed_reps, seeds = wdev.seed_batch(data, pws)
        before = dict(witness_cuda.launches_by_kernel)
        wires, pis = witness_cuda.run_schedule(table, table.seeded_values(seed_reps, seeds))
        if {k: v - before[k] for k, v in witness_cuda.launches_by_kernel.items()} != \
                expected_k3_launches(data):
            raise AssertionError(f"{what}: K3 launches {witness_cuda.launches_by_kernel}")
        values = table.seeded_values(seed_reps, seeds)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plain_w, plain_p = wdev.witness_plain(table, values)
        b.record()
        b.synchronize()
        if not (torch.equal(wires, plain_w) and torch.equal(pis, plain_p)):
            bad = int((wires != plain_w).sum())
            raise AssertionError(f"{what}: K3 differs from the plain version ({bad} cells)")
        by_level(table, table.seeded_values(seed_reps, seeds), what)
        for i, pw in enumerate(pws):
            host_w, host_p = generate_witness(data, pw)
            if not (np.array_equal(wires[i].cpu().numpy().view(np.uint64), host_w.T)
                    and np.array_equal(pis[i].cpu().numpy().view(np.uint64), host_p)):
                raise AssertionError(f"{what}: K3's witness {i} differs from the host's")
        if len({w.cpu().numpy().tobytes() for w in wires}) != len(pws):
            raise AssertionError(f"{what}: distinct seeds gave equal wire matrices")
        return a.elapsed_time(b)

    cases = {"wormhole": check(cd, pws[:1], "wormhole"),
             f"wormhole_b{BATCH}": check(cd, pws, f"wormhole B={BATCH}")}
    for name, circuit, seeds in (
            ("kinds", lambda b: kinds_circuit(b, t_builder.GeneratorOp), KINDS_SEEDS),
            ("chain", chain_circuit, ((12345, 67890), (1, P - 1)))):
        b = t_builder.CircuitBuilder(CircuitConfig.standard_recursion_config())
        small_targets = circuit(b)
        small = b.build(device="cuda")
        cases[name] = check(small, [seed(PartialWitness, small_targets, v) for v in seeds],
                            name)

    # time: K3 alone (graph_ms of K3_TIMED_CALLS witnesses, each on a
    # value table of its own), its level ranges, one entry-point call and
    # its parts, the host witness, device operations (the design's
    # candidates are timed by scripts/k3_variants.py)
    table = wdev.device_table(cd, "cuda")
    rows, ranges = {}, []

    def timed(batch, **kw):
        tables = [table.seeded_values(*wdev.seed_batch(cd, pws[:batch]))
                  for _ in range(K3_TIMED_CALLS)]
        return graph_ms([lambda v=v: k3_call(table, v, **kw) for v in tables])

    for batch in (1, BATCH):
        seed_reps, seeds = wdev.seed_batch(cd, pws[:batch])
        tables = [table.seeded_values(seed_reps, seeds) for _ in range(K3_TIMED_CALLS)]
        g = graph_ms([lambda v=v: witness_cuda.run_schedule(table, v) for v in tables])
        call_ms = cuda_ms(lambda: wdev.generate_witnesses_device(cd, pws[:batch], "cuda"), 10)
        seed_s = []
        for _ in range(10):
            t = time.perf_counter()
            wdev.seed_batch(cd, pws[:batch])
            seed_s.append(time.perf_counter() - t)
        seeded_ms = cuda_ms(lambda: table.seeded_values(seed_reps, seeds), 10)
        pool = [table.seeded_values(seed_reps, seeds) for _ in range(12)]
        run_ms = cuda_ms(lambda: witness_cuda.run_schedule(table, pool.pop()), 10)
        _, prof = profiled(lambda: wdev.generate_witnesses_device(cd, pws[:batch], "cuda"))
        work = k3_work(table, batch)
        bound, by = k3_bound_ms(*work)
        rows[batch] = {"batch": batch, "ms": g["ms"], "min_ms": g["min_ms"],
                       "max_ms": g["max_ms"], "call_ms": call_ms,
                       "call_parts_ms": {"seed_batch": statistics.median(seed_s) * 1e3,
                                         "seeded_values": seeded_ms, "run_schedule": run_ms},
                       "plain_ms": cases["wormhole" if batch == 1 else f"wormhole_b{BATCH}"],
                       "products": work[0], "bytes": work[1],
                       "bound_ms": bound, "bound_by": by, "share_of_bound": bound / g["ms"],
                       "device_ops": prof["device_ops"],
                       "device_busy_ms": prof["device_busy_s"] * 1e3}
        for name, first, last in k3_ranges(cd):
            r = timed(batch, first=first, last=last, cells=False)
            ranges.append({"batch": batch, "range": name, "levels": [first, last], **r})

    # the chain cost: the schedule's levels at this design's cost of a
    # one-op arith level and of a one-gate Poseidon level, each timed over
    # a chain circuit of such levels (B=1); not a bound, since it is the
    # walk's own per-level cost
    chain_cost = {}
    for kind, circuit, nseeds in (("arith", arith_chain_circuit, 1),
                                  ("poseidon", poseidon_chain_circuit, 2)):
        depth = K3_CHAIN_DEPTH if kind == "arith" else 24
        b = t_builder.CircuitBuilder(CircuitConfig.standard_recursion_config())
        chain_targets = circuit(b, depth)
        chain = b.build(device="cuda")
        # (the public inputs' hash adds a Poseidon level after the chain)
        levels = [i for i, st in enumerate(chain.prover_only.schedule) if st.kind == kind]
        if len(levels) < depth or levels[-1] - levels[0] + 1 != len(levels) or \
                any(np.asarray(chain.prover_only.schedule[i].data["out_reps"]).shape[0] != 1
                    for i in levels):
            raise AssertionError(f"{kind} chain: levels {levels} are not a run of one op each")
        chain_table = wdev.device_table(chain, "cuda")
        chain_pw = seed(PartialWitness, chain_targets, (3, 5)[:nseeds])
        chain_vals = [chain_table.seeded_values(*wdev.seed_batch(chain, [chain_pw]))
                      for _ in range(K3_TIMED_CALLS)]
        g = graph_ms([lambda v=v: k3_call(chain_table, v, levels[0], levels[-1] + 1, False)
                      for v in chain_vals])
        chain_cost[kind] = {"levels": len(levels), "ms": g["ms"],
                            "ms_per_level": g["ms"] / len(levels)}
    state["k3_ms_per_level"] = {k: v["ms_per_level"] for k, v in chain_cost.items()}
    chain_ms, levels, n_pos = k3_chain_ms(cd, state["k3_ms_per_level"])
    for r in rows.values():
        r["chain_cost_ms"] = chain_ms
        r["share_of_chain_cost"] = chain_ms / r["ms"]

    host_s = []
    for _ in range(3):
        t = time.perf_counter()
        generate_witness(cd, golden)
        host_s.append(time.perf_counter() - t)
    emit({"phase": "witness_check", "equal_integers": True, "by_level": True,
          "cases_plain_ms": cases, "batch_changed_seed_reps": changed,
          "wide_ops": witness_cuda.WIDE_OPS,
          "timing": f"ms: CUDA events around the replay of a CUDA graph of {K3_TIMED_CALLS} "
                    f"witnesses on value tables of their own, L2 emptied first, per "
                    f"witness, median of 8 replays (min_ms/max_ms: their range), the same "
                    f"for the ranges and the chain circuits; "
                    f"call_ms: CUDA events around one generate_witnesses_device call, "
                    f"median of 10, and its parts: seed_batch (perf_counter), "
                    f"seeded_values and run_schedule (CUDA events), median of 10 each; "
                    f"plain_ms: CUDA events around one witness_plain call; "
                    f"host_witness_s: perf_counter around generate_witness",
          "rows": list(rows.values()), "ranges": ranges,
          "chain_cost": {"ms": chain_ms, "levels": levels, "poseidon_levels": n_pos,
                         **{f"{k}_chain": v for k, v in chain_cost.items()}},
          "host_witness_s": statistics.median(host_s)})
    if any(r["share_of_bound"] > 1.05 for r in rows.values()):
        raise AssertionError(f"K3 timed below its bound: {rows}")
    main = rows[1]
    state.setdefault("kernels", []).append({
        "name": "witness_schedule", "route": "cuda", "source": K3_SOURCE,
        "replaces": K3_REPLACES + " (_witness_body, an XLA program; no Pallas kernel)",
        "launches": state["k3_launches"], "launches_by_kernel": state["k3_launches_by_kernel"],
        "launches_by_path": {"wormhole": state["k3_launches"],
                             "batch": state["k3_launches_batch"]},
        "max_abs_err": 0, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "ms_batch": rows[BATCH]["ms"], "chain_cost_ms": chain_ms,
        "host_witness_ms": statistics.median(host_s) * 1e3})


def phase_profile(state) -> None:
    """One more warm wormhole proof under torch.profiler (``profiled``)."""
    from zk_circuits_torch.api.prover import WormholeProver

    from zk_circuits_torch.iop import witness_cuda

    cd, targets, inputs = state["wormhole"]
    before = witness_cuda.launches
    _, prof = profiled(lambda: WormholeProver(circuit_data=cd, targets=targets)
                       .commit(inputs).prove(device="cuda"))
    emit({"phase": "profile", **prof, "device_ops_before": DEVICE_OPS_BEFORE,
          "k3_launches": witness_cuda.launches - before})


def _synced(fn):
    """Run ``fn`` and return (result, seconds) on the host clock, ending in
    a synchronise of every card."""
    t = time.perf_counter()
    out = fn()
    _sync_all()
    return out, time.perf_counter() - t


def phase_sharded(state) -> None:
    """The multi-device path at full width on E=4 shards (see the module
    doc).  Every sub-step is held to the single-device result."""
    import numpy as np
    import torch

    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.fri.fri_device import commit_phase
    from zk_circuits_torch.fri.fri_sharded import fri_commit_sharded
    from zk_circuits_torch.fri.oracle import _device_commit_fn
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.hash.challenger import Challenger
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.parallel import exchange_cuda, mesh as meshm
    from zk_circuits_torch.parallel.ntt_exchange import (intt_sharded_pallas,
                                                         ntt_sharded_pallas)
    from zk_circuits_torch.parallel.ntt_sharded import coset_lde_sharded
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.plonk.prover_sharded import commit_sharded, prove_sharded
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cfg = CircuitConfig.standard_recursion_zk_config()
    cd, targets, inputs = state["wormhole"]
    fri = cfg.fri_config
    mesh = meshm.make_mesh(SHARDS)
    rng = np.random.default_rng(2028)
    cuda = torch.device("cuda", 0)
    out = {"phase": "sharded", "shards": SHARDS,
           "mesh": [str(d) for d in mesh.devices]}
    steps = {}

    def sub_step(step, fn, hashes=True):
        """Run a sub-step; K2 must launch in it, and K1 too if it hashes
        leaves."""
        k1_before, k2_before = poseidon_cuda.launches, exchange_cuda.launches
        by_mode = dict(exchange_cuda.launches_by_mode)
        res, secs = _synced(fn)
        k1 = poseidon_cuda.launches - k1_before
        k2 = exchange_cuda.launches - k2_before
        if k2 <= 0 or (hashes and k1 <= 0):
            raise AssertionError(f"sharded/{step}: {k2} K2 and {k1} K1 launches")
        steps[step] = {"s": secs, "k2_launches": k2, "k1_launches": k1,
                       "k2_launches_by_mode": {k: v - by_mode[k] for k, v in
                                               exchange_cuda.launches_by_mode.items()}}
        return res

    n = cd.common.degree
    k = cfg.num_wires + 4
    coeffs = gf.from_u64(rng.integers(0, P, (k, n), dtype=np.uint64), cuda)
    kps = -(-k // SHARDS)
    padded = torch.cat([coeffs, torch.zeros((kps * SHARDS - k, n), dtype=torch.int64,
                                            device=cuda)])
    fri_coeffs = rng.integers(0, P, (n, 2), dtype=np.uint64)
    x = gf.from_u64(rng.integers(0, P, 1 << NTT_LOG, dtype=np.uint64), cuda)

    def single_chain():
        c0, c1 = gf.ext_pair(fri_coeffs, cuda)
        caps1, _, betas1, f0, f1 = commit_phase(c0[None], c1[None], fri,
                                               cd.common.degree_bits, [Challenger()])
        return [c[0] for c in caps1], [b[0] for b in betas1], gf.to_ext(f0[0], f1[0])

    # The single-device results each sub-step is held to, computed before
    # the path's launch counts start (each run once untimed, for its
    # per-shape tables, then timed).
    singles = {}
    for name, fn in (
            ("lde_commit", lambda: _device_commit_fn(coeffs, cfg.rate_bits,
                                                     fri.cap_height)[1][-1]),
            ("fri_commit", single_chain),
            ("ntt", lambda: nttm.ntt(x)), ("intt", lambda: nttm.intt(x)),
            ("coset_lde", lambda: nttm.lde(x[: 1 << (NTT_LOG - 3)], 3))):
        _synced(fn)
        singles[name] = _synced(fn)

    poseidon_cuda.reset_launches()      # main path starts here
    exchange_cuda.reset_launches()
    # each sub-step runs twice and the second run is timed
    # 1. batch-sharded LDE commit at the wormhole wires shape
    for _ in range(2):
        got = sub_step("lde_commit", lambda: commit_sharded(
            meshm.shard_batch(padded, mesh), k, cfg.rate_bits, fri.cap_height, mesh))
    # 2. the FRI commit chain at the production shape
    for _ in range(2):
        caps, betas, final = sub_step("fri_commit", lambda: fri_commit_sharded(
            fri_coeffs, cd.common.degree_bits, fri, Challenger(), mesh))
    # 3. four-step NTT, INTT and coset LDE at 2^22 points
    transforms = {}
    for name, fn in (
            ("ntt", lambda: ntt_sharded_pallas(meshm.shard_last(x, mesh), mesh)),
            ("intt", lambda: intt_sharded_pallas(meshm.shard_last(x, mesh), mesh)),
            ("coset_lde", lambda: coset_lde_sharded(
                meshm.shard_last(x[: 1 << (NTT_LOG - 3)], mesh), 3, mesh))):
        for _ in range(2):
            transforms[name] = sub_step(name, fn, hashes=False)
    # 4. prove_sharded of the zk wormhole, one cold proof and one warm
    proofs = []
    for name in ("prove_cold", "prove_warm"):
        pw = WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness
        proofs.append(sub_step(name, lambda: prove_sharded(cd, pw, mesh)))
    launches = exchange_cuda.launches   # main path ends here
    launches_by_mode = dict(exchange_cuda.launches_by_mode)
    k1_launches = poseidon_cuda.launches
    cards = len(set(mesh.devices))
    for name in ("ntt", "intt", "coset_lde"):   # no torch field op between exchanges
        if steps[name]["k2_launches_by_mode"] != {"copy": 0, "dft": cards,
                                                  "twiddle": cards, "interleave": cards}:
            raise AssertionError(f"sharded/{name}: K2 launches by mode "
                                 f"{steps[name]['k2_launches_by_mode']}, want one "
                                 "dft, twiddle and interleave per card")

    levels_top, single_s = singles["lde_commit"]
    if not np.array_equal(got.cap, gf.to_u64(levels_top)):
        raise AssertionError("sharded LDE commit cap != single-device cap")
    steps["lde_commit"].update(shape=[k, n << cfg.rate_bits], single_s=single_s)
    (caps1, betas1, final1), single_s = singles["fri_commit"]
    if len(caps) != len(caps1) or not all(
            np.array_equal(a, b) for a, b in zip(caps + betas, caps1 + betas1)):
        raise AssertionError("sharded FRI caps/betas != single-device chain")
    if not np.array_equal(final, final1):
        raise AssertionError("sharded FRI final poly != single-device chain")
    steps["fri_commit"].update(rounds=len(caps), single_s=single_s)
    for name, shards in transforms.items():
        want, single_s = singles[name]
        if not torch.equal(meshm.gather(shards), want):
            raise AssertionError(f"sharded {name} != single-device {name}")
        steps[name].update(points=1 << NTT_LOG, single_s=single_s)
    pw = WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness
    _, out["profile_warm_proof"] = profiled(lambda: prove_sharded(cd, pw, mesh))
    # device operations of one 2^22 four-step, fused and as the parent ran
    # it (K2 copies with eager torch field operations between them), each
    # with its K2 launches by mode
    xs = meshm.shard_last(x, mesh)
    ops, want_modes = {}, {"fused": {"copy": 0, "dft": cards, "twiddle": cards,
                                     "interleave": cards},
                           "parent_sequence": {"copy": 3 * cards, "dft": 0, "twiddle": 0,
                                               "interleave": 0}}
    for name, fn in (("fused", lambda: ntt_sharded_pallas(xs, mesh)),
                     ("parent_sequence", lambda: four_step_unfused(xs, mesh, False))):
        fn()
        before = dict(exchange_cuda.launches_by_mode)
        got4, ops[name] = profiled(fn)
        modes = {k: v - before[k] for k, v in exchange_cuda.launches_by_mode.items()}
        if modes != want_modes[name]:
            raise AssertionError(f"the {name} four-step launched K2 {modes}, want "
                                 f"{want_modes[name]}")
        ops[name]["k2_launches_by_mode"] = modes
        if not torch.equal(meshm.gather(got4), singles["ntt"][0]):
            raise AssertionError(f"the {name} four-step != the single-device NTT")
    out["four_step_device_ops"] = {k: v["device_ops"] for k, v in ops.items()}
    out["four_step_device_ops"]["shed"] = ops["parent_sequence"]["device_ops"] - \
        ops["fused"]["device_ops"]
    out["four_step_profiles"] = {k: {kk: v[kk] for kk in (
        "wall_s", "device_busy_s", "device_ops", "exchange_kernel_s", "k2_launches_by_mode")}
        for k, v in ops.items()}
    if ops["fused"]["device_ops"] >= ops["parent_sequence"]["device_ops"]:
        raise AssertionError(f"the fused four-step ran {out['four_step_device_ops']}")
    data = proof_to_bytes(proofs[0])
    if proof_to_bytes(proofs[1]) != data:
        raise AssertionError("warm sharded proof bytes differ from the cold proof")
    digest = hashlib.sha256(data).hexdigest()
    if digest != GOLDEN_WORMHOLE_ZK_SHA256:
        raise AssertionError(f"sharded wormhole sha256 {digest} != pinned "
                             f"{GOLDEN_WORMHOLE_ZK_SHA256}")
    cd.verify(proofs[0])
    _refuses_tampering(cd, proofs[0])
    state["k2_launches"] = launches
    state["k2_launches_by_mode"] = launches_by_mode
    state["k1_launches_sharded"] = k1_launches
    out.update(steps=steps, sha256=digest, golden=True, verified=True,
               tamper_rejected=True, k2_launches=launches,
               k2_launches_per_proof=steps["prove_warm"]["k2_launches"],
               k2_launches_per_four_step=steps["ntt"]["k2_launches"],
               k2_launches_by_mode=launches_by_mode,
               k2_launches_by_mode_per_proof=steps["prove_warm"]["k2_launches_by_mode"],
               k1_launches=k1_launches,
               k1_launches_per_proof=steps["prove_warm"]["k1_launches"],
               cold_proof_s=steps["prove_cold"]["s"],
               warm_proof_s=steps["prove_warm"]["s"],
               ntt_ms=steps["ntt"]["s"] * 1e3)
    emit(out)


def four_step_unfused(xs, mesh, inverse):
    """The four-step as the port ran it before K2's fused modes: a K2 copy
    for each exchange, the DFT, twiddle, reversal, interleave and n^-1 as
    eager torch field operations between them (the plain versions' local
    parts)."""
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.parallel import exchange_cuda as xc

    e = mesh.size
    m = xs[0].numel()
    n = e * m
    y_t = [xc.dft_local(r, inverse) for r in xc.exchange([x.reshape(e, m // e) for x in xs])]
    z = [xc.twiddle_local(r, d, n, inverse) for d, r in enumerate(xc.exchange(y_t))]
    big = [xc.interleave_in(nttm.ntt(v), e, inverse) for v in z]
    return [xc.interleave_out(r, n, inverse) for r in xc.exchange(big)]


def sass_functions(text: str) -> dict:
    """cuobjdump -sass text -> {function: [(address, opcode), ...]}."""
    import re

    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def k1_sass_counts() -> dict:
    """Per permutation of each sponge kernel k1_sponge_kernel<T>, from the
    SASS of the built library: its three round loops (4 full, 22 partial,
    4 full rounds, one round per iteration) are the first three innermost
    loops of the kernel that hold IMAD.WIDE; a row's permutation is T x
    (4 x the first + 22 x the second + 4 x the third), T threads a row.  32-bit multiplies: IMAD.WIDE
    counts 2 (a 64-bit result), IMAD and IMAD.HI 1; IMAD.MOV, .SHL, .IADD
    and .X are moves, shifts and adds on the multiply unit, counted apart."""
    from zk_circuits_torch.hash import poseidon_cuda

    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(poseidon_cuda.build())],
                          capture_output=True, text=True, timeout=120).stdout
    return sass_round_counts(text)


def k2_sass_counts() -> dict:
    """Per kernel of K2's built library (cuobjdump -sass): its instruction
    count and its global loads and stores by opcode (width)."""
    import collections

    from zk_circuits_torch.parallel import exchange_cuda

    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(exchange_cuda.build())],
                          capture_output=True, text=True, timeout=120).stdout
    out = {}
    for name, ins in sass_functions(text).items():
        ops = collections.Counter(op for _, op, _ in ins)
        out[name] = {"instructions": len(ins),
                     **{k: v for k, v in sorted(ops.items()) if k.startswith(("LDG", "STG"))}}
    if not out:
        raise AssertionError("no K2 function in the SASS")
    return out


def sass_round_counts(text: str) -> dict:
    """k1_sass_counts on the text of cuobjdump -sass."""
    import collections
    import re

    out = {}
    for name, ins in sass_functions(text).items():
        m = re.match(r"_Z\d+k1_sponge_kernelILi(\d+)E", name)
        if not m:
            continue
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        inner = sorted(lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops))
        bodies = []
        for lo, hi in inner:
            h = collections.Counter(op for a, op, _ in ins if lo <= a <= hi)
            if sum(v for k, v in h.items() if k.startswith("IMAD.WIDE")) >= 8:
                bodies.append(h)
        if len(bodies) < 3:
            raise AssertionError(f"{name}: {len(bodies)} round loops found in the SASS")
        team = int(m.group(1))          # a row's permutation: all T threads of its team
        per_perm = collections.Counter()
        for h, times in zip(bodies[:3], (4, 22, 4)):
            for k, v in h.items():
                per_perm[k] += v * times * team
        muls = sum(v * (2 if k.startswith("IMAD.WIDE") else 1) for k, v in per_perm.items()
                   if k.startswith(("IMAD.WIDE", "IMAD.HI")) or k in ("IMAD", "IMAD.U32"))
        other_imad = sum(v for k, v in per_perm.items()
                         if k.startswith("IMAD") and not k.startswith(("IMAD.WIDE", "IMAD.HI"))
                         and k not in ("IMAD", "IMAD.U32"))
        out[f"team {team}"] = {
            "mul32_per_perm": muls, "imad_wide_per_perm": sum(
                v for k, v in per_perm.items() if k.startswith("IMAD.WIDE")),
            "imad_mov_shl_iadd_x_per_perm": other_imad,
            "shfl_per_perm": sum(v for k, v in per_perm.items() if k.startswith("SHFL")),
            "instructions_per_perm": sum(per_perm.values()),
            "round_loop_instructions": [sum(h.values()) for h in bodies[:3]],
            "top_ops": per_perm.most_common(8)}
    return out


def k1_inputs(gen, n, cols, layout, count, batch=None) -> list:
    """``count`` (n, cols) views of their own, each made on the card from
    the generator ``gen``; (batch, n, cols) views of a batch of proofs'
    matrices."""
    import torch

    lead = () if batch is None else (batch,)
    shape = (*lead, cols, n) if layout == "column-major" else (*lead, n, cols)
    xs = [torch.randint(0, P >> 1, shape, generator=gen, dtype=torch.int64,
                        device="cuda") for _ in range(count)]
    return [x.transpose(-1, -2) if layout == "column-major" else x for x in xs]


def k1_row(gen, name, n, cols, layout, fn, plain, work, plain_ms=None, batch=None) -> dict:
    """K1's timing row of ``fn`` at one shape: graph_ms over K1_TIMED_CALLS
    inputs, one wrapper call, one call of the plain version, the bound of
    ``work`` (permutations, bytes) and the share of it."""
    from zk_circuits_torch.hash import poseidon_cuda as pc

    xs = k1_inputs(gen, n, cols, layout, K1_TIMED_CALLS, batch)
    g = graph_ms([lambda x=x: fn(x) for x in xs])
    call_ms = cuda_ms(lambda: fn(xs[0]), reps=10)
    if plain_ms is None:
        plain_ms = cuda_ms(lambda: plain(xs[0]), reps=1, warmup=0)
    bound, by = k1_bound_ms(*work)
    team, rows = pc.config((batch or 1) * n)
    return {"shape": name, "n": n, "cols": cols, "layout": layout, "batch": batch or 1,
            "team_rows": [team, min(rows, n)], "ms": g["ms"], "min_ms": g["min_ms"],
            "max_ms": g["max_ms"], "call_ms": call_ms, "plain_ms": plain_ms,
            "perms": work[0], "bytes": work[1], "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / g["ms"]}


def phase_k1_time(state) -> None:
    import torch

    from zk_circuits_torch.hash import poseidon_cuda as pc

    gen = torch.Generator(device="cuda").manual_seed(7)
    cd = state["wormhole"][0]
    cap = cd.common.config.fri_config.cap_height
    trees = {name: (n, cols, layout) for name, n, cols, layout in wormhole_trees(cd.common)}

    shapes = [(name, *trees[name]) for name in ("wires", "zs", "quotient", "fri_tree_0",
                                                "fri_tree_1")]
    shapes += [("grind", GRIND_ROWS, 5, "row-major"),
               ("compress_2^15", 1 << 15, 8, "row-major")]
    rows_out = [k1_row(gen, name, n, cols, layout, pc.hash_rows, pc.hash_rows_plain,
                    k1_work(n, cols)) for name, n, cols, layout in shapes]

    # the whole wires tree: hash_tree (2 launches) against the level loop of
    # earlier PRs (13 launches: leaves, then one compress launch a level)
    n, cols, layout = trees["wires"]

    def level_loop(x):
        levels = [pc.hash_rows(x)]
        while levels[-1].shape[0] > (1 << cap):
            levels.append(pc.hash_rows(levels[-1].reshape(-1, 8)))
        return levels

    rows_out.append(k1_row(gen, "wires_tree", n, cols, layout, lambda x: pc.hash_tree(x, cap),
                        lambda x: pc.hash_tree_plain(x, cap), k1_work(n, cols, cap)))
    rows_out.append(k1_row(gen, "wires_tree_level_loop", n, cols, layout, level_loop, None,
                        k1_work(n, cols, cap), plain_ms=rows_out[-1]["plain_ms"]))
    # the trees of a batch of BATCH proofs, one launch (and a top launch)
    # for all of them; the bound is BATCH times one tree's
    for name in ("wires", "fri_tree_0", "fri_tree_1"):
        n, cols, layout = trees[name]
        rows_out.append(k1_row(gen, f"{name}_tree_batch", n, cols, layout,
                            lambda x: pc.hash_tree(x, cap), lambda x: pc.hash_tree_plain(x, cap),
                            tuple(BATCH * v for v in k1_work(n, cols, cap)), batch=BATCH))
    over = [r for r in rows_out if r["share_of_bound"] > 1.05]
    if over:
        raise AssertionError(f"K1 timed below its bound: {over}")

    # every team size and block size (graph_ms) at the sponge shapes, and
    # at the sharded path's per-shard shapes (E=SHARDS): a commit's leaves,
    # its first compress level and the first FRI tree's leaves
    n, cols, _ = trees["wires"]
    fri_n, fri_cols, _ = trees["fri_tree_0"]
    sharded_shapes = [("shard_wires", n // SHARDS, cols, "column-major"),
                      ("shard_compress", n // SHARDS // 2, 8, "row-major"),
                      ("shard_fri_tree_0", fri_n // SHARDS, fri_cols, "row-major")]
    candidates = {}
    for name, n, cols, layout in shapes + sharded_shapes:
        xs = k1_inputs(gen, n, cols, layout, 4)
        got = {}
        for team in pc.TEAMS:
            for rows in (32, 64, 128, 256):
                if -(-rows // (32 // team)) * 32 > pc.max_threads(team):
                    continue
                got[f"T={team} rows={rows}"] = graph_ms(
                    [lambda x=x: pc.hash_rows(x, team, rows) for x in xs], replays=3)["ms"]
        candidates[f"{name} {n} x {cols}"] = dict(sorted(got.items(), key=lambda kv: kv[1]))
    sass = k1_sass_counts()
    emit({"phase": "k1_time", "muls_per_permutation": MULS_PER_PERM,
          "int32_mul_per_s": INT32_MUL_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "timing": f"ms: CUDA events around the replay of a CUDA graph of "
                    f"{K1_TIMED_CALLS} calls on inputs of their own, L2 emptied "
                    f"first, per call, median of 8 replays (min_ms/max_ms: their "
                    f"range); call_ms: CUDA events around one wrapper call; "
                    f"plain_ms: one call of the plain version",
          "shapes": rows_out, "candidates_ms": candidates, "sass": sass})
    main = next(r for r in rows_out if r["shape"] == "wires_tree")   # the main path's launch
    state.setdefault("kernels", []).insert(0, {
        "name": "poseidon_leaf_hash", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": state["k1_launches"],
        "launches_by_path": {"wormhole": state["k1_launches"],
                             "batch": state["k1_launches_batch"],
                             "sharded": state["k1_launches_sharded"]},
        "launches_by_mode": state["k1_launches_by_mode"],
        "max_abs_err": state["k1_max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None})


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host microseconds a wrapper call: perf_counter around ``calls``
    calls (warmed, the card synchronised before and after)."""
    fn()
    _sync_all()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    _sync_all()
    return us


def library_fields(k2: dict, lib: dict) -> dict:
    """The library call's graph_ms beside K2's: its ms and range, the ratio,
    and whether the two ranges overlap."""
    return {"library_ms": lib["ms"], "library_min_ms": lib["min_ms"],
            "library_max_ms": lib["max_ms"], "k2_over_library": k2["ms"] / lib["ms"],
            "spreads_overlap": k2["min_ms"] <= lib["max_ms"] and lib["min_ms"] <= k2["max_ms"]}


def phase_k2_time(state) -> None:
    import numpy as np
    import torch

    from zk_circuits_torch.parallel import exchange_cuda as xc

    rng = np.random.default_rng(9)
    e = SHARDS
    common = state["wormhole"][0].common
    kps = -(-(common.config.num_wires + 4) // e)     # the zk wires commit
    arity = 1 << common.config.fri_config.reduction_arities(common.degree_bits)[0]
    m0 = common.lde_size // arity
    copies = (("four_step_2^22", (e, (1 << NTT_LOG) // e // e), _blocks),
              ("wires_reshard", (kps, common.lde_size), _reshard),
              ("fri_fiber_regroup", (arity // e, e, 2 * m0 // e), _fibers))
    rows_out = []
    for name, shape, view in copies:    # all shards on cuda:0
        host = rng.integers(0, P, (e, *shape), dtype=np.uint64).view(np.int64)
        base = [torch.from_numpy(host[s]).cuda() for s in range(e)]
        # K2_TIMED_CALLS input sets of their own (see graph_ms)
        sets = [[view(b.clone()) for b in base] for _ in range(K2_TIMED_CALLS)]
        per_shard = list(sets[0][0].shape)
        nbytes = 2 * e * sets[0][0].numel() * 8     # the global (E, E, ...) tensor, in and out
        bound, by = k2_bound_ms(nbytes)
        plain = graph_ms([lambda xs=xs: xc.exchange_plain(xs) for xs in sets])
        stacked = [torch.stack(xs) for xs in sets]
        lib = graph_ms([lambda t=t: t.transpose(0, 1).contiguous() for t in stacked])
        del stacked
        k2 = graph_ms([lambda xs=xs: xc.exchange(xs) for xs in sets])
        rows_out.append({
            "mode": "copy", "shape": name, "per_shard": per_shard, "shards": e,
            "bytes": nbytes, "ms": k2["ms"], "min_ms": k2["min_ms"], "max_ms": k2["max_ms"],
            "host_us_per_call": host_us_per_call(lambda: xc.exchange(sets[0])),
            "plain_ms": plain["ms"], **library_fields(k2, lib),
            "bound_ms": bound, "bound_by": by, "share_of_bound": bound / k2["ms"]})
        del sets
    # the fused modes at 2^22 points: kernel, plain version and the
    # sequence before (a K2 copy and the torch operations the mode absorbs)
    n = 1 << NTT_LOG
    m = n // e
    host = rng.integers(0, P, (e, m), dtype=np.uint64).view(np.int64)
    base = [torch.from_numpy(host[s]).cuda() for s in range(e)]
    sets = [[b.clone() for b in base] for _ in range(K2_TIMED_CALLS)]
    blocks = [[r.reshape(e, m // e) for r in xs] for xs in sets]
    before_of = {
        "dft": lambda inv: lambda: [xc.dft_local(r, inv) for r in xc.exchange(blocks[0])],
        "twiddle": lambda inv: lambda: [xc.twiddle_local(r, d, n, inv)
                                        for d, r in enumerate(xc.exchange(blocks[0]))],
        "interleave": lambda inv: lambda: [
            xc.interleave_out(r, n, inv)
            for r in xc.exchange([xc.interleave_in(z, e, inv) for z in sets[0]])]}
    for mode, inverse in (("dft", False), ("twiddle", False), ("interleave", False),
                          ("interleave", True)):
        calls = [dict((c[0], c[1]) for c in _fused_calls(b, xs, n, inverse))[mode]
                 for b, xs in zip(blocks, sets)]
        plain = dict((c[0], c[2]) for c in _fused_calls(blocks[0], sets[0], n, inverse))[mode]
        k2 = graph_ms(calls)
        nbytes, muls = k2_fused_work(mode, n, e, inverse)
        bound, by = k2_bound_ms(nbytes, muls)
        library = {"library_ms": None}
        if mode == "interleave" and not inverse:
            # one PyTorch call computes the forward interleave on one card:
            # out_d[i E + t1] = z_t1[d bm + i] is (t1, d, i) -> (d, i, t1)
            stacked = [torch.stack(xs) for xs in sets]

            def lib_call(t):
                return t.view(e, e, m // e).permute(1, 2, 0).contiguous()

            got = torch.stack(calls[0]())
            if not torch.equal(got, lib_call(stacked[0]).view(e, m)):
                raise AssertionError("the forward interleave != its PyTorch call")
            library = library_fields(k2, graph_ms([lambda t=t: lib_call(t) for t in stacked]))
            del stacked, got
        rows_out.append({
            "mode": mode, "inverse": inverse, "shape": f"four_step_2^{NTT_LOG}",
            "per_shard": [m], "shards": e, "bytes": nbytes, "muls32": muls,
            "ms": k2["ms"], "min_ms": k2["min_ms"], "max_ms": k2["max_ms"],
            "host_us_per_call": host_us_per_call(calls[0]),
            "plain_ms": cuda_ms(plain, reps=5), "before_ms": cuda_ms(before_of[mode](inverse), reps=5),
            **library, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / k2["ms"]})
    del sets, blocks
    emit({"phase": "k2_time", "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "int32_mul_per_s": INT32_MUL_PER_S,
          "timing": f"ms, library_ms and the copy's plain_ms: CUDA events around "
                    f"the replay of a CUDA graph of {K2_TIMED_CALLS} calls on inputs "
                    f"of their own, L2 emptied first, per call, median of 8 replays "
                    f"(min_ms/max_ms and library_min_ms/library_max_ms: their "
                    f"range); the fused modes' plain_ms and "
                    f"before_ms: CUDA events around one call, median of 5 (the "
                    f"launch gaps of eager torch included); host_us_per_call: "
                    f"perf_counter around 100 wrapper calls",
          "rows": rows_out, "sass": k2_sass_counts()})
    over = [r for r in rows_out if r["share_of_bound"] > 1.05]
    if over:
        raise AssertionError(f"K2 timed below its bound: {over}")
    main = next(r for r in rows_out if r["mode"] == "copy" and r["shape"] == "wires_reshard")
    state.setdefault("kernels", []).append({
        "name": "block_exchange", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": state["k2_launches"],
        "launches_by_mode": state["k2_launches_by_mode"],
        "launches_by_path": {"sharded": state["k2_launches"]},
        "max_abs_err": state["k2_max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "ms_by_mode": {f"{r['mode']}{' inverse' if r.get('inverse') else ''} {r['shape']}":
                       r["ms"] for r in rows_out}})


AGG_CONFIG = (2, 3)     # the aggregate phase's tree: the reference's default, 8 leaves
AGG_PUSHES = 3          # proofs pushed; aggregate() pads the rest with the dummy


@contextlib.contextmanager
def level_prove_records():
    """Inside the block, LevelCircuit.prove_level and prove_chunk append
    to the yielded list one entry a level prove: the level circuit, its
    inputs, its proofs' count, host seconds (synced), K1's launches by
    mode and K3's by kernel in the call, the host witnesses made and the
    PoW sweeps its proofs' witnesses need."""
    from zk_circuits_torch.aggregation import tree as treem
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda

    records: list = []

    def counted(real):
        def run(self, proofs, inner_vo, *args, **kw):
            k1 = dict(poseidon_cuda.launches_by_mode)
            k3 = dict(witness_cuda.launches_by_kernel)
            with host_witness_calls() as host_witnesses:
                out, secs = _synced(lambda: real(self, proofs, inner_vo, *args, **kw))
            outs = out if isinstance(out, list) else [out]
            records.append({
                "level": self, "inputs": (list(proofs), inner_vo), "batch": len(outs),
                "s": secs, "host_witnesses": len(host_witnesses),
                "k1": {k: v - k1[k] for k, v in poseidon_cuda.launches_by_mode.items()},
                "k3": {k: v - k3[k] for k, v in witness_cuda.launches_by_kernel.items()},
                "sweeps": max(p.proof.opening_proof.pow_witness for p in outs) // GRIND_ROWS + 1})
            return out
        return run

    real = treem.LevelCircuit.prove_level, treem.LevelCircuit.prove_chunk
    treem.LevelCircuit.prove_level = counted(real[0])
    treem.LevelCircuit.prove_chunk = counted(real[1])
    try:
        yield records
    finally:
        treem.LevelCircuit.prove_level, treem.LevelCircuit.prove_chunk = real


def k3_level_row(state, name: str, data, pws: list) -> dict:
    """K3's timing row at a level circuit's witness of ``pws``: graph_ms,
    its launches, the plain version's ms (and its result equal to K3's),
    the bound, the levels, the Poseidon levels and the chain cost."""
    import torch

    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev

    table = wdev.device_table(data, "cuda")
    seed_reps, seeds = wdev.seed_batch(data, pws)
    wires, pis = witness_cuda.run_schedule(table, table.seeded_values(seed_reps, seeds))
    values = table.seeded_values(seed_reps, seeds)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    plain_w, plain_p = wdev.witness_plain(table, values)
    b.record()
    b.synchronize()
    if not (torch.equal(wires, plain_w) and torch.equal(pis, plain_p)):
        raise AssertionError(f"{name}: K3 differs from the plain version "
                             f"({int((wires != plain_w).sum())} cells)")
    tables = [table.seeded_values(seed_reps, seeds) for _ in range(K3_TIMED_CALLS)]
    g = graph_ms([lambda v=v: witness_cuda.run_schedule(table, v) for v in tables])
    products, nbytes = k3_work(table, len(pws))
    bound, by = k3_bound_ms(products, nbytes)
    chain_ms, levels, n_pos = k3_chain_ms(data, state["k3_ms_per_level"])
    launches = expected_k3_launches(data)
    return {"shape": name, "batch": len(pws), "n": table.n, "num_reps": table.num_reps,
            "ms": g["ms"], "min_ms": g["min_ms"], "max_ms": g["max_ms"],
            "plain_ms": a.elapsed_time(b), "products": products, "bytes": nbytes,
            "bound_ms": bound, "bound_by": by, "share_of_bound": bound / g["ms"],
            "launches": sum(launches.values()), "launches_by_kernel": launches,
            "levels": levels, "poseidon_levels": n_pos, "chain_cost_ms": chain_ms,
            "share_of_chain_cost": chain_ms / g["ms"]}


def phase_aggregate(state) -> None:
    """The reference's default aggregation of the zk wormhole proof on the
    card (see the module doc)."""
    import numpy as np
    import torch

    from zk_circuits_torch.aggregation import tree as treem
    from zk_circuits_torch.aggregation.aggregator import WormholeProofAggregator
    from zk_circuits_torch.circuits.wormhole.inputs import PublicCircuitInputs
    from zk_circuits_torch.hash import poseidon_cuda as pc
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop import witness_device as wdev
    from zk_circuits_torch.utils import profiling
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cd = state["wormhole"][0]
    leaf = state["wormhole_proof"]
    public = PublicCircuitInputs.try_from_slice(np.asarray(leaf.public_inputs))
    leaves = AGG_CONFIG[0] ** AGG_CONFIG[1]

    def aggregate():
        agg = WormholeProofAggregator(cd.common, cd.verifier_only,
                                      treem.TreeAggregationConfig(*AGG_CONFIG),
                                      dummy_loader=lambda: leaf, device="cuda")
        for _ in range(AGG_PUSHES):
            agg.push(leaf)
        root, secs = _synced(agg.aggregate)
        return agg, root, secs

    with level_prove_records() as records:
        profiling.reset_timings()
        pc.reset_launches()                 # the aggregate path starts here
        witness_cuda.reset_launches()
        agg, root, cold_s = aggregate()
        _, warm_root, warm_s = aggregate()
        k1_launches = pc.launches           # the aggregate path ends here
        k1_by_mode = dict(pc.launches_by_mode)
        k3_launches = witness_cuda.launches
    level_prove_s = profiling.get_timings()["agg/level_prove"]

    data = proof_to_bytes(root)
    if proof_to_bytes(warm_root) != data:
        raise AssertionError("aggregate: the warm root differs from the cold root")
    digest = hashlib.sha256(data).hexdigest()
    if digest != GOLDEN_AGGREGATE_ZK_SHA256:
        raise AssertionError(f"aggregate root sha256 {digest} != pinned "
                             f"{GOLDEN_AGGREGATE_ZK_SHA256}")
    root_cd = agg.root_circuit_data
    root_cd.verify(root)
    _refuses_tampering(root_cd, root)
    extracted = agg.extract_leaf_public_inputs()
    if len(extracted) != leaves or any(x != public for x in extracted):
        raise AssertionError(f"aggregate: {len(extracted)} leaves extracted, not {leaves} "
                             f"equal to the leaf's public inputs")

    # every level prove: K1 by mode, K3 by kernel, no host witness
    depth = AGG_CONFIG[1]
    if [r["batch"] for r in records] != [leaves // AGG_CONFIG[0] ** (i + 1)
                                         for i in range(depth)] * 2:
        raise AssertionError(f"aggregate: level proves of {[r['batch'] for r in records]}")
    proves = []
    for i, r in enumerate(records):
        lc = r["level"]
        want = expected_k1_launches(lc.circuit_data.common, r["batch"])
        k3_want = expected_k3_launches(lc.circuit_data)
        k1 = r["k1"]
        if (k1["tree"], k1["top"], k1["sponge"]) != (want["tree"], want["top"], r["sweeps"]) \
                or r["k3"] != k3_want or r["host_witnesses"]:
            raise AssertionError(f"aggregate level {i % depth + 1}: K1 {k1} (want {want}, "
                                 f"{r['sweeps']} sweeps), K3 {r['k3']} (want {k3_want}), "
                                 f"{r['host_witnesses']} host witnesses")
        proves.append({"run": "cold" if i < depth else "warm", "level": i % depth + 1,
                       "batch": r["batch"], "s": r["s"], "agg_level_prove_s": level_prove_s[i],
                       "k1_launches_by_mode": k1, "k1_expected": want, "sweeps": r["sweeps"],
                       "k3_launches_by_kernel": r["k3"], "k3_expected": k3_want,
                       "host_witnesses": 0})
    levels = [r["level"] for r in records[:depth]]
    circuits = []
    for i, lc in enumerate(levels):
        common, po = lc.circuit_data.common, lc.circuit_data.prover_only
        kinds = [b.kind for b in po.schedule]
        circuits.append({"level": i + 1, "inner_degree_bits": lc.inner_common.degree_bits,
                         "gate_rows": lc.num_gate_rows, "degree_bits": common.degree_bits,
                         "lde_size": common.lde_size, "build_s": lc.build_seconds,
                         "schedule_levels": len(kinds),
                         "poseidon_levels": kinds.count("poseidon"), "num_reps": po.num_reps,
                         "public_inputs": common.num_public_inputs})

    # the host's part of a level-1 prove: the chunk witnesses (the inner
    # proofs set into targets) and seed_batch, cold (the seed order not
    # kept yet) and warm
    lc1 = levels[0]
    proofs, inner_vo = records[0]["inputs"]
    pws, chunk_witness_s = _synced(lambda: [lc1._chunk_witness(proofs[i : i + AGG_CONFIG[0]],
                                                               inner_vo)
                                            for i in range(0, len(proofs), AGG_CONFIG[0])])
    lc1.circuit_data.prover_only.seed_order = None
    _, seed_cold_s = _synced(lambda: wdev.seed_batch(lc1.circuit_data, pws))
    seed_warm_s = []
    for _ in range(3):
        seed_warm_s.append(_synced(lambda: wdev.seed_batch(lc1.circuit_data, pws))[1])
    # the device witness's conflict check over the level-1 batch's filled
    # value table, and its share of one K3 run there
    table1 = wdev.device_table(lc1.circuit_data, "cuda")
    seed_reps, seeds = wdev.seed_batch(lc1.circuit_data, pws)
    watch = table1.check_seeds(seed_reps, seeds)
    filled = table1.seeded_values(seed_reps, seeds)
    seeded = filled[:, watch]
    k3_call(table1, filled)
    counts = wdev.count_conflicts(table1, filled, watch, seeded)
    if counts is None or counts.any():
        raise AssertionError(f"aggregate: level-1 conflict counts {counts}")
    conflict_check = {"shadow_slots": table1.shadow.numel(), "seeded_written": watch.numel(),
                      "ms": cuda_ms(lambda: wdev.count_conflicts(table1, filled, watch, seeded),
                                    10),
                      "k3_ms": cuda_ms(lambda: k3_call(table1, table1.seeded_values(
                          seed_reps, seeds)), 10)}
    del filled, seeded
    # one warm level-1 prove_level under the profiler
    _, prof = profiled(lambda: lc1.prove_level(proofs, inner_vo))

    # K1 and K3 at the level circuits' shapes, each against its plain version
    gen = torch.Generator(device="cuda").manual_seed(11)
    c1 = lc1.circuit_data.common
    cap = c1.config.fri_config.cap_height
    n, cols, layout = next(t[1:] for t in wormhole_trees(c1) if t[0] == "wires")
    k1_rows = []
    for batch in (None, BATCH):
        x = k1_inputs(gen, n, cols, layout, 1, batch)[0]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = pc.hash_tree_plain(x, cap)
        b.record()
        b.synchronize()
        got = pc.hash_tree(x, cap)
        if len(got) != len(want) or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"level-1 wires tree (batch {batch}): K1 != hash_tree_plain")
        del x, got, want
        work = k1_work(n, cols, cap)
        k1_rows.append(k1_row(gen, "level1_wires_tree" + ("_batch" if batch else ""), n, cols,
                              layout, lambda x: pc.hash_tree(x, cap), None,
                              tuple((batch or 1) * v for v in work),
                              plain_ms=a.elapsed_time(b), batch=batch))
        k1_rows[-1]["launches"] = expected_k1_launches(c1, batch or 1)
    last = records[depth - 1]
    k3_rows = [k3_level_row(state, f"level1_witness_b{BATCH}", lc1.circuit_data, pws),
               k3_level_row(state, "level3_witness_b1", levels[-1].circuit_data,
                            [levels[-1]._chunk_witness(*last["inputs"])])]
    for row in k1_rows + k3_rows:
        if row["share_of_bound"] > 1.05:
            raise AssertionError(f"timed below its bound: {row}")
    for k in state.get("kernels", []):
        if k["name"] in ("poseidon_leaf_hash", "witness_schedule"):
            k["launches_by_path"]["aggregate"] = (k1_launches if k["name"] ==
                                                  "poseidon_leaf_hash" else k3_launches)
    state["aggregate_launches"] = {"k1": k1_launches, "k3": k3_launches}
    emit({"phase": "aggregate", "config": "standard_recursion_zk_config",
          "tree": {"branching_factor": AGG_CONFIG[0], "depth": depth, "leaves": leaves,
                   "pushed": AGG_PUSHES},
          "sha256": digest, "golden": True, "verified": True, "tamper_rejected": True,
          "leaves_extracted": len(extracted), "root_proof_bytes": len(data),
          "level_circuits": circuits, "cold_aggregate_s": cold_s, "warm_aggregate_s": warm_s,
          "level_proves": proves, "k1_launches": k1_launches, "k1_launches_by_mode": k1_by_mode,
          "k3_launches": k3_launches, "host_witnesses": 0,
          "level1_host": {"chunk_witnesses_s": chunk_witness_s, "seed_batch_cold_s": seed_cold_s,
                          "seed_batch_warm_s": statistics.median(seed_warm_s)},
          "level1_conflict_check": conflict_check,
          "profile_warm_level1_prove": prof,
          "timing": "ms: graph_ms as in k1_time and witness_check; plain_ms: CUDA events "
                    "around one call of the plain version, on the inputs K1's and K3's "
                    "results are held to; level1_conflict_check: CUDA events, median of "
                    "10 (k3_ms with the seeded table made in the timed span); seconds: "
                    "perf_counter, ending in a synchronise",
          "k1_level_rows": k1_rows, "k3_level_rows": k3_rows})
    del agg, records, pws, proofs
    torch.cuda.empty_cache()


def phase_voting(state) -> None:
    """The vote circuit of tests/test_voting.py on the card (see the module doc)."""
    from zk_circuits_torch.circuits.voting import VoteCircuitData, VoteTargets
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness, WitnessConflict
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    targets = VoteTargets.new(builder)
    VoteCircuitData.circuit(targets, builder)
    data, build_s = _synced(lambda: builder.build(device="cuda"))
    pw = PartialWitness()
    vote_inputs().fill_targets(pw, targets)
    runs = []
    for _ in range(2):                      # cold, warm
        k1 = dict(poseidon_cuda.launches_by_mode)
        k3 = dict(witness_cuda.launches_by_kernel)
        with host_witness_calls() as host_witnesses:
            proof, secs = _synced(lambda: data.prove(pw, device="cuda"))
        runs.append({"s": secs, "sha256": hashlib.sha256(proof_to_bytes(proof)).hexdigest(),
                     "k1": {k: v - k1[k] for k, v in poseidon_cuda.launches_by_mode.items()},
                     "k3": {k: v - k3[k] for k, v in witness_cuda.launches_by_kernel.items()},
                     "host_witnesses": len(host_witnesses),
                     "sweeps": proof.proof.opening_proof.pow_witness // GRIND_ROWS + 1})
    want, k3_want = expected_k1_launches(data.common), expected_k3_launches(data)
    for r in runs:
        if r["sha256"] != GOLDEN_VOTE_SHA256:
            raise AssertionError(f"vote proof sha256 {r['sha256']} != pinned {GOLDEN_VOTE_SHA256}")
        k1 = r["k1"]
        if (k1["tree"], k1["top"], k1["sponge"]) != (want["tree"], want["top"], r["sweeps"]) \
                or r["k3"] != k3_want or r["host_witnesses"]:
            raise AssertionError(f"vote: K1 {k1} (want {want}), K3 {r['k3']} (want {k3_want}), "
                                 f"{r['host_witnesses']} host witnesses")
    data.verify(proof)
    _refuses_tampering(data, proof)
    invalid = vote_inputs()
    invalid.private_inputs.actual_merkle_depth = 1      # tests/test_voting.py's invalid proof
    invalid_pw = PartialWitness()
    invalid.fill_targets(invalid_pw, targets)
    with host_witness_calls() as host_witnesses:
        try:
            data.prove(invalid_pw, device="cuda")
        except WitnessConflict:
            pass
        else:
            raise AssertionError("vote: an invalid vote was proved on the card")
    if host_witnesses:
        raise AssertionError(f"vote: {len(host_witnesses)} host witnesses for the invalid vote")
    emit({"phase": "voting", "config": "standard_recursion_config",
          "degree_bits": data.common.degree_bits, "sha256": GOLDEN_VOTE_SHA256, "golden": True,
          "verified": True, "tamper_rejected": True, "invalid_vote_refused": True,
          "public_inputs": len(proof.public_inputs),
          "build_s": build_s, "cold_s": runs[0]["s"], "warm_s": runs[1]["s"],
          "k1_launches_by_mode": runs[1]["k1"], "k3_launches_by_kernel": runs[1]["k3"],
          "host_witnesses": 0})


def phase_api(state) -> None:
    """The artifact files and the example on the card (see the module doc)."""
    import io
    import tempfile
    from pathlib import Path

    import numpy as np

    from zk_circuits_torch.api import artifacts, example
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.api.verifier import WormholeVerifier
    from zk_circuits_torch.circuits.wormhole.inputs import PublicCircuitInputs
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils.serialization import proof_from_bytes, proof_to_bytes

    cd, targets, inputs = state["wormhole"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, write_s = _synced(lambda: artifacts.write_circuit_binaries(tmp, cd, targets))
        sizes = {p.name: p.stat().st_size for p in tmp.iterdir()}
        prover, load_s = _synced(lambda: WormholeProver.new_from_files(
            tmp / "prover.bin", tmp / "common.bin", device="cuda"))
        proof, prove_s = _synced(lambda: prover.commit(inputs).prove(device="cuda"))
        digest = hashlib.sha256(proof_to_bytes(proof)).hexdigest()
        if digest != GOLDEN_WORMHOLE_ZK_SHA256:
            raise AssertionError(f"api: proof from the loaded prover.bin sha256 {digest} != "
                                 f"pinned {GOLDEN_WORMHOLE_ZK_SHA256}")
        WormholeVerifier.new_from_files(tmp / "verifier.bin", tmp / "common.bin").verify(proof)

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, example_s = _synced(lambda: example.main(str(tmp / "proof.hex")))
        blob = bytes.fromhex((tmp / "proof.hex").read_text())
    example_proof = proof_from_bytes(blob)
    example_digest = hashlib.sha256(blob).hexdigest()
    if example_digest != GOLDEN_WORMHOLE_SHA256:
        raise AssertionError(f"api: example proof sha256 {example_digest} != pinned "
                             f"{GOLDEN_WORMHOLE_SHA256}")
    verifier, verifier_build_s = _synced(lambda: WormholeVerifier(
        CircuitConfig.standard_recursion_config(), device="cuda"))
    verifier.verify(example_proof)
    got = PublicCircuitInputs.try_from_slice(np.asarray(example_proof.public_inputs))
    if got != inputs.public:
        raise AssertionError(f"api: example public inputs {got} != {inputs.public}")
    emit({"phase": "api", "artifact_bytes": sizes, "write_s": write_s, "load_s": load_s,
          "prove_s": prove_s, "sha256": digest, "golden": True, "verified_from_files": True,
          "example_s": example_s, "example_sha256": example_digest, "example_golden": True,
          "example_verified": True, "example_public_inputs_equal": True,
          "verifier_build_s": verifier_build_s,
          "example_stdout": out.getvalue().splitlines()})


PHASES = {"card": phase_card, "square": phase_square,
          "wormhole": phase_wormhole, "batch": phase_batch,
          "witness_check": phase_witness_check, "k1_check": phase_k1_check,
          "profile": phase_profile, "k2_check": phase_k2_check,
          "sharded": phase_sharded, "k1_time": phase_k1_time,
          "k2_time": phase_k2_time, "aggregate": phase_aggregate,
          "voting": phase_voting, "api": phase_api}


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
    phase_s = {}
    for name, phase in PHASES.items():
        t0 = time.perf_counter()
        try:
            phase(state)
            phase_s[name] = time.perf_counter() - t0
        except Exception as e:  # any failing phase fails the run
            import traceback

            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e),
                  "s": time.perf_counter() - t0})
            return 1
    emit({"phase_s": phase_s, "total_s": sum(phase_s.values())})
    print(state["smi"], flush=True)
    emit({"kernels": state["kernels"]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
