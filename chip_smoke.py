#!/usr/bin/env python3
"""Smoke run of the torch/CUDA port (zk_circuits_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. card     -- the card's name and power limit; build the Poseidon kernel
               (K1), the block exchange (K2), the witness schedule (K3),
               the NTT (K4), the vanishing polynomial (K5), the
               permutation products (K6), the openings' and FRI's
               arithmetic (K7-K9, one library) and the query gather (K10)
               from csrc/, one nvcc each, all started together, timed.
2. square   -- a one-gate square circuit under both standard configs: the
               proof from device="cuda" must equal the proof from
               device="cpu" byte for byte, and verify.
3. wide_configs -- a chain of products (degree 2^11) under
               standard_recursion_zk_config at FRI arity 2^5 and at five
               challenges, built and proved on the card: each proof's
               sha256 == the JAX host path's (pinned below), verified; K9
               once a fold round (its round mode, at arity 2^5 first, then
               its fold mode), K5 and K6 twice a group of at most four
               challenges, no plain quotient or FRI body on the card.
4. wormhole -- the zk wormhole proof as bench.py proves it (circuit built
               on the card, one cold and three warm proves), verified,
               tamper-checked, and its sha256 held to the digest of the JAX
               package's host-path proof of the same inputs (pinned below).
               K1's launches per proof, by mode (sponge / tree / top), must
               be the count the circuit's trees give; K3's, by kernel, the
               plan's (a walk over each run of levels, an ops launch for
               each wide level, one cells launch), and no host witness;
               K4's, by mode, those of the proof's transforms (two a
               four-step, one a row-path call: expected_k4_launches), and
               no call of the NTT's plain stage loop on the card; K5's
               (two) and K6's (two) a proof, and no call of the quotient's
               or the permutation argument's plain version on the card
               (plain_quotient_on_card); K7's (one), K8's (three) and K9's
               (one a fold round: its round mode, with the next codeword's
               coset NTT and leaves, in all but the last) a proof, and no
               plain FRI body on the card (plain_fri_on_card); K10 once a
               proof and no plain gather on the card
               (plain_gather_on_card); K4's leaf mode for the round-0
               codeword (its coset NTT stored as fiber leaves).
5. batch    -- the batched prover: prove_batch of B=4 zk wormhole proofs
               (one cold batch, two warm), each proof's sha256 == the pinned
               digest, proof 0 verified and a tampered copy refused; K1's
               launches per batch by mode == those of one proof (tree, top)
               and the PoW sweeps the found witnesses need, K3's == those of
               one proof, no host witness, K4's == those of one proof
               and no plain NTT on the card, K5 once and K6 twice a batch
               and no plain quotient body on the card, K7-K10 as a proof
               and no plain FRI body or gather; stage times, the
               second warm batch under torch.profiler and bench.py's JSON
               keys; then the square circuit at B=4 with distinct witnesses
               under a zk config with FRI fold rounds, each proof == a
               sequential prove on the card.
6. witness_check -- K3 against its plain torch version on the card and
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
7. k1_check -- K1 against its plain torch version on the card: the sponge
               at every team size at the edges (n below the team, n not a
               multiple of the block's rows, cols 1 to 139, both layouts)
               and at the main path's widths; hash_tree against the plain
               level loop at the three commit shapes and the FRI trees, for
               one proof and for a batch of B=4; the sharded commit's
               per-shard sponge on every card.
8. k4_check -- K4 against its plain torch version (ntt/ntt.py's stage
               loop) on the card, equal integers: every transform of a
               proof (the wires INTT, the zs NTT and INTT, the three LDEs
               with their salt polys, the quotient's coset INTT of every
               challenge in one call, FRI's padded coset NTT of each fold
               round, both components in one call), the leaf mode (FRI's
               round-0 codeword as fiber leaves, both components read in
               place) at one proof, B=4 and the level-1 batch, at arity
               2^1-2^5 on both paths, on rows of 0, 1 and p - 1 and with
               the components apart, against the stage loop regrouped and
               against K4's coset NTT and the regroup
               (_commit_codeword_plain), the B=4 wires LDE and
               quotient coset INTT, a level circuit's 2^14 -> 2^17 wires
               LDE, the sharded path's 2^20-point row NTT and the
               2^22-point NTT; rows of 0, 1 and p - 1 in every mode on both
               paths; the row path at 2^13 where the four-step runs; the
               tile plans' edges (one row at 2^14, 2^15 and 2^16, 135 rows
               at 2^13) in every mode; and ntt_mxu/intt_mxu.
9. profile  -- one more warm wormhole proof under torch.profiler: device
               busy time and idle share, device operations beside
               DEVICE_OPS_BEFORE (a record, not a gate), top kernels, K3's
               and K4's launches; then one more with each prove/* stage
               under a profiler window of its own (stage_device_ops): its
               device operations, busy time and most frequent operations;
               K5 once and K6 twice a proof, no plain quotient body;
               K7-K10 as in wormhole, no plain FRI body or gather;
               prove/openings+fri's device operations beside
               OPENINGS_FRI_OPS_BEFORE and OPENINGS_FRI_OPS_BEFORE_K10, and
               the proof's beside DEVICE_OPS_BEFORE_K9 (before K9's round
               mode) and DEVICE_OPS_BEFORE_K10 (before K10 and K4's leaf
               mode).
10. k2_check -- K2 against its plain versions at E = 2, 4, 8 shards on one
               card (and spread over the cards when there are several):
               copy with even and odd block sizes and edge values, and at E=4 every fiber regroup and
               commit re-shard of the sharded phase; dft, twiddle and
               interleave, forward and inverse, at bm = 1 and 2^12 and at
               E=4 at every four-step of the sharded phase.  One launch
               per card and mode; equal integers.
11. sharded  -- the multi-device path on a mesh of E=4 shards, in the order
               of the JAX package's multi-chip dryrun: the batch-sharded
               wires commit (cap == the single-device commit's), the
               sharded FRI commit chain at the production shape (caps,
               betas, final poly == the single-device chain's), the
               four-step NTT, INTT and coset LDE at 2^22 points (== the
               single-device transforms; one dft, twiddle and interleave
               launch per card each, no copy), and prove_sharded of the zk
               wormhole (cold and warm; sha256 == the pinned digest,
               verified, tamper-checked).  K2's launch counter must rise in
               every sub-step, K1's in every sub-step that hashes leaves;
               each four-step's row NTTs are one K4 four-step a shard, and
               K4's launches by mode are printed per sub-step; a sharded
               proof launches K5 once a shard (its rows, row0 and its halo)
               and K6 twice, with no plain quotient body on the card, and
               K7 and K8's point kernel a shard and once more on the first
               (the Z rows at g*zeta), K8's scan once, K9's fold mode a
               shard a round (expected_fri_launches), with no plain FRI
               body, and K10 once (every oracle's and FRI tree's query
               rows and paths read from the shards where they lie), with
               no plain take (_take_all, _take_sharded) on the card; K1 at
               most SHARDED_K1_MAX times a proof (each shard's subtree one
               tree-mode call, and the PoW sweeps).  A warm sharded proof
               under torch.profiler: its device operations (fewer than
               SHARDED_DEVICE_OPS_BEFORE), busy time and idle share.
               Then the device operations of one profiled 2^22 four-step,
               fused and as the sequence it replaced (K2 copies with eager
               torch field operations between them), each with its K2
               launches by mode.
12. k1_time -- K1's device time (graph_ms) at the main path's shapes and
               the whole wires tree against the 13 launches of the level
               loop, the B=4 batch's wires and FRI trees, beside the plain
               version and the bound; every team
               size and block size as a candidate, at those shapes and at
               the sharded path's per-shard ones; the permutation's
               multiply and instruction counts from the built library's
               SASS (cuobjdump).  A share of the bound above 1.05 fails.
13. k2_time -- K2's device time (graph_ms) by mode: copy at the
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
14. k4_time -- K4's device time (graph_ms) at every shape of k4_check's
               main-path list (the wires LDE is the kernels line's
               figure) and at the one-row coset INTT and FRI coset NTT
               that a call took before it served both challenges or both
               components, beside its plain version, its bound (bytes or
               the decomposition's products: k4_work), the time recorded
               before the redesign (K4_BEFORE_MS), the host time a
               wrapper call, each launch's blocks, threads, shared bytes
               and resident blocks an SM; ptxas's registers and spills and
               the kernel's IMAD.WIDE, LDS and STS counts from its SASS
               (cuobjdump); no PyTorch call computes a Goldilocks NTT, so
               no library time; the leaf mode at the round-0 codewords of
               one proof, B=4 and the level-1 batch, beside the parent
               commit's leaf mode on the same inputs (paired_ms) and beside
               K4's coset NTT of the same rows at the same size (the same
               words as contiguous rows), with the leaf plan's launches.
               A share of the bound above 1.05 fails.
15. aggregate -- the reference's default tree aggregation (b=2, d=3: 8
               leaves) of the wormhole phase's zk proof through the
               port's WormholeProofAggregator on the card: 3 pushes, 5
               dummies (the proof is its own dummy), once cold (3 level
               circuits built) and once warm (the level cache hit).  The
               root's sha256 == the JAX host path's root (pinned below),
               cold == warm, verified, tamper-checked, and its 8 leaves'
               public inputs extract equal to the leaf's.  Every level
               prove (a batch of 4, a batch of 2, one proof) launches K1 by
               mode and K3 by kernel as many times as its level circuit
               gives, K5 once and K6 twice, K7 once, K8 twice and K9 once
               a fold round (its round mode but in the last), K10 once,
               with no host witness and no plain quotient or
               FRI body or gather on the card.  Then the host's part of a
               level-1 prove (the chunk witnesses, seed_batch), one warm
               level-1 prove_level under torch.profiler, and K1 (the
               level-1 wires tree, alone and at B=4) and K3 (the level-1
               witness at B=4, the level-3 witness alone) at the level
               circuits' shapes, each held to its plain version and timed
               as in k1_time and witness_check.
16. k5_check -- K5 against its plain version (plonk/prover.py's
               _device_vanishing_eval times 1/Z_H) on the card, equal
               integers: the wormhole's coset alone and at B=4, the
               level-1 aggregation circuit's (arithmetic-extension and
               random-access gates) at its batch of 4, the sharded path's
               E=4 calls (a shard's rows, row0 and its halo) against the
               whole coset, inputs of 0, 1 and p - 1, five challenges
               (two groups of launches) and each of k5_time's per-gate
               tables.
17. k6_check -- K6 against its plain version (_zs_values_plain) on the
               card, equal integers: the same shapes on H, one proof
               unbatched (the sharded prover's call), a zero denominator
               in one chunk, inputs of 0, 1 and p - 1, five challenges
               with and without a zero denominator, zeros in two chunks
               of a point, in each challenge and at the first and last
               point of a tile (each closing the scan), n = 1000 (not a
               multiple of the tile), a last chunk of 6 and of 5.
18. k5_time -- K5's device time (graph_ms) at k5_check's three main-path
               shapes beside its plain version, its bound (bytes, or the
               64x64 products counted from the circuit's table: k5_work)
               and the host time of a wrapper call; ptxas's registers and
               spills and the SASS counts of each kernel; beside the
               parent commit's K5 on the same inputs in turns (paired_ms:
               parent, this, this, parent; the parent's registers and
               SASS too); and its split by gate kind: the wormhole's table
               and tables of one gate kind each at the wormhole's shape
               (k5_gate_tables), each beside the parent's.  A share of
               the bound above 1.05 fails.
19. k6_time -- the same for K6 (k6_work), and its point kernel alone,
               each beside the parent's (paired_ms); the products a point
               the bound counts and the kernel spends.
20. fri_check -- K7, K8 and K9 against their plain versions
               (fri/fri_device.py's _openings_plain, _reduce_alpha_plain,
               _compose_plain, _fold_plain, _fold_round_plain) on the card,
               equal integers: one wormhole proof, B=4 and the level-1
               batch at 2^14 (three fold rounds, the last of arity 2; K9's
               round mode in every round but the last), each with the circuit's
               constants/sigmas shared (batch stride 0); every input 0, 1
               or p - 1; each proof's points at 0, 1, -1, x and -1 - x;
               n not a multiple of K8's tiles and segments, a short
               segment, a lone point and more segments than a scan
               block's threads, at B = 3; K7's row groups of 1 and 3
               rows, its tiles forced to 2048 at one proof and 256 at
               B=4, n = 100; K9's fold mode at arity bits 1-6, batched and
               1-D, and its round mode at arity bits 1-6, at every input 0,
               1 or p - 1, at each group of 1, 2, 4 and 8 cosets that fold
               once (clusters) at the wormhole's round and at a 2^16
               codeword, over a strided batch, and at K9_MAX_BATCH + 2
               proofs (two launches, as its fold mode); each shard's
               openings, alpha reduction and fold on the sharded path
               (E=4) and the Z rows at g*zeta on the first shard.
21. fri_time -- K7-K9's device time (graph_ms) at fri_check's three
               main-path shapes: K7, K8's point kernel, its scan, both,
               each fold round (K9's round mode, the last its fold mode),
               and a proof's launches of all three, beside the plain
               versions, the bound (fri_work: bytes, or the products the
               functions need) and the host time of a wrapper call;
               ptxas's registers and spills and the SASS counts of each
               kernel; K8 and K9 (unchanged: controls) beside the parent
               commit's on the same inputs (paired_ms).  A share of the
               bound above 1.05 fails.
22. gather_check -- K10 against its plain version (fri/fri_device.py's
               _gather_plain: a take a leaf matrix and a level) on the
               card, equal integers: the query gather of one wormhole
               proof, of B=4 and of the level-1 batch (its three FRI
               trees), each with the constants/sigmas tree shared (batch
               stride 0), every word any u64 (in [p, 2^64) too), indices
               0, N - 1 and repeated; a tree with no sibling level;
               gather_trees_batch's host arrays against the CPU's; and
               the row-sharded trees of one warm sharded proof at E=4 on
               one card (and spread over the cards, read through peer
               pointers, where there are several) against the sharded
               plain version (_take_all with _take_sharded).
23. gather_time -- K10's device time (graph_ms of its one launch on
               prepared calls) at those three shapes beside its plain
               version, its bound (gather_work: each gathered word read
               and written once) and the host time of one
               gather_trees_batch call; that call's device operations
               under torch.profiler; both beside the parent commit's
               eager gather on the same trees (host ms in turns: parent,
               this, this, parent).  A share of the bound above 1.05
               fails.
24. batch_mesh -- prove_batch of 8 zk wormhole proofs of the golden inputs
               over make_mesh(4) (shard i on cuda:(i % cards); the four
               shards prove in turn, on one card or on four), cold and
               warm, beside an unsharded batch of 8 cold
               and warm in the same run: each proof's sha256 == the pinned
               digest, one verified and a tampered copy refused, no host
               witness; K1's and K3's launches by card == the shards on
               that card times a sub-batch of 2's counts (K1 by mode ==
               4 times them); the unsharded batch is the first of 8 (the
               batch phase left nothing to build); one more mesh batch under
               utils/profiling.device_trace (torch.profiler, a Chrome
               trace written under ZKT_PROFILE_DIR), each card's busy
               time and idle share.
25. aggregate_mesh -- the aggregate phase's tree over make_mesh(4),
               with its cached level circuits (none built again), once
               on one card and twice (first, warm) on several:
               level 1's 4 chunks split one a shard, level 2 (B=2, not a
               multiple of 4) unsharded by the JAX package's rule, level
               3 one proof; root sha256 == the pinned root, verified,
               leaves extracted; K1/K3 launches a level prove as its
               split gives; seconds per level beside the aggregate
               phase's warm unsharded ones.
26. multihost -- scripts/torch_multihost_sim.py with 2 processes of 2
               shards: with 4 cards or more each process owns 2 cards
               and the backend is nccl, else both share cuda:0 under
               gloo (NCCL refuses two ranks on one card); the backend
               is printed.
               The four-step NTT at 2^22 points over ("dcn", "ici") equal
               to the host NTT on every process's shards, its INTT back
               to the input, the batch LDE over "dcn" equal to the host
               LDE; K2's launches counted per process (3 a four-step per
               card); beside the same four-step over make_mesh(4) in this
               process.
    With four cards or more, k1_time also times the wires tree on each
    card alone and on all at once, and k2_time each K2 mode at 2^22
    points with its shards on four cards (NVLink peers).
27. voting  -- the vote circuit of tests/test_voting.py under
               standard_recursion_config built and proved on the card (cold
               and warm), sha256 == the JAX host path's (pinned below),
               verified, tamper-checked, K1's and K3's launches as the
               circuit gives, no host witness; a vote with the wrong
               Merkle depth refused by the device witness on the card.
28. api     -- the zk wormhole's common.bin, verifier.bin and prover.bin
               written to a temporary directory; WormholeProver.new_from_files
               proves the golden inputs on the card (sha256 == the pinned
               zk digest) and WormholeVerifier.new_from_files verifies it;
               then api/example.py's main (the non-zk wormhole): its hex
               decodes to a proof with the JAX host path's sha256 (pinned
               below), which a freshly built verifier accepts, whose public
               inputs are the golden fixture's.
29. compat  -- the reference-format layer (zk_circuits_torch/compat, host
               numpy): its import runs the fast-Poseidon self-check; K1's
               hash_rows of 4096 seeded rows of 8 felts (one permutation
               each, state = row || 0^4) on the card equals its plain
               version, and on 64 of them lanes 0-3 of the reference
               engine's fast permutation (compat.poseidon_fast); the
               emulated reference wormhole layout (build_wormhole_layout)
               has the JAX package's degree, gate list and selector groups,
               and its polys' sha256 is the JAX package's (pinned below).
               Its K1 launch is a cross-check, counted apart under
               launches_by_path["compat"].
30. native  -- the host runtime (zk_circuits_torch.native: g++ builds
               csrc/host_native.cpp in the card phase, beside the nvcc
               builds; its seconds and library name): every function
               equal to its numpy plain version at the circuit's sizes
               (leaves of 2^13 x 135, host_intt and host_ntt of 80 x 2^13,
               4096 permutations, the field operations with edge values);
               the microseconds of one single-state permutation, native
               and plain; then 3 warm wormhole proofs and 2 warm batches
               of 4 with the native calls counted (the proofs must
               permute natively), and each one's openings+fri stage
               beside the sum of its fri/* timers (the remainder is the
               host transcript).

The last lines are the card line, the kernels line and
{"ok": true, "device": {...}}.  Needs no network; imports no JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
import types

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
# sha256 of the emulated reference wormhole layout's polys (compat/:
# build_wormhole_layout(True)'s selector, constant and sigma polys stacked,
# (84, 2^13) little-endian u64) from the JAX package;
# scripts/golden_digests.py prints it and tests/test_torch_compat.py
# re-derives it.  Its degree, gate list and selector groups are the JAX
# package's: 2^13 (the reference's is 2^14), these gates, these groups.
GOLDEN_COMPAT_LAYOUT_SHA256 = (
    "e9d4db5ab53d4d2fb80ca25dcedca9bb15db5de0e034d2b553912f9310edc3f5")
COMPAT_DEGREE_BITS = 13
COMPAT_GATE_LIST = ("Noop", "Constant", "PublicInput", "BaseSum", "Arithmetic", "Poseidon")
COMPAT_SELECTOR_GROUPS = ((0, 5), (5, 6))

# The chain of MUL_CHAIN_MULS dependent products y <- y x (x = MUL_CHAIN_X,
# degree 2^11) under standard_recursion_zk_config with one setting widened
# (WIDE_CONFIGS): FRI folds of arity 2^5 (arities [5, 1]), or five
# challenges.  sha256 of the JAX package's host-path proofs (prove(...,
# use_device=False)); scripts/golden_digests.py prints them and
# tests/test_torch_jax_pins.py re-derives them.
MUL_CHAIN_MULS = 21000
MUL_CHAIN_X = 3
WIDE_CONFIGS = {"arity5": {"reduction_arity_bits": 5}, "challenges5": {"num_challenges": 5}}
GOLDEN_MUL_CHAIN_SHA256 = {
    "arity5": "39a036dc3e6138e4b48ff48db1f9b649f29775309e7c583ebdd2690deb64edc8",
    "challenges5": "f9a1d6675717bd4991ffdda291dcea1f93102554e5a429079b5f53b550eaca1d"}

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
K4_SOURCE = "zk_circuits_torch/csrc/ntt.cu"
K4_REPLACES = "zk_circuits_tpu/ntt/ntt_mxu.py:167"
K4_TIMED_CALLS = 8     # back-to-back calls per K4 timing (graph_ms)
K5_SOURCE = "zk_circuits_torch/csrc/quotient.cu"
K5_REPLACES = "zk_circuits_tpu/plonk/prover.py:186"
K5_TIMED_CALLS = 4     # back-to-back calls per K5 timing (graph_ms)
K6_SOURCE = "zk_circuits_torch/csrc/permutation.cu"
K6_REPLACES = "zk_circuits_tpu/plonk/prover.py:266"
K6_TIMED_CALLS = 8     # back-to-back calls per K6 timing (graph_ms)
K6_INVERSE_PRODUCTS = 73   # csrc/permutation.cuh k6_inverse: 64 squarings and 9 products
K4_MULS_PER_PRODUCT = 8   # 32-bit multiplies of a 64x64 product
FRI_SOURCE = "zk_circuits_torch/csrc/fri.cu"   # K7, K8 and K9
FRI_REPLACES = "zk_circuits_tpu/fri/fri_device.py"
FRI_TIMED_CALLS = 8    # back-to-back calls per K7-K9 timing (graph_ms)
FRI_INVERSE_PRODUCTS = 78   # an extension inverse: the norm (3), a 73-product chain, 2
K10_SOURCE = "zk_circuits_torch/csrc/gather.cu"
K10_REPLACES = "zk_circuits_tpu/fri/fri_device.py:312"
K10_TIMED_CALLS = 8    # back-to-back launches per K10 timing (graph_ms), each its own indices
K10_HOST_CALLS = 20    # gather_trees_batch calls per host timing (paired with the parent)
# graph_ms of the first, radix-2 K4 on an H100 (PERF.md's table, "ms before"), by
# k4_time's shape
K4_BEFORE_MS = {"wires_lde": 0.369428, "batch_wires_lde": 1.340142, "wires_intt": 0.071562,
                "quotient_coset_intt_one_row": 0.063586, "level_wires_lde": 0.715634,
                "sharded_row_ntt": 0.076704}
# 64x64 products an op of each kind (8 32-bit multiplies each, as above):
# arith c0*m0*m1 + c1*ad; arith_ext an extension product (5) and 4 scalings;
# the Fermat inverse 64 squarings and 63 multiplies; ext_inv its norm (3),
# an inverse and 2; a Poseidon gate 4 deltas and 118 S-boxes of 4.
K3_PRODUCTS = {"const": 0, "arith": 3, "arith_ext": 9, "eq_inv": 127, "ext_inv": 132,
               "base_sum": 0, "random_access": 0, "poseidon": 4 + 118 * 4}
K3_CHAIN_DEPTH = 128   # levels of the arith chain circuit that times a narrow level
# a warm wormhole proof's device operations with the host witness (PERF.md)
DEVICE_OPS_BEFORE = 64251   # a warm proof's device operations before K5 and K6 (PERF.md)
DEVICE_OPS_BEFORE_K9 = 380  # ... before K9's round mode (PERF.md §5)
DEVICE_OPS_BEFORE_K10 = 371  # ... before K10 and K4's leaf mode (PERF.md §5)
DEVICE_OPS_BEFORE_FRI = 11462        # ... before K7-K9 (PERF.md)
OPENINGS_FRI_OPS_BEFORE = 11390      # prove/openings+fri's of them (stage_device_ops)
OPENINGS_FRI_OPS_BEFORE_K10 = 305    # prove/openings+fri's before K10 (the parent's, PERF.md §6)
SHARDS = 4             # E of the sharded phase
SHARDED_K1_MAX = 60    # K1 launches a sharded proof, at most: 6 trees x E shards x 2, PoW
SHARDED_DEVICE_OPS_BEFORE = 2423   # a warm sharded proof's device operations before
                                   # K10 and K1's tree mode served it (PERF.md)
BATCH = 4              # proofs per prove_batch call (bench.py's ZKT_BENCH_BATCH)
NTT_LOG = 22           # SCALING.md's size of one sharded polynomial
SIM_TIMEOUT = 240      # seconds the multihost phase gives its processes
K2_TIMED_CALLS = 32    # back-to-back calls per K2 timing (graph_ms)


# The port before K10 and K4's leaf mode, whose kernels k4_time, k5_time,
# k6_time, fri_time and gather_time time beside this tree's in the same run
# (paired_ms; gather_time its eager gather on the host clock): its
# zk_circuits_torch/ under PARENT_DIR (git-ignored), unpacked there from the
# checkout's git history when it has the commit.
PARENT_COMMIT = "12052c11ab8b8ddbd1569b7aa4f4f278f42a28f6"
PARENT_DIR = "zk_circuits_torch/_build/parent"


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


def parent_port():
    """The port at PARENT_COMMIT imported as the package ``zk_parent`` (its
    kernels built into its own _build/), or None where PARENT_DIR lacks it
    and ``git archive`` cannot unpack it."""
    import importlib.util
    from pathlib import Path

    if "zk_parent" in sys.modules:
        return sys.modules["zk_parent"]
    root = Path(__file__).resolve().parent
    pkg = root / PARENT_DIR / "zk_circuits_torch"
    if not (pkg / "__init__.py").exists():
        try:
            tar = subprocess.run(["git", "-C", str(root), "archive", PARENT_COMMIT,
                                  "zk_circuits_torch"], capture_output=True, timeout=120,
                                 check=True).stdout
            (root / PARENT_DIR).mkdir(parents=True, exist_ok=True)
            subprocess.run(["tar", "-x", "-C", str(root / PARENT_DIR)], input=tar, check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    spec = importlib.util.spec_from_file_location("zk_parent", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["zk_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


def parent_kernels() -> dict:
    """The parent's K4, K5, K6 and K7-K9 wrappers ({"k4": its ntt_cuda,
    "k5": its quotient_cuda, "k6": its permutation_cuda, "fri": its
    fri_cuda}; empty without the parent); its K5 table knows this tree's
    gate classes.  Its fri/fri_device.py is ``parent_fri_device()``."""
    import importlib

    from zk_circuits_torch.plonk import quotient_cuda

    if parent_port() is None:
        return {}
    pq = importlib.import_module("zk_parent.plonk.quotient_cuda")
    by_name = {cls.__name__: kind for cls, kind in pq.KINDS.items()}
    pq.KINDS = {cls: by_name[cls.__name__] for cls in quotient_cuda.KINDS}
    return {"k4": importlib.import_module("zk_parent.ntt.ntt_cuda"), "k5": pq,
            "k6": importlib.import_module("zk_parent.plonk.permutation_cuda"),
            "fri": importlib.import_module("zk_parent.fri.fri_cuda")}


def parent_fri_device():
    """The parent's fri/fri_device.py (its K9's round sequence: K9, K4's
    coset NTT, the fiber regroup), or None without the parent."""
    import importlib

    return importlib.import_module("zk_parent.fri.fri_device") if parent_port() else None


def paired_ms(calls: list, parent_calls: list) -> dict:
    """graph_ms of this tree's calls and of the parent's on the same
    inputs, in turns on one card: parent, this, this, parent."""
    runs = [graph_ms(c) for c in (parent_calls, calls, calls, parent_calls)]
    return {"ms": [runs[1]["ms"], runs[2]["ms"]], "parent_ms": [runs[0]["ms"], runs[3]["ms"]],
            "ms_range": [min(r["min_ms"] for r in runs[1:3]), max(r["max_ms"] for r in runs[1:3])],
            "parent_ms_range": [min(runs[0]["min_ms"], runs[3]["min_ms"]),
                                max(runs[0]["max_ms"], runs[3]["max_ms"])]}


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
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    # Keep CUPTI set up between torch.profiler windows.  By default each
    # window tears it down at its end; once CUDA graphs have been captured
    # (graph_ms), a later window has at times recorded no device event.
    # torch.profiler makes the same setting itself where it knows of graphs.
    os.environ["TEARDOWN_CUPTI"] = "0"

    from zk_circuits_torch import native
    from zk_circuits_torch.fri import fri_cuda, gather_cuda
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_torch.parallel import exchange_cuda
    from zk_circuits_torch.plonk import permutation_cuda, quotient_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    state["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""

    def timed(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    poseidon_cuda.write_constants_header(poseidon_cuda.BUILD_DIR)   # K1's, K3's, native's
    parent = parent_kernels()   # the parent's K4-K9, timed beside this tree's
    # one nvcc per source and g++ for the host runtime, all started together
    with ThreadPoolExecutor(16) as pool:
        k1, k2, k3, k4, k5, k6, k789, k10, host, *parent_s = pool.map(timed, (
            poseidon_cuda.build, exchange_cuda.build, witness_cuda.build, ntt_cuda.build,
            quotient_cuda.build, permutation_cuda.build, fri_cuda.build, gather_cuda.build,
            native.build, *(m.build for m in parent.values())))
    native.available()
    state["native_build"] = {"build_s": host, "library": native.build().name,
                             "compiler_output": native.build_log}
    ptxas = [ln.strip() for mod in (poseidon_cuda, exchange_cuda, witness_cuda, ntt_cuda,
                                    quotient_cuda, permutation_cuda, fri_cuda, gather_cuda)
             for ln in mod.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "card", "nvidia_smi": state["smi"],
          "name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "k1_build_s": k1, "k2_build_s": k2, "k3_build_s": k3, "k4_build_s": k4,
          "k5_build_s": k5, "k6_build_s": k6, "k7_k8_k9_build_s": k789, "k10_build_s": k10,
          "native_build_s": host, "parent": PARENT_COMMIT if parent else None,
          "parent_build_s": dict(zip(parent, parent_s)),
          "ptxas": ptxas})


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


def expected_sharded_k1_launches(common, shards: int, pow_witness: int) -> int:
    """K1's launches a sharded proof over ``shards`` shards
    (hash/merkle.py::sharded_tree): for each of its trees (the wires, zs
    and quotient commits, the constants/sigmas commit it makes again, and
    each fold round's FRI tree) and each shard, a tree launch over the
    shard's leaves and a top launch where its blocks' subtrees end below
    the local cap height (leaves of 4 felts or fewer are padded by torch
    and the tree is over their digests paired into rows of 8); one more
    tree over the shards' roots where they outnumber the cap; and the PoW
    grind's sweeps in sponge mode."""
    from zk_circuits_torch.hash import poseidon_cuda as pc

    cap = common.config.fri_config.cap_height
    local = max(cap - (shards.bit_length() - 1), 0)

    def tree(n: int, cols: int, cap_h: int) -> int:
        if cols <= 4:
            if n == 1 << cap_h:
                return 0
            n >>= 1
        return 1 + bool(pc.tree_plan(n, cap_h, min(pc.config(n)[1], n))["top_threads"])

    trees = wormhole_trees(common) + [("constants_sigmas", common.lde_size,
                                       common.config.num_routed_wires, "column-major")]
    k1 = shards * sum(tree(n // shards, cols, local) for _, n, cols, _ in trees)
    if shards > 1 << cap:
        k1 += len(trees) * tree(shards // 2, 8, cap)
    return k1 + pow_witness // GRIND_ROWS + 1


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


def wide_config(config_mod, which: str):
    """standard_recursion_zk_config of ``config_mod`` (plonk/config.py of
    either package) with WIDE_CONFIGS[which] set."""
    kw = dict(WIDE_CONFIGS[which])
    fri = {k: kw.pop(k) for k in list(kw) if k in ("reduction_arity_bits",)}
    return config_mod.CircuitConfig(zero_knowledge=True, fri_config=config_mod.FriConfig(**fri),
                                    **kw)


def mul_chain(builder_mod, witness_mod, config_mod, which: str, **build_kw):
    """The mul chain circuit under wide_config(which), built by
    ``builder_mod`` (iop/builder.py of either package), and its witness."""
    b = builder_mod.CircuitBuilder(wide_config(config_mod, which))
    x = b.add_virtual_target()
    y = x
    for _ in range(MUL_CHAIN_MULS):
        y = b.mul(y, x)
    b.register_public_input(y)
    data = b.build(**build_kw)
    pw = witness_mod.PartialWitness()
    pw.set_target(x, MUL_CHAIN_X)
    return data, pw


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


def phase_wide_configs(state) -> None:
    """The mul chain under FRI folds of arity 2^5 and under five challenges,
    built and proved on the card: each proof's sha256 == the JAX host
    path's (GOLDEN_MUL_CHAIN_SHA256), verified; K9 once a fold round (at
    arity 2^5 first), K5 once and K6 twice a group of at most four
    challenges, and no plain quotient or FRI body on the card."""
    import hashlib

    from zk_circuits_torch.iop import builder, witness
    from zk_circuits_torch.plonk import config, permutation_cuda, quotient_cuda
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    for which in WIDE_CONFIGS:
        t0 = time.perf_counter()
        data, pw = mul_chain(builder, witness, config, which, device="cuda")
        t1 = time.perf_counter()
        common = data.common
        k56, fri = quotient_launches(), fri_launches()
        with plain_quotient_on_card() as plain_quotient, plain_fri_on_card() as plain_fri:
            proof, secs = _synced(lambda: prove_batch(data, [pw], device="cuda")[0])
        k56 = [a - b for a, b in zip(quotient_launches(), k56)]
        fri = fri_since(fri)
        digest = hashlib.sha256(proof_to_bytes(proof)).hexdigest()
        if digest != GOLDEN_MUL_CHAIN_SHA256[which]:
            raise AssertionError(f"wide_configs/{which}: sha256 {digest} != the JAX host "
                                 f"path's {GOLDEN_MUL_CHAIN_SHA256[which]}")
        data.verify(proof)
        want_fri, want_k56 = expected_fri_launches(common), expected_quotient_launches(common)
        if tuple(k56) != want_k56 or fri != want_fri or plain_quotient or plain_fri:
            raise AssertionError(f"wide_configs/{which}: K5, K6 launches {k56} (want "
                                 f"{want_k56}), K7-K9 {fri} (want {want_fri}), "
                                 f"plain bodies {plain_quotient + plain_fri}")
        emit({"phase": "wide_configs", "config": which, "settings": WIDE_CONFIGS[which],
              "degree_bits": common.degree_bits,
              "arities": common.config.fri_config.reduction_arities(common.degree_bits),
              "num_challenges": common.config.num_challenges, "sha256": digest,
              "pinned": True, "verified": True, "build_s": t1 - t0, "prove_s": secs,
              "k5_k6_launches": k56, "k7_k9_launches": fri,
              "k5_max_ch": quotient_cuda.MAX_CH, "k6_max_ch": permutation_cuda.MAX_CH})


def phase_wormhole(state) -> None:
    import torch

    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.circuits.wormhole import golden_fixtures
    from zk_circuits_torch.hash import poseidon_cuda
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.ntt import ntt_cuda
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
    with host_witness_calls() as host_witnesses, plain_ntts_on_card() as plain_ntts, \
            plain_quotient_on_card() as plain_quotient, plain_fri_on_card() as plain_fri, \
            plain_gather_on_card() as plain_gather:
        poseidon_cuda.reset_launches()      # main path starts here
        witness_cuda.reset_launches()
        ntt_cuda.reset_launches()
        reset_quotient_launches()
        reset_fri_launches()
        proof, cold_s = one_proof(prover)
        per_proof = poseidon_cuda.launches
        by_mode = dict(poseidon_cuda.launches_by_mode)
        k3_per_proof = dict(witness_cuda.launches_by_kernel)
        k4_per_proof = dict(ntt_cuda.launches_by_mode)
        k56_per_proof = quotient_launches()
        fri_per_proof = fri_launches()
        warm = []
        for _ in range(3):
            proof_w, dt = one_proof(WormholeProver(circuit_data=cd, targets=targets))
            warm.append(dt)
        launches = poseidon_cuda.launches   # main path ends here
        k3_launches = witness_cuda.launches
        k4_launches = ntt_cuda.launches
        k5_launches, k6_launches = quotient_launches()
        fri_all = fri_launches()
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
    k4_want = expected_k4_launches(cd.common)
    if k4_per_proof != k4_want or k4_launches != 4 * sum(k4_want.values()) or plain_ntts:
        raise AssertionError(f"K4 launches {k4_per_proof} per proof ({k4_launches} in all), "
                             f"want {k4_want}; plain NTTs on the card: {plain_ntts}")
    k56_want = expected_quotient_launches(cd.common)
    if k56_per_proof != k56_want or (k5_launches, k6_launches) != tuple(
            4 * k for k in k56_want) or plain_quotient:
        raise AssertionError(f"K5, K6 launches {k56_per_proof} per proof ({k5_launches}, "
                             f"{k6_launches} in all), want {k56_want}; plain quotient bodies "
                             f"on the card: {plain_quotient}")
    fri_want = expected_fri_launches(cd.common)
    if fri_per_proof != fri_want or fri_all != {k: 4 * v for k, v in fri_want.items()} \
            or plain_fri or plain_gather:
        raise AssertionError(f"K7-K10 launches {fri_per_proof} per proof ({fri_all} in all), "
                             f"want {fri_want}; plain FRI bodies on the card: {plain_fri}; "
                             f"plain gathers: {plain_gather}")

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
    state["k4_launches"] = k4_launches
    state["k4_launches_by_mode"] = dict(ntt_cuda.launches_by_mode)
    state["k5_launches"], state["k6_launches"] = k5_launches, k6_launches
    state["fri_launches"] = fri_all
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
          "k4_launches_per_proof_by_mode": k4_per_proof, "k4_launches": k4_launches,
          "k4_launches_by_mode": state["k4_launches_by_mode"], "plain_ntts_on_card": 0,
          "k4_copies": ntt_cuda.copies,
          "k5_launches_per_proof": k56_per_proof[0], "k5_launches": k5_launches,
          "k6_launches_per_proof": k56_per_proof[1], "k6_launches": k6_launches,
          "plain_quotient_on_card": 0, "k7_k9_launches_per_proof": fri_per_proof,
          "k7_k9_launches": fri_all, "plain_fri_on_card": 0,
          "k10_launches_per_proof": fri_per_proof["k10"], "k10_launches": fri_all["k10"],
          "plain_gather_on_card": 0,
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


def fri_rounds(common) -> list:
    """(coefficients folded, arity bits, round mode) of each fold round of
    a proof of ``common``: K9's round mode (the fold, the next codeword's
    coset NTT and its leaves in one launch) for every round but the last
    where ``fri_cuda.round_fits`` holds, else its fold mode."""
    from zk_circuits_torch.fri import fri_cuda

    arities = common.config.fri_config.reduction_arities(common.degree_bits)
    out, n = [], common.degree
    for r, a in enumerate(arities):
        out.append((n, a, r + 1 < len(arities) and fri_cuda.round_fits(n, a)))
        n >>= a
    return out


def expected_k4_launches(common) -> dict:
    """K4's launches a proof, or a batch of proofs (a call serves the
    batch's rows), by mode: two a call that takes the four-step, one a
    row-path call.  The wires INTT, the zs stage's NTT and INTT, the three
    commits' LDEs, the quotient's coset INTT (every challenge in one call),
    and FRI's codewords in the leaf mode (both components in one call, the
    values stored as fiber leaves): the round-0 codeword and each later
    one that K9's round mode does not make; no plain coset NTT."""
    from zk_circuits_torch.ntt import ntt_cuda

    def k(n):
        return 2 if ntt_cuda.plan(n) else 1

    n, lde, rate = common.degree, common.lde_size, common.config.fri_config.rate_bits
    rounds = fri_rounds(common)
    sizes = [lde] if rounds else []
    sizes += [(c >> a) << rate for c, a, mode in rounds[:-1] if not mode]
    return {"ntt": k(n), "intt": 2 * k(n), "coset_ntt": 0, "coset_intt": k(lde),
            "lde": 3 * k(lde), ntt_cuda.LEAF_MODE: sum(k(s) for s in sizes)}


@contextlib.contextmanager
def plain_calls_on_card(module, names):
    """A list that grows by the name of every call of ``module``'s
    functions ``names`` with a CUDA tensor among its arguments (or in a list
    or tuple among them) inside the block."""
    real, calls = {k: getattr(module, k) for k in names}, []

    def on_card(a) -> bool:
        if isinstance(a, (list, tuple)):
            return any(on_card(x) for x in a)
        return getattr(a, "is_cuda", False)

    def counted(name, fn):
        def call(*args, **kwargs):
            if any(on_card(a) for a in args):
                calls.append(name)
            return fn(*args, **kwargs)
        return call

    for k, fn in real.items():
        setattr(module, k, counted(k, fn))
    try:
        yield calls
    finally:
        for k, fn in real.items():
            setattr(module, k, fn)


def plain_ntts_on_card():
    """The calls of ntt/ntt.py's plain stage loop (``*_plain``) on a CUDA
    tensor inside the block: on the card every transform must take K4."""
    from zk_circuits_torch.ntt import ntt as nttm

    return plain_calls_on_card(nttm, ("ntt_plain", "intt_plain", "coset_ntt_plain",
                                      "coset_intt_plain", "lde_plain"))


def plain_quotient_on_card():
    """The calls of the quotient's and the permutation argument's plain
    versions (plonk/prover.py's ``_device_vanishing_eval`` and
    ``_zs_values_plain``) on CUDA tensors inside the block: on the card the
    main path takes K5 and K6."""
    from zk_circuits_torch.plonk import prover

    return plain_calls_on_card(prover, ("_device_vanishing_eval", "_zs_values_plain"))


def plain_fri_on_card():
    """The calls of the openings' and FRI's plain versions (fri/fri_device.py's
    ``_openings_plain``, ``_reduce_alpha_plain``, ``_compose_plain``,
    ``_fold_plain``, ``_fold_round_plain``, and K4's leaf mode's
    ``_commit_codeword_plain``) on CUDA tensors inside the block: on the
    card the main path takes K7, K8, K9 and K4's leaf mode."""
    from zk_circuits_torch.fri import fri_device

    return plain_calls_on_card(fri_device, ("_openings_plain", "_reduce_alpha_plain",
                                            "_compose_plain", "_fold_plain",
                                            "_fold_round_plain", "_commit_codeword_plain"))


def plain_gather_on_card():
    """The calls of the query gather's plain version (fri/fri_device.py's
    ``_gather_plain`` and its ``take_rows_batch``) on CUDA tensors inside
    the block: on the card the main path takes K10."""
    from zk_circuits_torch.fri import fri_device

    return plain_calls_on_card(fri_device, ("_gather_plain", "take_rows_batch"))


@contextlib.contextmanager
def plain_sharded_gather_on_card():
    """The calls of the sharded query gather's plain version
    (fri/fri_device.py's ``_take_all`` and plonk/prover_sharded.py's
    ``_take_sharded``) on CUDA tensors inside the block: on the card the
    sharded proof takes K10."""
    from zk_circuits_torch.fri import fri_device
    from zk_circuits_torch.plonk import prover_sharded

    with plain_calls_on_card(fri_device, ("_take_all",)) as a, \
            plain_calls_on_card(prover_sharded, ("_take_sharded",)) as b:
        yield [a, b]


def fri_launches() -> dict:
    """K7's, K8's and K9's launches so far, K9's in its round mode
    (``k9_round``, among K9's), and K10's (the query gather)."""
    from zk_circuits_torch.fri import fri_cuda, gather_cuda

    return {**fri_cuda.launches_by_kernel, "k9_round": fri_cuda.k9_by_mode["round"],
            "k10": gather_cuda.launches}


def fri_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in fri_launches().items()}


def reset_fri_launches() -> None:
    from zk_circuits_torch.fri import fri_cuda, gather_cuda

    fri_cuda.reset_launches()
    gather_cuda.reset_launches()


def expected_fri_launches(common, shards: int | None = None) -> dict:
    """K7's, K8's, K9's and K10's launches a proof, or a batch of proofs of
    one circuit: K7 once, K8 three times (its point kernel, and its scan's
    segment sums and finish), K9 once a fold round, in its round mode
    (``k9_round``) where fri_rounds says, K10 once (every tree's query
    rows and paths).  For a sharded proof over ``shards`` shards: K7 and
    K8's point kernel once a shard and once more for the Z rows at g*zeta,
    K8's scan once (two launches), K9's fold mode once a shard a fold round
    while every shard holds a multiple of the arity, else once
    (fri_sharded._fold gathers), K10 once (the shards' pieces read where
    they lie)."""
    from zk_circuits_torch.fri import fri_cuda

    rounds = fri_rounds(common)
    if shards is None:
        return {"k7": 1, "k8": 1 + fri_cuda.SCAN_LAUNCHES, "k9": len(rounds),
                "k9_round": sum(mode for _, _, mode in rounds), "k10": 1}
    pieces, k9 = [common.degree // shards] * shards, 0
    for _, a, _ in rounds:
        if any(p % (1 << a) for p in pieces):
            pieces = [sum(pieces)]
        k9 += len(pieces)
        pieces = [p >> a for p in pieces]
    return {"k7": shards + 1, "k8": shards + 1 + fri_cuda.SCAN_LAUNCHES, "k9": k9,
            "k9_round": 0, "k10": 1}


def expected_quotient_launches(common, shards: int = 1) -> tuple[int, int]:
    """K5's and K6's launches a proof, or a batch of proofs of one circuit:
    K5 quotient_cuda.LAUNCHES_PER_GROUP and K6 two a group of at most four
    challenges; on the sharded path K5's a shard."""
    from zk_circuits_torch.plonk import quotient_cuda

    groups = -(-common.config.num_challenges // quotient_cuda.MAX_CH)
    return shards * quotient_cuda.LAUNCHES_PER_GROUP * groups, 2 * groups


def quotient_launches() -> tuple[int, int]:
    """K5's and K6's launches so far."""
    from zk_circuits_torch.plonk import permutation_cuda, quotient_cuda

    return quotient_cuda.launches, permutation_cuda.launches


def reset_quotient_launches() -> None:
    from zk_circuits_torch.plonk import permutation_cuda, quotient_cuda

    quotient_cuda.reset_launches()
    permutation_cuda.reset_launches()


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
    by_name = device_events(prof)
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
        "ntt_kernel_s": sum(v[0] for k, v in by_name.items() if "k4_" in k),
        "fri_kernel_s": sum(v[0] for k, v in by_name.items()
                            if any(f"k{i}_" in k for i in (7, 8, 9))),
        "gather_kernel_s": sum(v[0] for k, v in by_name.items() if "k10_" in k),
        "top_device_ops": [{"name": k[:100], "s": v[0], "count": v[1]}
                           for k, v in top]}


def device_events(prof) -> dict:
    """{kernel or copy name: [device seconds, count]} of a torch.profiler
    run's raw device events."""
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and \
                not getattr(e, "is_hidden_event", lambda: False)():
            s = by_name.setdefault(e.name(), [0.0, 0])
            s[0] += e.duration_ns() / 1e9
            s[1] += 1
    return by_name


@contextlib.contextmanager
def stage_device_ops():
    """Inside the block, each stage timer of plonk/prover_batch.py
    (``prove/wires``, ``prove/zs``, ``prove/quotient``,
    ``prove/openings+fri``) runs under a torch.profiler window of its own
    (card only) ending in a synchronise; the yielded dict gets each stage's
    device operations, busy seconds and top operations by count."""
    from torch.profiler import ProfilerActivity, profile

    from zk_circuits_torch.plonk import prover_batch

    real, out = prover_batch.stage_timer, {}

    @contextlib.contextmanager
    def timed(name):
        with real(name), profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            _sync_all()
        by_name = device_events(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
        out[name] = {"device_ops": sum(v[1] for v in by_name.values()),
                     "device_busy_s": sum(v[0] for v in by_name.values()),
                     "top_by_count": [{"name": k[:80], "count": v[1]} for k, v in top]}

    prover_batch.stage_timer = timed
    try:
        yield out
    finally:
        prover_batch.stage_timer = real


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
    from zk_circuits_torch.ntt import ntt_cuda
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
    k4_want = expected_k4_launches(cd.common)
    profiling.reset_timings()
    poseidon_cuda.reset_launches()      # the batch path starts here
    witness_cuda.reset_launches()
    ntt_cuda.reset_launches()
    reset_quotient_launches()
    reset_fri_launches()
    fri_want = expected_fri_launches(cd.common)
    batch_s, per_batch, k3_per_batch, k4_per_batch, prof = [], [], [], [], None
    for i in range(3):                  # one cold batch, two warm
        pws = witnesses()
        before = dict(poseidon_cuda.launches_by_mode)
        k3_before = dict(witness_cuda.launches_by_kernel)
        k4_before = dict(ntt_cuda.launches_by_mode)
        k56_before = quotient_launches()
        fri_before = fri_launches()
        with host_witness_calls() as host_witnesses, plain_ntts_on_card() as plain_ntts, \
                plain_quotient_on_card() as plain_quotient, plain_fri_on_card() as plain_fri, \
                plain_gather_on_card() as plain_gather:
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
        k4 = {k: v - k4_before[k] for k, v in ntt_cuda.launches_by_mode.items()}
        if k4 != k4_want or plain_ntts:
            raise AssertionError(f"K4 launches per batch {k4}, want {k4_want}; plain NTTs "
                                 f"on the card: {plain_ntts}")
        k4_per_batch.append(k4)
        k56 = tuple(a - b for a, b in zip(quotient_launches(), k56_before))
        if k56 != expected_quotient_launches(cd.common) or plain_quotient:
            raise AssertionError(f"K5, K6 launches per batch {k56}, want "
                                 f"{expected_quotient_launches(cd.common)}; plain quotient "
                                 f"bodies on the card: {plain_quotient}")
        fri = fri_since(fri_before)
        if fri != fri_want or plain_fri or plain_gather:
            raise AssertionError(f"K7-K10 launches per batch {fri}, want {fri_want}; plain FRI "
                                 f"bodies on the card: {plain_fri}; plain gathers: "
                                 f"{plain_gather}")
        digests = [hashlib.sha256(proof_to_bytes(p)).hexdigest() for p in proofs]
        if len(proofs) != BATCH or set(digests) != {GOLDEN_WORMHOLE_ZK_SHA256}:
            raise AssertionError(f"batched wormhole sha256s {digests} != pinned "
                                 f"{GOLDEN_WORMHOLE_ZK_SHA256}")
    launches = poseidon_cuda.launches   # the batch path ends here
    state["k1_launches_batch"] = launches
    state["k3_launches_batch"] = witness_cuda.launches
    state["k4_launches_batch"] = ntt_cuda.launches
    state["k5_launches_batch"], state["k6_launches_batch"] = quotient_launches()
    state["fri_launches_batch"] = fri_launches()
    k4_copies = ntt_cuda.copies         # inputs K4 copied to one row stride, 3 batches
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
          "k3_launches": state["k3_launches_batch"],
          "k4_launches_per_batch_by_mode": k4_per_batch,
          "k4_launches": state["k4_launches_batch"], "k4_copies": k4_copies,
          "k5_launches_per_batch": expected_quotient_launches(cd.common)[0],
          "k5_launches": state["k5_launches_batch"],
          "k6_launches_per_batch": expected_quotient_launches(cd.common)[1],
          "k6_launches": state["k6_launches_batch"],
          "plain_quotient_on_card": 0, "k7_k9_launches_per_batch": fri_want,
          "k7_k9_launches": state["fri_launches_batch"], "plain_fri_on_card": 0,
          "k10_launches_per_batch": fri_want["k10"],
          "k10_launches": state["fri_launches_batch"]["k10"], "plain_gather_on_card": 0,
          "host_witnesses": 0,
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
    from zk_circuits_torch.ntt import ntt_cuda

    cd, targets, inputs = state["wormhole"]

    def prove():
        return WormholeProver(circuit_data=cd, targets=targets).commit(inputs).prove(
            device="cuda")

    before, k4_before = witness_cuda.launches, dict(ntt_cuda.launches_by_mode)
    k56_before = quotient_launches()
    fri_before = fri_launches()
    with plain_quotient_on_card() as plain_quotient, plain_fri_on_card() as plain_fri, \
            plain_gather_on_card() as plain_gather:
        _, prof = profiled(prove)
        with stage_device_ops() as by_stage:
            prove()
    if plain_quotient or plain_fri or plain_gather:
        raise AssertionError(f"plain quotient bodies on the card: {plain_quotient}; plain "
                             f"FRI bodies: {plain_fri}; plain gathers: {plain_gather}")
    k56 = [a - b for a, b in zip(quotient_launches(), k56_before)]
    if k56 != [2 * k for k in expected_quotient_launches(cd.common)]:
        raise AssertionError(f"K5, K6 launches {k56} over two proofs, want twice "
                             f"{expected_quotient_launches(cd.common)}")
    fri = fri_since(fri_before)
    fri_want = {k: 2 * v for k, v in expected_fri_launches(cd.common).items()}
    if fri != fri_want:
        raise AssertionError(f"K7-K10 launches {fri} over two proofs, want {fri_want}")
    state["device_ops"] = prof["device_ops"]
    state["device_ops_by_stage"] = by_stage
    emit({"phase": "profile", **prof, "device_ops_before": DEVICE_OPS_BEFORE,
          "device_ops_shed": DEVICE_OPS_BEFORE - prof["device_ops"],
          "device_ops_before_k10": DEVICE_OPS_BEFORE_K10,
          "device_ops_shed_by_k10": DEVICE_OPS_BEFORE_K10 - prof["device_ops"],
          "device_ops_before_k9_round": DEVICE_OPS_BEFORE_K9,
          "device_ops_before_fri": DEVICE_OPS_BEFORE_FRI,
          "openings_fri_device_ops": by_stage["prove/openings+fri"]["device_ops"],
          "openings_fri_device_ops_before_k10": OPENINGS_FRI_OPS_BEFORE_K10,
          "openings_fri_device_ops_before": OPENINGS_FRI_OPS_BEFORE,
          "device_ops_by_stage": by_stage,
          "device_ops_in_stages": sum(v["device_ops"] for v in by_stage.values()),
          "k3_launches": witness_cuda.launches - before,
          "k4_launches_by_mode": {k: v - k4_before[k]
                                  for k, v in ntt_cuda.launches_by_mode.items()},
          "k5_launches": k56[0] // 2, "k6_launches": k56[1] // 2,
          "plain_quotient_on_card": 0,
          "k7_k9_launches": {k: v // 2 for k, v in fri.items()}, "plain_fri_on_card": 0,
          "plain_gather_on_card": 0,
          "by_stage_note": "a second warm proof, each prove/* stage under its own "
                           "torch.profiler window (card only), ending in a synchronise; "
                           "k5/k6 and k7-k9 launches per proof"})


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
    from zk_circuits_torch.ntt import ntt_cuda
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
        k4_before = dict(ntt_cuda.launches_by_mode)
        k56_before = quotient_launches()
        fri_before = fri_launches()
        with plain_quotient_on_card() as plain_quotient, plain_fri_on_card() as plain_fri, \
                plain_sharded_gather_on_card() as (takes, shard_takes):
            res, secs = _synced(fn)
        if plain_quotient or plain_fri or takes or shard_takes:
            raise AssertionError(f"sharded/{step}: plain quotient bodies on the card: "
                                 f"{plain_quotient}; plain FRI bodies: {plain_fri}; plain "
                                 f"takes: {takes + shard_takes}")
        k1 = poseidon_cuda.launches - k1_before
        k2 = exchange_cuda.launches - k2_before
        if k2 <= 0 or (hashes and k1 <= 0):
            raise AssertionError(f"sharded/{step}: {k2} K2 and {k1} K1 launches")
        steps[step] = {"s": secs, "k2_launches": k2, "k1_launches": k1,
                       "k2_launches_by_mode": {k: v - by_mode[k] for k, v in
                                               exchange_cuda.launches_by_mode.items()},
                       "k4_launches_by_mode": {k: v - k4_before[k] for k, v in
                                               ntt_cuda.launches_by_mode.items()},
                       **dict(zip(("k5_launches", "k6_launches"), (
                           a - b for a, b in zip(quotient_launches(), k56_before)))),
                       "k7_k9_launches": fri_since(fri_before)}
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
    ntt_cuda.reset_launches()
    reset_quotient_launches()
    reset_fri_launches()
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
    state["k4_launches_sharded"] = ntt_cuda.launches
    k4_by_mode = dict(ntt_cuda.launches_by_mode)
    state["k5_launches_sharded"], state["k6_launches_sharded"] = quotient_launches()
    state["fri_launches_sharded"] = fri_launches()
    fri_want = expected_fri_launches(cd.common, SHARDS)
    for name in ("prove_cold", "prove_warm"):   # K5 a shard, K6 once on the first
        if (steps[name]["k5_launches"], steps[name]["k6_launches"]) != \
                expected_quotient_launches(cd.common, SHARDS):
            raise AssertionError(f"sharded/{name}: K5, K6 launches {steps[name]['k5_launches']}"
                                 f", {steps[name]['k6_launches']}, want {SHARDS}, 2")
        if steps[name]["k7_k9_launches"] != fri_want:
            raise AssertionError(f"sharded/{name}: K7-K9 launches "
                                 f"{steps[name]['k7_k9_launches']}, want {fri_want}")
    if not steps["fri_commit"]["k7_k9_launches"]["k9"]:
        raise AssertionError("sharded/fri_commit: no K9 launch")
    for name in ("ntt", "intt", "coset_lde"):   # each card's row NTT: one K4 four-step
        if steps[name]["k4_launches_by_mode"]["ntt"] != 2 * SHARDS:
            raise AssertionError(f"sharded/{name}: K4 launches by mode "
                                 f"{steps[name]['k4_launches_by_mode']}, want a four-step "
                                 f"(2 launches) a shard")
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
    k1_want = expected_sharded_k1_launches(
        cd.common, SHARDS, proofs[0].proof.opening_proof.pow_witness)
    for name in ("prove_cold", "prove_warm"):   # each shard's subtree one tree-mode call
        if not steps[name]["k1_launches"] == k1_want <= SHARDED_K1_MAX:
            raise AssertionError(f"sharded/{name}: {steps[name]['k1_launches']} K1 launches, "
                                 f"want {k1_want}, at most {SHARDED_K1_MAX}")
    pw = WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness
    _, prof = profiled(lambda: prove_sharded(cd, pw, mesh))
    out["profile_warm_proof"] = prof
    if prof["device_ops"] >= SHARDED_DEVICE_OPS_BEFORE:
        raise AssertionError(f"a warm sharded proof ran {prof['device_ops']} device "
                             f"operations, {SHARDED_DEVICE_OPS_BEFORE} before K10 and K1's "
                             f"tree mode")
    out["per_warm_proof"] = {
        "k10_launches": steps["prove_warm"]["k7_k9_launches"]["k10"],
        "k1_launches": steps["prove_warm"]["k1_launches"], "k1_expected": k1_want,
        "device_ops": prof["device_ops"], "device_ops_before": SHARDED_DEVICE_OPS_BEFORE,
        "device_busy_s": prof["device_busy_s"], "device_idle_share": prof["device_idle_share"],
        "wall_s": prof["wall_s"], "leaf_kernel_s": prof["leaf_kernel_s"],
        "gather_kernel_s": prof["gather_kernel_s"]}
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
               k4_launches=state["k4_launches_sharded"], k4_launches_by_mode=k4_by_mode,
               k4_launches_by_mode_per_proof=steps["prove_warm"]["k4_launches_by_mode"],
               k5_launches=state["k5_launches_sharded"],
               k5_launches_per_proof=steps["prove_warm"]["k5_launches"],
               k6_launches=state["k6_launches_sharded"],
               k6_launches_per_proof=steps["prove_warm"]["k6_launches"],
               plain_quotient_on_card=0, k7_k9_launches=state["fri_launches_sharded"],
               k7_k9_launches_per_proof=fri_want, plain_fri_on_card=0,
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


def k1_cards(cap: int, wires: tuple):
    """With several cards: the wires tree on each card alone (CUDA events
    on that card around one call, median of 10; not graph_ms, whose
    capture stream torch.cuda.graph keeps on the card it first ran on),
    and K1_TIMED_CALLS calls on every card at once (host clock around
    them, ending in a synchronise of every card, per call); None on one
    card."""
    import torch

    from zk_circuits_torch.hash import poseidon_cuda as pc

    cards = torch.cuda.device_count()
    if cards < 2:
        return None
    n, cols, layout = wires
    alone, inputs = {}, {}
    for c in range(cards):
        with torch.cuda.device(c):
            gen = torch.Generator(device=f"cuda:{c}").manual_seed(70 + c)
            inputs[c] = k1_inputs(gen, n, cols, layout, K1_TIMED_CALLS)
            alone[f"cuda:{c}"] = cuda_ms(lambda x=inputs[c][0]: pc.hash_tree(x, cap), 10)

    def every_card():
        for c in range(cards):
            with torch.cuda.device(c):
                for x in inputs[c]:
                    pc.hash_tree(x, cap)

    every_card()
    _sync_all()
    together = [_synced(every_card)[1] * 1e3 / K1_TIMED_CALLS for _ in range(5)]
    return {"shape": "wires_tree", "n": n, "cols": cols, "alone_ms": alone,
            "every_card_at_once_ms_per_call": statistics.median(together),
            "every_card_at_once_range": [min(together), max(together)]}


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
    emit({"phase": "k1_time", "cards": k1_cards(cap, trees["wires"]),
          "muls_per_permutation": MULS_PER_PERM,
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


NVLINK_BYTES_PER_S = 450e9   # one direction of an H100 SXM's NVLink (data sheet: 900 GB/s both)


def k2_cards(rng):
    """With SHARDS cards or more: K2's modes at the four-step's 2^22
    points with shard i on cuda:i (make_mesh), sources on other cards
    read over NVLink: CUDA events on cuda:0 around one call (every card's
    launch waits on cuda:0's stream and cuda:0's stream on every launch),
    median of 10, beside the plain version across the cards; each result
    equal to the plain version's.  The bound: the larger of the bytes
    over the cards' HBM and the bytes each card reads from peers over
    its NVLink.  None with fewer cards."""
    import numpy as np
    import torch

    from zk_circuits_torch.parallel import exchange_cuda as xc
    from zk_circuits_torch.parallel import mesh as meshm

    if torch.cuda.device_count() < SHARDS:
        return None
    e, n = SHARDS, 1 << NTT_LOG
    m = n // e
    mesh = meshm.make_mesh(e)
    host = rng.integers(0, P, (e, m), dtype=np.uint64).view(np.int64)
    rows = [torch.from_numpy(host[s]).to(d) for s, d in enumerate(mesh.devices)]
    blocks = [r.reshape(e, m // e) for r in rows]
    cases = {"copy": (lambda: xc.exchange(blocks), lambda: xc.exchange_plain(blocks)),
             "dft": (lambda: xc.exchange_dft(blocks, False),
                     lambda: xc.dft_plain(blocks, False)),
             "twiddle": (lambda: xc.exchange_twiddle(blocks, n, False),
                         lambda: xc.twiddle_plain(blocks, n, False)),
             "interleave": (lambda: xc.exchange_interleave(rows, False),
                            lambda: xc.interleave_plain(rows, False)),
             "interleave inverse": (lambda: xc.exchange_interleave(rows, True),
                                    lambda: xc.interleave_plain(rows, True))}
    out = []
    for mode, (kernel, plain) in cases.items():
        got, want = kernel(), plain()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K2 {mode} across {e} cards != its plain version")
        del got, want
        with torch.cuda.device(0):
            ms = cuda_ms(kernel, reps=10)
            plain_ms = cuda_ms(plain, reps=5)
        nbytes = 2 * 8 * n
        peer = 8 * n * (e - 1) // e // e        # read by each card from its peers
        bound = max(nbytes / (e * HBM_BYTES_PER_S), peer / NVLINK_BYTES_PER_S) * 1e3
        out.append({"mode": mode, "shape": f"four_step_2^{NTT_LOG}", "cards": e,
                    "mesh": [str(d) for d in mesh.devices], "ms": ms, "plain_ms": plain_ms,
                    "bytes": nbytes, "peer_bytes_per_card": peer, "bound_ms": bound,
                    "bound_by": "nvlink" if peer / NVLINK_BYTES_PER_S > nbytes / (
                        e * HBM_BYTES_PER_S) else "bytes", "share_of_bound": bound / ms})
    return out


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
    emit({"phase": "k2_time", "cards": k2_cards(rng), "hbm_bytes_per_s": HBM_BYTES_PER_S,
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


def k4_cases(common) -> list:
    """(name, mode, input shape, keyword arguments) of the transforms K4
    serves: one proof's (the wires INTT, NTT and INTT of the zs stage, the
    three commits' LDEs with their salt polys, the quotient's coset INTT
    of every challenge, FRI's padded coset NTT of each fold round on both
    components), a batch of BATCH's, a level circuit's wires LDE (degree
    2^14) and the sharded path's 2^20-point row NTT and its 2^22-point
    single-device reference."""
    cfg, n, lde = common.config, common.degree, common.lde_size
    rate, salts = cfg.rate_bits, 4 if cfg.zero_knowledge else 0
    zs = common.num_zs_partial_products_polys
    cases = [("wires_intt", "intt", (cfg.num_wires, n), {}),
             ("wires_lde", "lde", (cfg.num_wires + salts, n), {"rate_bits": rate}),
             ("zs_ntt", "ntt", (cfg.num_routed_wires, n), {}),
             ("zs_intt", "intt", (zs, n), {}),
             ("zs_lde", "lde", (zs + salts, n), {"rate_bits": rate}),
             ("quotient_coset_intt", "coset_intt", (cfg.num_challenges, lde), {}),
             ("quotient_lde", "lde", (common.num_quotient_polys + salts, n),
              {"rate_bits": rate})]
    size, m = lde, n
    for r, a_bits in enumerate(cfg.fri_config.reduction_arities(common.degree_bits)):
        cases.append((f"fri_coset_ntt_{r}", "coset_ntt", (2, m), {"size": size}))
        size, m = size >> a_bits, m >> a_bits
    cases += [("batch_wires_lde", "lde", (BATCH, cfg.num_wires + salts, n), {"rate_bits": rate}),
              ("batch_quotient_coset_intt", "coset_intt", (cfg.num_challenges, BATCH, lde), {}),
              ("level_wires_lde", "lde", (cfg.num_wires + salts, 2 * n), {"rate_bits": rate}),
              ("sharded_row_ntt", "ntt", (1 << (NTT_LOG - 2),), {}),
              ("ntt_2_22", "ntt", (1 << NTT_LOG,), {})]
    return cases


def k4_leaf_cases(common) -> list:
    """(name, proofs, coefficients, points, arity bits) of K4's leaf mode on
    the main path: FRI's round-0 codeword of one wormhole proof, of a batch
    of BATCH and of the level-1 aggregation batch (a level circuit of twice
    the wormhole's degree, AGG_CONFIG[0] ** (depth - 1) proofs)."""
    fri = common.config.fri_config
    a = fri.reduction_arities(common.degree_bits)[0]
    n, lde = common.degree, common.lde_size
    return [("fri_leaves_0", 1, n, lde, a), ("batch_fri_leaves_0", BATCH, n, lde, a),
            ("level_fri_leaves_0", AGG_CONFIG[0] ** (AGG_CONFIG[1] - 1), 2 * n, 2 * lde, a)]


def k4_leaf_plain(f, size: int, arity_bits: int, shift: int = 7):
    """K4's leaf mode's plain version on the card: the stage loop's coset
    NTT of both components of f (2, B, n), regrouped into fiber leaves."""
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt as nttm

    v = nttm.coset_ntt_plain(f, shift, size)
    return fd._fiber_leaves(v[0], v[1], 1 << arity_bits)


def k4_plain(mode: str, x, **kw):
    """ntt/ntt.py's plain version of one K4 mode (its stage loop)."""
    from zk_circuits_torch.ntt import ntt as nttm

    if mode == "lde":
        return nttm.lde_plain(x, kw["rate_bits"])
    if mode == "coset_ntt":
        return nttm.coset_ntt_plain(x, size=kw.get("size"))
    return getattr(nttm, f"{mode}_plain")(x)


def k4_inputs(rng, shape, count: int = 1) -> list:
    """``count`` canonical int64 tensors of ``shape`` on the card, made on
    the card from ``rng``'s seed; 0, 1 and p - 1 lead the first row."""
    import torch

    from zk_circuits_torch.field import goldilocks as gf

    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 62)))
    out = []
    for _ in range(count):
        x = gf.canon(torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen,
                                   device="cuda", dtype=torch.int64))
        x.view(-1, shape[-1])[0, :3] = torch.tensor([0, 1, P - 1 - (1 << 64)], device="cuda")
        out.append(x)
    return out


def k4_work(mode: str, shape: tuple, n: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) that one K4 call's function needs: its
    input read once and its output written once (K4's own tables are not
    the function's); the products of the radix-16 decomposition K4 runs
    (csrc/ntt.cuh), where a product by a power of w_16 is a shift and
    counts nothing: in each pass, each column's inter-round twiddles
    w_(L_r)^(j k) with j, k > 0 (S_r (R_r - 1) (M_r - 1) after round r,
    in round 0 only for the j that an input reaches: an LDE's zero tasks
    need none); on the four-step, w_n^(j1 k2) for j1, k2 > 0; and the
    mode's scalings: shift^i on the inputs but the first, n^-1 on the
    inverse's outputs (for the coset INTT one table of n^-1 shift^-m; for
    the four-step INTT n products that take the four-step twiddle and n^-1
    together, as pass A does).  8 multiplies a 64x64 product."""
    from zk_circuits_torch.ntt import ntt_cuda

    rows, n_in = 1, shape[-1]
    for d in shape[:-1]:
        rows *= d
    nbytes = 8 * rows * (n_in + n)
    log_n1 = ntt_cuda.plan(n)
    products = 0
    for p, l in enumerate(ntt_cuda.pass_logs(n, log_n1)):
        # the j that an input reaches in round 0: input j (row path) or j1 + n1 j (pass A)
        live = n_in if not log_n1 else -(-n_in >> log_n1) if p == 0 else 1 << l
        lr, per_col = l, 0
        for r, b in enumerate(ntt_cuda.radix_logs(l)[:-1]):
            m = 1 << (lr - b)
            per_col += (1 << (l - lr)) * ((1 << b) - 1) * ((min(m, live) if r == 0 else m) - 1)
            lr -= b
        products += (n >> l) * per_col
    if log_n1 and mode != "intt":     # the INTT's are among its n scalings
        products += ((1 << log_n1) - 1) * ((n >> log_n1) - 1)
    if mode in ("coset_ntt", "lde"):
        products += n_in - 1
    if mode in ("intt", "coset_intt"):
        products += n
    return nbytes, rows * products * K4_MULS_PER_PRODUCT


def k4_bound_ms(nbytes: int, muls: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_k4_check(state) -> None:
    """K4 against its plain version (ntt/ntt.py's stage loop) on the card,
    equal integers: every shape and mode the main path gives it, a batch
    of BATCH, a level circuit's LDE, the sharded path's rows, rows of 0, 1
    and p - 1, both paths at 2^13, and ntt_mxu/intt_mxu."""
    import numpy as np
    import torch

    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.ntt import ntt_cuda
    from zk_circuits_torch.ntt import ntt_mxu as mxu

    cd, _, _ = state["wormhole"]
    rng = np.random.default_rng(2031)
    before = ntt_cuda.launches
    checked = []

    def check(name, mode, x, **kw):
        got = ntt_cuda.transform(x, mode, **kw)
        want = k4_plain(mode, x, **{k: v for k, v in kw.items() if k != "log_n1"})
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"k4_check/{name}: K4 {mode} {tuple(x.shape)} != its plain "
                                 f"version")
        checked.append({"name": name, "mode": mode, "shape": list(x.shape),
                        "points": got.shape[-1], "log_n1": kw.get("log_n1",
                                                                  ntt_cuda.plan(got.shape[-1]))})

    def check_leaves(name, c0, c1, size, a):
        got = ntt_cuda.coset_leaves(c0, c1, 7, size, a)
        f = torch.stack([c0, c1])
        same = [torch.equal(got, k4_leaf_plain(f, size, a)),
                torch.equal(got, fd._commit_codeword_plain(c0, c1, 7, size, a))]
        torch.cuda.synchronize()
        if not all(same):
            raise AssertionError(f"k4_check/{name}: K4's leaf mode {tuple(c0.shape)} -> {size} "
                                 f"at arity 2^{a} != the stage loop regrouped ({same[0]}) or "
                                 f"K4's coset NTT and the regroup ({same[1]})")
        checked.append({"name": name, "mode": ntt_cuda.LEAF_MODE, "shape": [2, *c0.shape],
                        "points": size, "arity_bits": a, "leaves": list(got.shape),
                        "log_n1": ntt_cuda.leaf_plan(size)})

    for name, mode, shape, kw in k4_cases(cd.common):
        check(name, mode, k4_inputs(rng, shape)[0], **kw)
    # the leaf mode: both components read from K8's (2, B, n) buffer, each
    # value at its fiber-leaf slot; against the stage loop regrouped and
    # against K4's coset NTT and the regroup (_commit_codeword_plain, the
    # sequence it replaces): the main path's codewords, arities 2^1-2^5 on
    # both paths, rows of 0, 1 and p - 1, components apart
    leaf_cases = k4_leaf_cases(cd.common) + [
        (f"arity_{a}_{size}", 2, size >> 3, size, a) for a in range(1, 6)
        for size in (1 << 12, 1 << 16)]
    for name, b, n_in, size, a in leaf_cases:
        f = k4_inputs(rng, (2, b, n_in))[0]
        check_leaves(name, f[0], f[1], size, a)
    for value in (0, 1, P - 1):
        f = torch.full((2, 2, 1 << 13), value - (1 << 64) if value >= 1 << 63 else value,
                       dtype=torch.int64, device="cuda")
        check_leaves(f"leaves_constant_{value}", f[0], f[1], 1 << 16, 4)
    f = k4_inputs(rng, (2, 3, 1 << 13))[0]
    check_leaves("leaves_apart", f[0][:2], f[1][1:].clone(), 1 << 16, 4)
    n = cd.common.degree
    for value in (0, 1, P - 1):                    # constant rows, both paths
        for size in (32, 1 << 16):
            x = torch.full((3, size), value - (1 << 64) if value >= 1 << 63 else value,
                           dtype=torch.int64, device="cuda")
            for mode in ntt_cuda.MODES:
                check(f"constant_{value}_{size}", mode, x,
                      **({"rate_bits": 1} if mode == "lde" else {}))
    x = k4_inputs(rng, (5, n))[0]
    for mode in ("ntt", "intt"):                    # the row path where the four-step runs
        check(f"row_path_{n}", mode, x, log_n1=0)
    for rows, size in ((1, 1 << 14), (1, 1 << 15), (1, 1 << 16), (135, n)):   # plans' edges
        x = k4_inputs(rng, (rows, size))[0]
        for mode in ntt_cuda.MODES:
            check(f"plan_edge_{rows}x{size}", mode, x,
                  **({"rate_bits": 1} if mode == "lde" else {}))
    for size in (64, 1 << 16):
        x = k4_inputs(rng, (2, size))[0]
        if not (torch.equal(mxu.ntt_mxu(x), k4_plain("ntt", x)) and
                torch.equal(mxu.intt_mxu(x), k4_plain("intt", x))):
            raise AssertionError(f"k4_check: ntt_mxu/intt_mxu at {size} != the plain version")
        checked.append({"name": f"ntt_mxu_{size}", "mode": "ntt, intt", "shape": [2, size]})
    state["k4_max_abs_err"] = 0
    emit({"phase": "k4_check", "equal_integers": True, "cases": checked,
          "launches": ntt_cuda.launches - before, "copies": ntt_cuda.copies})


def phase_k4_time(state) -> None:
    """K4's device time at the main path's shapes (see the module doc)."""
    import numpy as np
    import torch

    from zk_circuits_torch.ntt import ntt_cuda

    cd, _, _ = state["wormhole"]
    rng = np.random.default_rng(2032)
    n, lde = cd.common.degree, cd.common.lde_size
    cases = k4_cases(cd.common) + [
        ("quotient_coset_intt_one_row", "coset_intt", (lde,), {}),
        ("fri_coset_ntt_0_one_row", "coset_ntt", (n,), {"size": lde})]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = []
    for name, mode, shape, kw in cases:
        xs = k4_inputs(rng, shape, K4_TIMED_CALLS)
        g = graph_ms([lambda x=x: ntt_cuda.transform(x, mode, **kw) for x in xs])
        points = shape[-1] << kw["rate_bits"] if mode == "lde" else kw.get("size", shape[-1])
        rows = int(np.prod(shape[:-1], dtype=np.int64))
        nbytes, muls = k4_work(mode, shape, points)
        bound, by = k4_bound_ms(nbytes, muls)
        plain_ms = cuda_ms(lambda: k4_plain(mode, xs[0], **kw), reps=3, warmup=1)
        log_n1 = ntt_cuda.plan(points)
        cols = ntt_cuda.tiles(rows, points, log_n1, ntt_cuda._sm_count(
            ntt_cuda._lib(), torch.device("cuda:0")))
        launches = [{"log_len": lg, "blocks": b, "threads": t, "smem_bytes": sm,
                     "blocks_per_sm": ntt_cuda.occupancy("cuda:0", lg, t, sm),
                     "blocks_per_sm_of_card": b / sms}
                    for lg, (b, t, sm) in zip(ntt_cuda.pass_logs(points, log_n1),
                                              ntt_cuda.launch_shape(rows, points, log_n1, cols))]
        before = K4_BEFORE_MS.get(name)
        rows_out.append({"shape": name, "mode": mode, "input": list(shape), "points": points,
                         "launches_per_call": len(launches),
                         "factors": list(ntt_cuda.split(points)) if log_n1 else None,
                         "log_cols": list(cols), "launch": launches,
                         **g, "before_ms": before,
                         "ms_over_before": g["ms"] / before if before else None,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "bytes": nbytes, "muls": muls, "share_of_bound": bound / g["ms"],
                         "library_ms": None,
                         "host_us_per_call": host_us_per_call(
                             lambda: ntt_cuda.transform(xs[0], mode, **kw))})
        del xs
    # the leaf mode at the main path's round-0 codewords, beside the
    # parent's leaf mode on the same inputs (paired_ms) and beside K4's
    # coset NTT of the same rows at the same size, which writes the same
    # words as contiguous rows (paired too: leaf, coset, coset, leaf)
    parent_fd = parent_fri_device()
    dev0 = torch.device("cuda:0")
    for name, b, n_in, size, a in k4_leaf_cases(cd.common):
        fs = k4_inputs(rng, (2, b, n_in), K4_TIMED_CALLS)
        calls = [lambda f=f: ntt_cuda.coset_leaves(f[0], f[1], 7, size, a) for f in fs]
        coset_calls = [lambda f=f: ntt_cuda.transform(f.view(2 * b, n_in), "coset_ntt",
                                                       shift=7, size=size) for f in fs]
        g = graph_ms(calls)
        beside = paired_ms(coset_calls, calls)   # "ms": the coset NTT, "parent_ms": the leaf mode
        nbytes, muls = k4_work("coset_ntt", (2, b, n_in), size)
        bound, by = k4_bound_ms(nbytes, muls)
        log_n1 = ntt_cuda.leaf_plan(size)
        sms_lib = ntt_cuda._sm_count(ntt_cuda._lib(), dev0)
        cols = ntt_cuda.tiles(2 * b, size, log_n1, sms_lib, leaf=True)
        launches = [{"log_len": lg, "blocks": nb, "threads": t, "smem_bytes": sm,
                     "blocks_per_sm": ntt_cuda.occupancy("cuda:0", lg, t, sm),
                     "blocks_per_sm_of_card": nb / sms}
                    for lg, (nb, t, sm) in zip(ntt_cuda.pass_logs(size, log_n1),
                                               ntt_cuda.launch_shape(2 * b, size, log_n1, cols,
                                                                     leaf=True))]
        coset_ms = statistics.median(beside["ms"])
        rows_out.append({
            "shape": name, "mode": ntt_cuda.LEAF_MODE, "input": [2, b, n_in], "points": size,
            "arity_bits": a, "leaves": [b, size >> a, 2 << a],
            "launches_per_call": 2 if log_n1 else 1,
            "factors": list(ntt_cuda.split(size)) if log_n1 else None, "log_cols": list(cols),
            "launch": launches, **g, "before_ms": None, "ms_over_before": None,
            "coset_ntt_same_rows": {"ms": beside["ms"], "leaf_mode_ms": beside["parent_ms"],
                                    "ms_range": beside["ms_range"],
                                    "leaf_mode_ms_range": beside["parent_ms_range"],
                                    "log_cols": list(ntt_cuda.tiles(2 * b, size, log_n1,
                                                                    sms_lib))},
            "ms_over_coset_ntt": statistics.median(beside["parent_ms"]) / coset_ms,
            "plain_ms": cuda_ms(lambda: k4_leaf_plain(fs[0], size, a), reps=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "muls": muls,
            "share_of_bound": bound / g["ms"], "library_ms": None,
            "host_us_per_call": host_us_per_call(calls[0]),
            "paired_with_parent": paired_ms(calls, [
                lambda f=f: parent_fd._commit_codeword(f[0], f[1], 7, size, a) for f in fs])
            if parent_fd is not None else None})
        del fs, calls, coset_calls
    emit({"phase": "k4_time", "int32_mul_per_s": INT32_MUL_PER_S,
          "hbm_bytes_per_s": HBM_BYTES_PER_S, "sms": sms,
          "timing": f"ms: CUDA events around the replay of a CUDA graph of {K4_TIMED_CALLS} "
                    f"calls on inputs of their own, L2 emptied first, per call, median of 8 "
                    f"replays (min_ms/max_ms: their range); before_ms: the first, radix-2 "
                    f"K4 at the same shape (PERF.md); plain_ms: CUDA events "
                    f"around one call of the plain version (ntt/ntt.py's stage loop), median "
                    f"of 3; host_us_per_call: perf_counter around 100 wrapper calls; "
                    f"launch: each launch's blocks, threads and shared bytes "
                    f"(ntt_cuda.launch_shape) and resident blocks an SM "
                    f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor); library_ms: none, no "
                    f"PyTorch call computes a Goldilocks NTT; the coset_leaves rows: K4's "
                    f"leaf mode, plain_ms the stage loop and the regroup, paired_with_parent "
                    f"paired_ms against the parent's leaf mode (its fri_device."
                    f"_commit_codeword), coset_ntt_same_rows paired_ms of K4's coset NTT of "
                    f"the same 2 B rows to the same size (leaf, coset, coset, leaf), "
                    f"ms_over_coset_ntt the ratio of their medians",
          "rows": rows_out, "sass": kernel_sass_counts(
              ntt_cuda.build(), ntt_cuda.build_log, "k4_kernel",
              key=lambda name: "L" + re.match(r"_Z\d+k4_kernelILi(\d+)E", name).group(1))})
    over = [r for r in rows_out if r["share_of_bound"] > 1.05]
    if over:
        raise AssertionError(f"K4 timed below its bound: {over}")
    main = next(r for r in rows_out if r["shape"] == "wires_lde")   # the kernels line's figure
    state.setdefault("kernels", []).append({
        "name": "goldilocks_ntt", "route": "cuda", "source": K4_SOURCE,
        "replaces": K4_REPLACES + " (ntt_mxu, with _gf_dot_matrix at :122; reached through "
                                  "ntt/ntt.py:172 _use_mxu and :198 ntt; no Pallas kernel)",
        "launches": state["k4_launches"], "launches_by_mode": state["k4_launches_by_mode"],
        "launches_by_path": {"wormhole": state["k4_launches"],
                             "batch": state["k4_launches_batch"],
                             "sharded": state["k4_launches_sharded"]},
        "max_abs_err": state["k4_max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "ms_by_shape": {r["shape"]: r["ms"] for r in rows_out}})


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
            k56 = quotient_launches()
            fri = fri_launches()
            with host_witness_calls() as host_witnesses, \
                    plain_quotient_on_card() as plain_quotient, plain_fri_on_card() as plain_fri, \
                    plain_gather_on_card() as plain_gather:
                out, secs = _synced(lambda: real(self, proofs, inner_vo, *args, **kw))
            outs = out if isinstance(out, list) else [out]
            records.append({
                "level": self, "inputs": (list(proofs), inner_vo), "batch": len(outs),
                "s": secs, "host_witnesses": len(host_witnesses),
                "k1": {k: v - k1[k] for k, v in poseidon_cuda.launches_by_mode.items()},
                "k3": {k: v - k3[k] for k, v in witness_cuda.launches_by_kernel.items()},
                "k5_k6": [a - b for a, b in zip(quotient_launches(), k56)],
                "plain_quotient": len(plain_quotient), "k7_k9": fri_since(fri),
                "plain_fri": len(plain_fri) + len(plain_gather),
                "sweeps": max(p.proof.opening_proof.pow_witness for p in outs) // GRIND_ROWS + 1,
                "pow_sweeps": [p.proof.opening_proof.pow_witness // GRIND_ROWS + 1
                               for p in outs]})
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
        reset_quotient_launches()
        reset_fri_launches()
        agg, root, cold_s = aggregate()
        _, warm_root, warm_s = aggregate()
        k1_launches = pc.launches           # the aggregate path ends here
        k1_by_mode = dict(pc.launches_by_mode)
        k3_launches = witness_cuda.launches
        k5_launches, k6_launches = quotient_launches()
        fri_all = fri_launches()
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
        fri_want = expected_fri_launches(lc.circuit_data.common)
        k1 = r["k1"]
        if (k1["tree"], k1["top"], k1["sponge"]) != (want["tree"], want["top"], r["sweeps"]) \
                or r["k3"] != k3_want or r["host_witnesses"] \
                or tuple(r["k5_k6"]) != expected_quotient_launches(lc.circuit_data.common) \
                or r["plain_quotient"] or r["k7_k9"] != fri_want or r["plain_fri"]:
            raise AssertionError(f"aggregate level {i % depth + 1}: K1 {k1} (want {want}, "
                                 f"{r['sweeps']} sweeps), K3 {r['k3']} (want {k3_want}), "
                                 f"{r['host_witnesses']} host witnesses, K5/K6 {r['k5_k6']} "
                                 f"(want {expected_quotient_launches(lc.circuit_data.common)}), "
                                 f"K7-K10 {r['k7_k9']} (want {fri_want}), "
                                 f"{r['plain_quotient']} plain quotient and {r['plain_fri']} "
                                 f"plain FRI bodies or gathers on the card")
        proves.append({"run": "cold" if i < depth else "warm", "level": i % depth + 1,
                       "batch": r["batch"], "s": r["s"], "agg_level_prove_s": level_prove_s[i],
                       "k1_launches_by_mode": k1, "k1_expected": want, "sweeps": r["sweeps"],
                       "k3_launches_by_kernel": r["k3"], "k3_expected": k3_want,
                       "k5_k6_launches": r["k5_k6"], "k7_k9_launches": r["k7_k9"],
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
    level1_proofs, prof = profiled(lambda: lc1.prove_level(proofs, inner_vo))

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
    state["aggregate_launches"] = {"k1": k1_launches, "k3": k3_launches, "k5": k5_launches,
                                   "k6": k6_launches, **fri_all}
    state["level1_cd"] = lc1.circuit_data   # the level-1 shapes of k5_check to fri_time
    state["level1_proof"] = level1_proofs[0]
    state["aggregate_warm_s"] = warm_s
    state["aggregate_warm_level_s"] = {p["level"]: p["s"] for p in proves if p["run"] == "warm"}
    emit({"phase": "aggregate", "config": "standard_recursion_zk_config",
          "tree": {"branching_factor": AGG_CONFIG[0], "depth": depth, "leaves": leaves,
                   "pushed": AGG_PUSHES},
          "sha256": digest, "golden": True, "verified": True, "tamper_rejected": True,
          "leaves_extracted": len(extracted), "root_proof_bytes": len(data),
          "level_circuits": circuits, "cold_aggregate_s": cold_s, "warm_aggregate_s": warm_s,
          "level_proves": proves, "k1_launches": k1_launches, "k1_launches_by_mode": k1_by_mode,
          "k3_launches": k3_launches, "k5_launches": k5_launches, "k6_launches": k6_launches,
          "k7_k9_launches": fri_all, "plain_fri_on_card": 0, "plain_gather_on_card": 0,
          "host_witnesses": 0, "plain_quotient_on_card": 0,
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


def gl_random(gen, shape):
    """Canonical random field elements of ``shape`` on the card."""
    import torch

    from zk_circuits_torch.field import goldilocks as gf

    return gf.canon(torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen,
                                  device="cuda", dtype=torch.int64))


def gl_full(shape, value: int):
    import torch

    return torch.full(shape, value - (1 << 64) if value >= 1 << 63 else value,
                      dtype=torch.int64, device="cuda")


def k5_inputs(common, gen, batch: int, points: int | None = None, value=None) -> dict:
    """A K5 call's inputs on the card at the first ``points`` rows of the
    coset (all of them by default): the circuit's cs (k, points), the
    proofs' wires (B, W + 4, points) and zsp (B, nc (1 + pp) + 4, points)
    (their salt rows, which K5 does not read), the coset tables, the pi
    hashes (B, 1, 4) and the challenges (nc, B, 1): seeded from ``gen``, or
    every value ``value``."""
    from zk_circuits_torch.plonk.prover import _coset_tables

    cfg = common.config
    nc, points = cfg.num_challenges, points or common.lde_size
    pp = -(-cfg.num_routed_wires // common.quotient_degree_factor) - 1

    def draw(*shape):
        return gl_random(gen, shape) if value is None else gl_full(shape, value)

    return dict(cs=draw(common.num_constants_sigmas_polys, points),
                wires=draw(batch, cfg.num_wires + 4, points),
                zsp=draw(batch, nc * (1 + pp) + 4, points),
                tables=tuple(t[:points] for t in _coset_tables(common, "cuda")),
                pi_hash=draw(batch, 1, 4), betas=draw(nc, batch, 1), gammas=draw(nc, batch, 1),
                alphas=draw(nc, batch, 1))


def k5_call(common, inp: dict, **kw):
    from zk_circuits_torch.plonk import quotient_cuda

    return quotient_cuda.vanishing(common, inp["cs"], inp["wires"], inp["zsp"], inp["tables"],
                                   inp["pi_hash"], inp["betas"], inp["gammas"], inp["alphas"],
                                   **kw)


def k5_plain(common, inp: dict):
    """K5's plain version: plonk/prover.py's _device_vanishing_eval times
    1/Z_H, (nc, B, points)."""
    import torch

    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.plonk.prover import _device_vanishing_eval

    x, l1, zh_inv = inp["tables"]
    vans = _device_vanishing_eval(common, inp["cs"].t(), inp["wires"].transpose(-1, -2),
                                  inp["zsp"].transpose(-1, -2), x, l1, inp["pi_hash"],
                                  inp["betas"], inp["gammas"], inp["alphas"])
    return gf.mul(torch.stack(vans), zh_inv)


def k5_products(common) -> int:
    """64x64 products of one point of one proof in K5 (csrc/quotient.cuh
    k5_point), from the circuit's table: a challenge's L1 term, 4 a routed
    wire less 2 a chunk (a chunk's first factors start its products), 3 a
    chunk term and the scaling by alpha^M; a gate's own products (an
    arithmetic op 3, an extension op 9, a base-sum limb's booleanity 1, a
    random-access copy bits + 2^bits - 1, Poseidon 5 and 118 S-boxes of 4),
    its filter's terms less one, and per challenge one a constraint of the
    fold and two for the filter and the power of alpha; then 1/Z_H, one a
    challenge.  The block's tables (powers of alpha, beta k_j: a few
    products a point) are left out."""
    from zk_circuits_torch.plonk import quotient_cuda as qc

    blob = qc.circuit_blob(common)
    routed, chunks = int(blob[3]), int(blob[5])
    nc = common.config.num_challenges
    total = nc * (2 + 4 * routed - 2 * chunks + 3 * chunks) + nc
    own = {1: lambda p0, p1: 0, 2: lambda p0, p1: 0, 3: lambda p0, p1: 3 * p0,
           4: lambda p0, p1: p0, 5: lambda p0, p1: 9 * p0,
           6: lambda p0, p1: p1 * (p0 + (1 << p0) - 1), 7: lambda p0, p1: 5 + 118 * 4}
    recs = blob[qc.HEAD + routed:].reshape(-1, qc.GATE_FIELDS)
    for gate, rec in zip(common.gate_types, recs):
        kind, p0, p1, nf = (int(v) for v in (rec[0], rec[1], rec[2], rec[4]))
        if kind == 0:
            continue
        total += own[kind](p0, p1) + max(nf - 1, 0) + nc * (gate.num_constraints + 2)
    return total


def k5_work(common, batch: int, points: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one K5 call: the rows it reads once
    (the circuit's cs; a proof's wires up to the last any gate or the
    permutation argument uses, its zs and partial products; the three
    coset tables; the pi hashes and challenges) and its output written
    once; ``k5_products`` a point a proof at 8 multiplies each."""
    cfg = common.config
    nc = cfg.num_challenges
    pp = -(-cfg.num_routed_wires // common.quotient_degree_factor) - 1
    wires = max([cfg.num_routed_wires] + [g.num_wires_used for g in common.gate_types])
    rows = common.num_constants_sigmas_polys + 3 + batch * (wires + nc * (1 + pp) + nc)
    nbytes = 8 * points * rows + 8 * batch * (4 + 3 * nc)
    return nbytes, batch * points * k5_products(common) * K4_MULS_PER_PRODUCT


def k5_gate_common(gates: list, cfg, degree_bits: int):
    """The port's CommonCircuitData of a circuit of these gate types at
    2^degree_bits rows, with build_circuit_data's sort, selector groups
    and filters: K5's table over them without building a circuit (as
    tests/test_torch_quotient_kernel.py makes its commons)."""
    from zk_circuits_torch.host import gl
    from zk_circuits_torch.plonk import circuit_data as cd

    gate_types = sorted(gates, key=lambda g: (-g.degree, g.id))
    groups = cd._selector_groups(gate_types, cfg.max_quotient_degree_factor)
    return cd.CommonCircuitData(
        config=cfg, degree_bits=degree_bits, gate_types=gate_types, selector_groups=groups,
        gate_to_group={gate_types[gi].id: k for k, grp in enumerate(groups) for gi in grp},
        gate_to_index={g.id: i for i, g in enumerate(gate_types)},
        num_gate_constraints=max(g.num_constraints for g in gate_types), num_public_inputs=0,
        k_is=gl.powers(gl.MULTIPLICATIVE_GROUP_GENERATOR, cfg.num_routed_wires))


def k5_gate_tables(common) -> list:
    """(name, common) of K5's per-gate split at the wormhole's shape (its
    config and degree): the wormhole's gate types, then tables of one
    gate kind each beside a NoopGate (the level circuits' extension and
    random-access gates among them), and the NoopGate alone (the L1 term,
    the permutation argument and the scaling, which every table pays)."""
    from zk_circuits_torch.iop import gates as G

    one = [("poseidon", G.PoseidonGate()), ("arithmetic_20", G.ArithmeticGate(num_ops=20)),
           ("base_sum_32", G.BaseSum2Gate(num_limbs=32)),
           ("base_sum_5", G.BaseSum2Gate(num_limbs=5)),
           ("constant_2", G.ConstantGate(num_consts=2)), ("public_input", G.PublicInputGate()),
           ("arithmetic_extension_10", G.ArithmeticExtensionGate(num_ops=10)),
           ("random_access_4x4", G.RandomAccessGate(bits=4, num_copies=4))]
    cfg, bits = common.config, common.degree_bits
    return ([("wormhole", common)] +
            [(name, k5_gate_common([gate, G.NoopGate()], cfg, bits)) for name, gate in one] +
            [("noop", k5_gate_common([G.NoopGate()], cfg, bits))])


def five_challenges(common):
    """``common`` with its config at five challenges (K5 and K6 in two
    groups), no circuit built."""
    import dataclasses

    cfg = dataclasses.replace(common.config, num_challenges=5)
    return k5_gate_common(list(common.gate_types), cfg, common.degree_bits)


def k5_cases(state) -> list:
    """(name, circuit data, proofs) of the shapes K5 serves: one wormhole
    proof, a batch of BATCH, and a level-1 aggregation prove (a batch of
    4 of a 2^14-row level circuit with arithmetic-extension and
    random-access gates)."""
    cd = state["wormhole"][0]
    return [("wormhole", cd, 1), ("wormhole_batch", cd, BATCH),
            ("level1_batch", state["level1_cd"], AGG_CONFIG[0] ** (AGG_CONFIG[1] - 1))]


def phase_k5_check(state) -> None:
    """K5 against its plain version on the card, equal integers: the
    wormhole's shape alone and at B=BATCH, the level-1 circuit's at its
    batch, the sharded path's E=SHARDS calls (a shard's rows, row0 and its
    halo) against the whole coset, and inputs of 0, 1 and p - 1."""
    import torch

    from zk_circuits_torch.plonk import quotient_cuda

    gen = torch.Generator(device="cuda").manual_seed(2041)
    before = quotient_cuda.launches
    checked = []

    def check(name, common, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"k5_check/{name}: K5 {tuple(got.shape)} != its plain version")
        checked.append({"name": name, "shape": list(got.shape),
                        "gates": [g.id for g in common.gate_types]})

    for name, data, batch in k5_cases(state):
        common = data.common
        inp = k5_inputs(common, gen, batch)
        check(name, common, k5_call(common, inp), k5_plain(common, inp))
        del inp
    common = state["wormhole"][0].common
    nc, rate = common.config.num_challenges, 1 << common.config.rate_bits
    inp = k5_inputs(common, gen, 1)
    whole = k5_plain(common, inp)[:, 0]
    r = common.lde_size // SHARDS
    zsp = inp["zsp"][0]
    for d in range(SHARDS):                  # plonk/prover_sharded.py's calls
        rows = slice(d * r, (d + 1) * r)
        nxt = (d + 1) % SHARDS * r
        zs_next = torch.cat([zsp[:nc, d * r + rate:(d + 1) * r], zsp[:nc, nxt:nxt + rate]], 1)
        got = quotient_cuda.vanishing(
            common, inp["cs"][:, rows], inp["wires"][0][:, rows], zsp[:, rows], inp["tables"],
            inp["pi_hash"][:1], inp["betas"], inp["gammas"], inp["alphas"], zs_next=zs_next,
            row0=d * r)
        check(f"sharded_{d}_of_{SHARDS}", common, got, whole[:, rows])
    for value in (0, 1, P - 1):
        inp = k5_inputs(common, gen, 2, 1 << 12, value=value)
        check(f"constant_{value}", common, k5_call(common, inp), k5_plain(common, inp))
    five = five_challenges(common)             # two launches: challenges 0-3, then 4
    inp = k5_inputs(five, gen, 3)
    check("five_challenges", five, k5_call(five, inp), k5_plain(five, inp))
    for name, table in k5_gate_tables(common)[1:]:   # k5_time's per-gate tables
        inp = k5_inputs(table, gen, 1, 1 << 12)
        check(f"gate_{name}", table, k5_call(table, inp), k5_plain(table, inp))
    state["k5_max_abs_err"] = 0
    emit({"phase": "k5_check", "equal_integers": True, "cases": checked,
          "launches": quotient_cuda.launches - before})


def k6_inputs(data, gen, batch: int, zero_den: bool = False, value=None, zeros=(),
              n: int | None = None) -> dict:
    """A K6 call's inputs on the card: seeded wire values on H (B, routed,
    n), the circuit's sigmas and subgroup, seeded challenges (nc, B, 1);
    with ``zero_den`` one denominator of proof 0, challenge 0, wire 13,
    point 77 set to 0, and one for each (proof, challenge, wire, point) of
    ``zeros``; every value ``value`` when it is given; seeded sigmas and
    points for ``n`` points (the circuit's degree by default) or where the
    circuit's sigmas do not fit its routed wires."""
    from zk_circuits_torch.field import goldilocks as gf

    common, po = data.common, data.prover_only
    cfg = common.config
    nc, routed = cfg.num_challenges, cfg.num_routed_wires
    own = n is None and po.sigmas_values.shape[0] == routed
    n = common.degree if n is None else n

    def draw(*shape):
        return gl_random(gen, shape) if value is None else gl_full(shape, value)

    inp = dict(wv=draw(batch, routed, n), betas=draw(nc, batch, 1), gammas=draw(nc, batch, 1))
    if own and value is None:
        inp["sig"], inp["x"] = (gf.from_u64(po.sigmas_values, "cuda"),
                                gf.from_u64(po.subgroup, "cuda"))
    else:
        inp["sig"], inp["x"] = draw(routed, n), draw(n)
    for b, c, j, i in ([(0, 0, 13, 77)] if zero_den else []) + list(zeros):
        den = gf.add(gf.mul(inp["betas"][c, b], inp["sig"][j, i:i + 1]), inp["gammas"][c, b])
        inp["wv"][b, j, i] = gf.neg(den)[0]
    return inp


def k6_call(data, inp: dict, **kw):
    from zk_circuits_torch.plonk import permutation_cuda

    return permutation_cuda.products(data.common, inp["wv"], inp["sig"], inp["x"],
                                     inp["betas"], inp["gammas"], **kw)


def k6_point_launch(data, inp: dict):
    """K6's point kernel alone on a call of its own (k6_time's point_ms):
    the Z row holds each point's total and the partial-product rows its
    running ratios, not yet scanned; counts no launch."""
    import ctypes

    import torch

    from zk_circuits_torch.plonk import permutation_cuda

    calls, out, _ = permutation_cuda._prepare(data.common, inp["wv"], inp["sig"], inp["x"],
                                              inp["betas"], inp["gammas"])
    for call in calls:
        err = permutation_cuda._lib().k6_products(0, ctypes.byref(call), 0,
                                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k6_products (the point kernel) failed: CUDA error {err}")
    return out


def k6_plain(data, inp: dict):
    from zk_circuits_torch.plonk.prover import _zs_values_plain

    return _zs_values_plain(data.common, inp["wv"], inp["sig"], inp["x"], inp["betas"],
                            inp["gammas"])


def k6_point_products(common, tile: int | None = None) -> int:
    """64x64 products at one point of one proof, every challenge: a
    challenge costs 3 a routed wire less 2 a chunk (beta s_j and the chunk
    products, whose first factor starts them) and beta k_j x, one product
    where the coset shifts are powers of the generator, k_j = 7^j (7 times the
    previous wire's is a shift and a subtract) and else one a wire; 2 a
    chunk (its ratio and the running product), and in the scan 2 and one a
    partial product.  The point's nc x chunks denominators are inverted as
    the function needs it: one batch inversion (3 products an element less
    3, and one inverse, K6_INVERSE_PRODUCTS) with each zero put as 1 and
    its inverse masked back to 0.  With ``tile`` (its points a block): what
    K6 spends (csrc/permutation.cuh): beta k_j x a wire, a batch inversion
    a challenge (the prefix products of num and den, an inverse, then a
    ratio and the next inverse a chunk: 4 a chunk less 3, and one inverse)
    and the tile's Hillis-Steele scan (log2 tile products) before Z."""
    from zk_circuits_torch.host import gl

    cfg = common.config
    nc, routed, q = cfg.num_challenges, cfg.num_routed_wires, common.quotient_degree_factor
    chunks = -(-routed // q)
    pow7 = [int(k) for k in common.k_is] == [int(k) for k in gl.powers(7, routed)]
    if tile is not None:
        return nc * (4 * routed - 2 * chunks + K6_INVERSE_PRODUCTS + 4 * chunks - 3 +
                     tile.bit_length() - 1 + 1 + chunks - 1)
    kx = 1 if pow7 else routed
    per = nc * (3 * routed + kx - 2 * chunks + 2 * chunks + 2 + (chunks - 1))
    return per + 3 * (nc * chunks - 1) + K6_INVERSE_PRODUCTS


def k6_tile(common, batch: int) -> int:
    """The points a block K6 takes for ``batch`` proofs of ``common`` on
    this card (permutation_cuda.tile_shape)."""
    import torch

    from zk_circuits_torch.plonk import permutation_cuda

    lib = permutation_cuda._lib()
    sms = permutation_cuda._sm_count(torch.device("cuda", 0), lib)
    return permutation_cuda.tile_shape(common, common.degree, batch, sms, lib)[0]


def k6_work(common, batch: int) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one K6 call: the wire values, sigmas,
    subgroup and challenges read once, the Z and partial-product rows and
    the closing products written once; k6_point_products at each point of
    each proof, 8 multiplies a product.  (The scan's threads' own scan, a
    few hundred products a block, is left out.)"""
    cfg = common.config
    nc, routed, n = cfg.num_challenges, cfg.num_routed_wires, common.degree
    chunks = -(-routed // common.quotient_degree_factor)
    rows = routed + 1 + batch * (routed + nc * chunks)
    nbytes = 8 * n * rows + 8 * batch * 3 * nc
    return nbytes, batch * n * k6_point_products(common) * K4_MULS_PER_PRODUCT


def phase_k6_check(state) -> None:
    """K6 against its plain version on the card, equal integers: the
    wormhole's shape alone, at B=BATCH and unbatched (the sharded prover's
    call), the level-1 circuit's at its batch, a zero denominator in one
    chunk, inputs of 0, 1 and p - 1, five challenges, zeros where the
    batch inversion masks them and at the tiles' edges, n not a multiple of
    the tile, a short and an odd last chunk."""
    import dataclasses

    import torch

    from zk_circuits_torch.plonk import permutation_cuda

    gen = torch.Generator(device="cuda").manual_seed(2042)
    before = permutation_cuda.launches
    cd = state["wormhole"][0]
    checked = []

    def check(name, data, inp, unbatched=False):
        if unbatched:
            inp = dict(inp, wv=inp["wv"][0], betas=inp["betas"][:, :1], gammas=inp["gammas"][:, :1])
        got, finals = k6_call(data, inp)
        want, want_finals = k6_plain(data, inp)
        torch.cuda.synchronize()
        if got.shape != want.shape or not (torch.equal(got, want) and
                                           torch.equal(finals, want_finals)):
            raise AssertionError(f"k6_check/{name}: K6 {tuple(got.shape)} != its plain version")
        checked.append({"name": name, "values": list(got.shape), "finals": list(finals.shape)})
        return got, finals

    for name, data, batch in k5_cases(state):
        check(name, data, k6_inputs(data, gen, batch))
    check("unbatched", cd, k6_inputs(cd, gen, 1), unbatched=True)
    got, finals = check("zero_denominator", cd, k6_inputs(cd, gen, 2, zero_den=True))
    if int(finals[0, 0]) != 0 or int(got[0, 0, 78:].abs().sum()) != 0:
        raise AssertionError("k6_check/zero_denominator: the zero did not close the scan")
    for value in (0, 1, P - 1):
        check(f"constant_{value}", cd, k6_inputs(cd, gen, 2, value=value))
    five = types.SimpleNamespace(common=five_challenges(cd.common), prover_only=cd.prover_only)
    check("five_challenges", five, k6_inputs(five, gen, 3))
    check("five_challenges_zero_denominator", five, k6_inputs(five, gen, 2, zero_den=True))
    # the batch inversion's masked zeros and the tiles (as
    # tests/test_torch_quotient_kernel.py's): zeros in two chunks of a
    # point, in each challenge, at the first and last point of a tile;
    # n not a multiple of the tile; a short and an odd last chunk
    last, tile = cd.common.degree - 1, k6_tile(cd.common, 2)
    for name, zeros, n in (("zeros_two_chunks_one_point", [(1, 0, 17, 37), (1, 0, 50, 37)], None),
                           ("zero_each_challenge", [(0, 0, 3, 10), (0, 1, 70, 40),
                                                    (1, 1, 79, last)], None),
                           ("zeros_tile_edges", [(0, 0, 5, tile), (0, 1, 44, 2 * tile - 1),
                                                 (1, 0, 9, 2 * tile), (1, 1, 60, last)], None),
                           ("n_1000", [(0, 1, 21, 999), (1, 0, 0, 992)], 1000)):
        got, finals = check(name, cd, k6_inputs(cd, gen, 2, zeros=zeros, n=n))
        for b, c, j, i in zeros:
            if int(finals[b, c]) != 0 or int(got[b, c, i + 1:].abs().sum()) != 0:
                raise AssertionError(f"k6_check/{name}: the zero at {(b, c, j, i)} did not "
                                     f"close the scan")
    for routed in (78, 77):
        cfg = dataclasses.replace(cd.common.config, num_routed_wires=routed)
        short = types.SimpleNamespace(common=k5_gate_common(list(cd.common.gate_types), cfg,
                                                            cd.common.degree_bits),
                                      prover_only=cd.prover_only)
        check(f"last_chunk_of_{routed % 8}", short, k6_inputs(short, gen, 2, zero_den=True))
    state["k6_max_abs_err"] = 0
    emit({"phase": "k6_check", "equal_integers": True, "cases": checked,
          "launches": permutation_cuda.launches - before})


def kernel_sass_counts(lib_path, build_log: str, prefix: str, key=None) -> dict:
    """Per kernel (mangled name starting ``_Z..prefix``) of a built
    library, under ``key(name)`` (the name itself by default): its
    instruction count and IMAD.WIDE, IMAD.HI, LDG, STG, LDS, STS, local
    (spill) and barrier counts from cuobjdump -sass, and its registers and
    spill bytes from ptxas (``build_log``, the output of this process's
    build)."""
    import collections

    key = key or (lambda name: name)
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120).stdout
    out = {}
    for name, ins in sass_functions(text).items():
        if not re.match(rf"_Z\d+{prefix}", name):
            continue
        ops = collections.Counter(op for _, op, _ in ins)
        out[key(name)] = {"instructions": len(ins), **{
            k: sum(v for op, v in ops.items() if op.startswith(k))
            for k in ("IMAD.WIDE", "IMAD.HI", "LDG", "STG", "LDS", "STS", "LDL", "STL", "BAR")}}
    if not out:
        raise AssertionError(f"no {prefix} kernel in the SASS of {lib_path}")
    kernel = None
    for ln in build_log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        kernel = key(m.group(1)) if m and re.match(rf"_Z\d+{prefix}", m.group(1)) else (
            None if m else kernel)
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel in out:
            out[kernel]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and kernel in out:
            out[kernel]["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
    return out


def quotient_time_rows(state, kernel: str) -> list:
    """graph_ms rows of K5 or K6 at k5_cases' shapes: each beside its plain
    version (one call, CUDA events, median of 3), its bound (k5_work or
    k6_work) and the host time of a wrapper call."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2043 if kernel == "k5" else 2044)
    rows = []
    for name, data, batch in k5_cases(state):
        common = data.common
        if kernel == "k5":
            ins = [k5_inputs(common, gen, batch) for _ in range(K5_TIMED_CALLS)]
            fn, plain = k5_call, k5_plain
            nbytes, muls = k5_work(common, batch, common.lde_size)
            arg = common
            shape = {"points": common.lde_size, "batch": batch}
        else:
            ins = [k6_inputs(data, gen, batch) for _ in range(K6_TIMED_CALLS)]
            fn, plain = k6_call, k6_plain
            nbytes, muls = k6_work(common, batch)
            arg = data
            shape = {"points": common.degree, "batch": batch}
        g = graph_ms([lambda i=i: fn(arg, i) for i in ins])
        if kernel == "k6":   # the point kernel alone; the scan is the rest
            g["point_ms"] = graph_ms([lambda i=i: k6_point_launch(arg, i) for i in ins])["ms"]
            g["scan_ms"] = g["ms"] - g["point_ms"]
        plain_ms = cuda_ms(lambda: plain(arg, ins[0]), reps=3, warmup=1)
        bound, by = k4_bound_ms(nbytes, muls)
        rows.append({"shape": name, **shape, "gates": [g_.id for g_ in common.gate_types],
                     **g, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "bytes": nbytes, "muls": muls, "share_of_bound": bound / g["ms"],
                     "library_ms": None,
                     "host_us_per_call": host_us_per_call(lambda: fn(arg, ins[0]))})
        del ins
    over = [r for r in rows if r["share_of_bound"] > 1.05]
    if over:
        raise AssertionError(f"{kernel} timed below its bound: {over}")
    return rows


def k5_gate_split(state) -> list:
    """K5's graph_ms at the wormhole's shape (one proof, 2^16 points) on each
    of k5_gate_tables' tables, with the parent's beside it (paired_ms)
    where the parent is at hand, and each table's products a point."""
    import torch

    parent = parent_kernels().get("k5")
    gen = torch.Generator(device="cuda").manual_seed(2045)
    rows = []
    for name, common in k5_gate_tables(state["wormhole"][0].common):
        ins = [k5_inputs(common, gen, 1) for _ in range(K5_TIMED_CALLS)]
        calls = [lambda i=i: k5_call(common, i) for i in ins]
        row = {"table": name, "gates": [g.id for g in common.gate_types],
               "products_per_point": k5_products(common)}
        if parent is None:
            row.update(graph_ms(calls))
        else:
            row.update(paired_ms(calls, [lambda i=i: parent.vanishing(
                common, i["cs"], i["wires"], i["zsp"], i["tables"], i["pi_hash"], i["betas"],
                i["gammas"], i["alphas"]) for i in ins]))
        rows.append(row)
        del ins, calls
    return rows


def k5_paired(state) -> list:
    """K5 against the parent's at k5_cases' shapes, paired_ms on the same
    inputs (empty without the parent)."""
    import torch

    parent = parent_kernels().get("k5")
    if parent is None:
        return []
    gen = torch.Generator(device="cuda").manual_seed(2046)
    rows = []
    for name, data, batch in k5_cases(state):
        common = data.common
        ins = [k5_inputs(common, gen, batch) for _ in range(K5_TIMED_CALLS)]
        rows.append({"shape": name, "batch": batch, **paired_ms(
            [lambda i=i: k5_call(common, i) for i in ins],
            [lambda i=i: parent.vanishing(common, i["cs"], i["wires"], i["zsp"], i["tables"],
                                          i["pi_hash"], i["betas"], i["gammas"], i["alphas"])
             for i in ins])})
        del ins
    return rows


def phase_k5_time(state) -> None:
    """K5's device time (graph_ms) at k5_cases' shapes beside its plain
    version and bound, and beside the parent's kernel (paired_ms); its
    split by gate kind; registers, spills and SASS counts (the parent's
    too)."""
    from zk_circuits_torch.plonk import quotient_cuda

    rows = quotient_time_rows(state, "k5")
    parent = parent_kernels().get("k5")
    emit({"phase": "k5_time", "int32_mul_per_s": INT32_MUL_PER_S,
          "paired_with_parent": k5_paired(state), "gate_split": k5_gate_split(state),
          "parent": PARENT_COMMIT if parent else None,
          "parent_sass": kernel_sass_counts(parent.build(), parent.build_log, "k5_")
          if parent else None,
          "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "products_per_point": {r[0]: k5_products(r[1].common) for r in k5_cases(state)},
          "timing": f"ms: CUDA events around the replay of a CUDA graph of {K5_TIMED_CALLS} "
                    f"calls on inputs of their own, L2 emptied first, per call, median of 8 "
                    f"replays (min_ms/max_ms: their range); plain_ms: CUDA events around "
                    f"one call of the plain version (plonk/prover.py's "
                    f"_device_vanishing_eval times 1/Z_H), median of 3; host_us_per_call: "
                    f"perf_counter around 100 wrapper calls; library_ms: none, no PyTorch "
                    f"call computes the vanishing polynomial",
          "rows": rows, "sass": kernel_sass_counts(quotient_cuda.build(),
                                                   quotient_cuda.build_log, "k5_")})
    main = rows[0]
    state.setdefault("kernels", []).append({
        "name": "vanishing_quotient", "route": "cuda", "source": K5_SOURCE,
        "replaces": K5_REPLACES + " (_quotient_commit_body, jitted at :230, over "
                                  "plonk/vanishing.py:161 eval_vanishing; no Pallas kernel)",
        "launches": state["k5_launches"],
        "launches_by_path": {"wormhole": state["k5_launches"],
                             "batch": state["k5_launches_batch"],
                             "sharded": state["k5_launches_sharded"],
                             "aggregate": state["aggregate_launches"]["k5"]},
        "max_abs_err": state["k5_max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "ms_by_shape": {r["shape"]: r["ms"] for r in rows}})


def k6_paired(state) -> list:
    """K6 against the parent's at k5_cases' shapes, paired_ms on the same
    inputs, and the point kernels alone the same way (empty without the
    parent)."""
    import ctypes

    import torch

    from zk_circuits_torch.plonk import permutation_cuda as mine

    parent = parent_kernels().get("k6")
    if parent is None:
        return []
    gen = torch.Generator(device="cuda").manual_seed(2047)
    rows = []
    for name, data, batch in k5_cases(state):
        ins = [k6_inputs(data, gen, batch) for _ in range(K6_TIMED_CALLS)]

        def via(mod, i, data=data):
            return mod.products(data.common, i["wv"], i["sig"], i["x"], i["betas"], i["gammas"])

        def point(mod, i, data=data):   # k6_point_launch through mod
            calls, out, _ = mod._prepare(data.common, i["wv"], i["sig"], i["x"], i["betas"],
                                         i["gammas"])
            for call in calls:
                if mod._lib().k6_products(0, ctypes.byref(call), 0,
                                          torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("k6_products (the point kernel) failed")
            return out

        rows.append({"shape": name, "batch": batch, **paired_ms(
            [lambda i=i: via(mine, i) for i in ins], [lambda i=i: via(parent, i) for i in ins]),
            "point": paired_ms([lambda i=i: point(mine, i) for i in ins],
                               [lambda i=i: point(parent, i) for i in ins])})
        del ins
    return rows


def phase_k6_time(state) -> None:
    """K6's device time (graph_ms) at k5_cases' shapes beside its plain
    version and bound, and beside the parent's kernel (paired_ms, both
    launches and the point kernel alone); registers, spills and SASS
    counts (the parent's too)."""
    from zk_circuits_torch.plonk import permutation_cuda

    rows = quotient_time_rows(state, "k6")
    parent = parent_kernels().get("k6")
    emit({"phase": "k6_time", "int32_mul_per_s": INT32_MUL_PER_S,
          "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "paired_with_parent": k6_paired(state),
          "parent": PARENT_COMMIT if parent else None,
          "parent_sass": kernel_sass_counts(parent.build(), parent.build_log, "k6_")
          if parent else None,
          "products_per_point": {name: {"bound": k6_point_products(data.common),
                                        "kernel": k6_point_products(data.common, k6_tile(
                                            data.common, batch))}
                                 for name, data, batch in k5_cases(state)},
          "timing": f"ms: CUDA events around the replay of a CUDA graph of {K6_TIMED_CALLS} "
                    f"calls (two launches each) on inputs of their own, L2 emptied first, "
                    f"per call, median of 8 replays; point_ms: the same with the point "
                    f"kernel alone (scan_ms: the difference); paired_with_parent: this "
                    f"tree's and the parent's on the same inputs in turns (parent, this, "
                    f"this, parent), both launches and the point kernel alone; plain_ms: "
                    f"CUDA events around one call "
                    f"of the plain version (plonk/prover.py's _zs_values_plain), median of "
                    f"3; library_ms: none, no PyTorch call computes these products",
          "rows": rows, "sass": kernel_sass_counts(permutation_cuda.build(),
                                                   permutation_cuda.build_log, "k6_")})
    main = rows[0]
    state.setdefault("kernels", []).append({
        "name": "permutation_products", "route": "cuda", "source": K6_SOURCE,
        "replaces": K6_REPLACES + " (_zs_coeffs_body, jitted at :349; no Pallas kernel)",
        "launches": state["k6_launches"],
        "launches_by_path": {"wormhole": state["k6_launches"],
                             "batch": state["k6_launches_batch"],
                             "sharded": state["k6_launches_sharded"],
                             "aggregate": state["aggregate_launches"]["k6"]},
        "max_abs_err": state["k6_max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "ms_by_shape": {r["shape"]: r["ms"] for r in rows}})


def fri_widths(proof) -> tuple:
    """The four oracles' polynomials of a proof's circuit (constants/sigmas,
    wires, zs and partial products, quotient; salts included), from its
    opening set."""
    o = proof.proof.openings
    return tuple(len(x) for x in (o.constants_sigmas, o.wires, o.zs_partial_products,
                                  o.quotient))


def fri_cases(state) -> list:
    """(name, circuit common, oracle widths, proofs) of the shapes K7-K9
    serve on the main path: one wormhole proof, a batch of BATCH, and a
    level-1 aggregation prove (a batch of 4 at 2^14: three fold rounds,
    the last of arity 2)."""
    cd, level1 = state["wormhole"][0], state["level1_cd"]
    worm = fri_widths(state["wormhole_proof"])
    return [("wormhole", cd.common, worm, 1), ("wormhole_batch", cd.common, worm, BATCH),
            ("level1_batch", level1.common, fri_widths(state["level1_proof"]),
             AGG_CONFIG[0] ** (AGG_CONFIG[1] - 1))]


def fri_inputs(gen, widths, n: int, batch: int, num_zs: int, value=None) -> dict:
    """K7's and K8's inputs on the card for ``batch`` proofs of a circuit
    whose oracles hold ``widths`` polynomials of n coefficients: the
    prover's rows (the constants/sigmas (k, n), shared, the others (B, k,
    n); every row at zeta, row r of them taking alpha^r, then the first
    num_zs zs rows at g*zeta, alpha^0, ...), alpha (1, 2, B) and the
    points (3, 2, B): zeta, g*zeta and alpha^num_zs: seeded from ``gen``,
    or every value ``value``."""
    def draw(*shape):
        return gl_random(gen, shape) if value is None else gl_full(shape, value)

    sets = [draw(widths[0], n)] + [draw(batch, k, n) for k in widths[1:]]
    first = [sum(widths[:i]) for i in range(len(widths))]
    rows = [(x, 0, e) for x, e in zip(sets, first)] + [(sets[2][:, :num_zs], 1, 0)]
    return dict(rows=rows, alpha=draw(1, 2, batch), pts=draw(3, 2, batch))


def host_betas(gen, batch: int):
    """(batch, 2) canonical random ext elements on the host (K9 takes its
    betas there), seeded from the card's ``gen``."""
    from zk_circuits_torch.field import goldilocks as gf

    return gf.to_u64(gl_random(gen, (batch, 2)))


def fri_fold_inputs(gen, common, batch: int) -> list:
    """(arity bits, c pair (B, N), betas (B, 2) on the host, the round
    mode's (next arity bits, rate bits, next shift) or None) of each fold
    round of a proof of ``common`` (fri_rounds), seeded."""
    from zk_circuits_torch.host import gl

    rounds, rate = fri_rounds(common), common.config.fri_config.rate_bits
    out, shift = [], gl.MULTIPLICATIVE_GROUP_GENERATOR
    for r, (n, a, mode) in enumerate(rounds):
        shift = pow(shift, 1 << a, P)
        out.append((a, (gl_random(gen, (batch, n)), gl_random(gen, (batch, n))),
                    host_betas(gen, batch), (rounds[r + 1][1], rate, shift) if mode else None))
    return out


def fri_calls(inp: dict, plain: bool = False, kernels=None) -> dict:
    """K7's and K8's closures over ``inp`` (fri_inputs'), or their plain
    versions', or those of ``kernels`` (a fri_cuda module: the parent's):
    openings, the alpha reduction, the composition and all of K8's
    launches."""
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri import fri_device as fd

    kernels = kernels or fri_cuda
    op, red, comp = ((fd._openings_plain, fd._reduce_alpha_plain, fd._compose_plain) if plain
                     else (kernels.openings, kernels.reduce_alpha, kernels.compose))
    rows, pts, alpha = inp["rows"], inp["pts"], inp["alpha"]
    comp_in = red(rows, alpha)

    def compose(c):
        return comp(*c, pts)

    return {"k7": lambda: op(rows, pts[:2]), "k8_point": lambda: red(rows, alpha),
            "k8_scan": lambda: compose(comp_in), "k8": lambda: compose(red(rows, alpha))}


def fri_fold_call(case, plain: bool = False, parent=None):
    """A closure over K9's call on ``case`` (fri_fold_inputs'): its round
    mode or its fold mode, or their plain versions
    (``_fold_round_plain``, ``_fold_plain``), or those of ``parent`` (the
    parent port's fri/fri_device.py: its K9's round and fold modes, with
    the betas on the host)."""
    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri import fri_device as fd

    a, c, beta, nxt = case
    if not plain:
        k9 = parent or fri_cuda
        return (lambda: k9.fold_round(*c, beta, a, *nxt)) if nxt else \
            (lambda: k9.fold(*c, beta, a))
    b = gf.ext_pair(beta, c[0].device)   # the plain versions take tensors
    return (lambda: fd._fold_round_plain(*c, *b, a, *nxt)) if nxt else \
        (lambda: fd._fold_plain(*c, *b, a))


def _flat(out) -> list:
    """The tensors of a kernel's result (a pair, or a list of pairs)."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _flat(x)]


def fri_work(kernel: str, widths: tuple, n: int, batch: int, num_zs: int,
             arity_bits: int = 0, nxt: tuple | None = None) -> tuple[int, int]:
    """(bytes, 32-bit multiplies) of one call of a K7-K9 function, each
    input read once and each output written once, 8 multiplies a 64x64
    product (an extension product 4, its times 7 shifts and adds):
    k7, the openings: the oracles (the constants/sigmas once for the
    batch; the g*zeta rows are zs rows already read), the points, e (B, K +
    num_zs); a base product with each component a row coefficient, and
    the powers of both points (an extension product a power).  k8_point:
    the oracles, alpha, comp0 and comp1; the base products and alpha's
    powers (an extension product a row of a proof).
    k8_scan: comp0 and comp1 ((B, n) pairs) and the points in, f out; nine
    extension products a point (comp z^i twice, the two inverse powers,
    alpha^num_zs, the powers of both points and of their inverses) and
    two inverses a proof (FRI_INVERSE_PRODUCTS each).  k9_fold at
    ``arity_bits``: c (B, N) and the betas in, (B, N / A) out, A - 1
    extension products an output.  k9_round (``nxt``: next arity bits,
    rate bits, shift): k9_fold's, and the leaves (B, m', 2 A') out; and for
    each component of each proof the 2^rate_bits cosets' NTTs of N / A
    points with their shift powers (k4_work's coset_ntt products)."""
    k = sum(widths)
    oracle = 8 * n * (widths[0] + batch * (k - widths[0]))
    rows = batch * (k + num_zs)
    if kernel == "k7":
        return oracle + 32 * batch + 16 * rows, \
            (rows * n * 2 + batch * 2 * n * 4) * K4_MULS_PER_PRODUCT
    if kernel == "k8_point":
        return oracle + 16 * batch + 16 * batch * n * 2, \
            (rows * n * 2 + rows * 4) * K4_MULS_PER_PRODUCT
    if kernel == "k8_scan":
        return 16 * batch * n * 3 + 48 * batch, \
            batch * (n * 9 * 4 + 2 * FRI_INVERSE_PRODUCTS) * K4_MULS_PER_PRODUCT
    if kernel == "k8":
        b1, m1 = fri_work("k8_point", widths, n, batch, num_zs)
        b2, m2 = fri_work("k8_scan", widths, n, batch, num_zs)
        return b1 + b2, m1 + m2
    arity, m = 1 << arity_bits, n >> arity_bits
    nbytes = 16 * batch * (n + m) + 16 * batch
    muls = batch * m * (arity - 1) * 4 * K4_MULS_PER_PRODUCT
    if kernel == "k9_round":
        _, rate, _ = nxt
        nbytes += 16 * batch * (m << rate)
        muls += 2 * batch * (1 << rate) * k4_work("coset_ntt", (1, m), m)[1]
    return nbytes, muls


def phase_fri_check(state) -> None:
    """K7, K8 and K9 against their plain versions on the card, equal
    integers (see the module doc)."""
    import numpy as np
    import torch

    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.fri import fri_cuda
    from zk_circuits_torch.fri import fri_device as fd

    gen = torch.Generator(device="cuda").manual_seed(2051)
    before = fri_launches()
    checked = []

    def check(name, got, want):
        torch.cuda.synchronize()
        got, want = _flat(got), _flat(want)
        if len(got) != len(want) or not all(g.shape == w.shape and torch.equal(g, w)
                                            for g, w in zip(got, want)):
            raise AssertionError(f"fri_check/{name}: the kernel != its plain version")
        checked.append({"name": name, "shapes": [list(g.shape) for g in got]})

    def check_all(name, inp):
        kern, plain = fri_calls(inp), fri_calls(inp, plain=True)
        for k in ("k7", "k8_point", "k8_scan"):
            check(f"{name}/{k}", kern[k](), plain[k]())

    for name, common, widths, batch in fri_cases(state):
        nz = common.config.num_challenges
        check_all(name, fri_inputs(gen, widths, common.degree, batch, nz))
        for case in fri_fold_inputs(gen, common, batch):   # the round mode, then the last fold
            mode = "round" if case[3] else "fold"
            check(f"{name}/k9_{mode}_{case[0]}_bits_{case[1][0].shape[-1]}",
                  fri_fold_call(case)(), fri_fold_call(case, plain=True)())
    common = state["wormhole"][0].common
    widths, n, nz = fri_widths(state["wormhole_proof"]), common.degree, 2
    for value in (0, 1, P - 1):               # every input the same edge value
        check_all(f"constant_{value}", fri_inputs(gen, widths, n, 2, nz, value=value))
    inp = fri_inputs(gen, widths, n, 5, nz)   # each proof's points at an edge point
    edge = torch.tensor([[0, 1, P - 1 - (1 << 64), 0, P - 1 - (1 << 64)],
                         [0, 0, 0, 1, P - 1 - (1 << 64)]], dtype=torch.int64, device="cuda")
    inp["pts"], inp["alpha"] = torch.stack([edge, edge.flip(-1), edge]), edge[None]
    check_all("edge_points", inp)
    # K8's segments of 256 points (and K7 beside it): n not a multiple of
    # the segment or of the point kernel's tile, one short segment, a lone
    # point, more segments than a scan block's threads (its Horner stride
    # over the later segments), at B = 3
    for n_odd, batch in ((5000, 3), (100, 3), (1, 2), ((1 << 16) + 3 * 256 + 7, 1)):
        check_all(f"n_{n_odd}_b{batch}", fri_inputs(gen, (2, 3, 3, 2), n_odd, batch, nz))
    shift = pow(7, 16, P)                      # the wormhole's round-1 shift
    for a in (1, 2, 3, 4, 5, 6):              # every arity, batched and 1-D
        c = (gl_random(gen, (BATCH, n)), gl_random(gen, (BATCH, n)))
        beta = host_betas(gen, BATCH)
        b = gf.ext_pair(beta, "cuda")
        check(f"k9_{a}_bits", fri_cuda.fold(*c, beta, a), fd._fold_plain(*c, *b, a))
        one = (c[0][1], c[1][1])
        check(f"k9_{a}_bits_1d", fri_cuda.fold(*one, beta[1], a),
              fd._fold_plain(*one, b[0][1], b[1][1], a))
        check(f"k9_round_{a}_bits", fri_cuda.fold_round(*c, beta, a, 4, 3, shift),
              fd._fold_round_plain(*c, *b, a, 4, 3, shift))
    # the round mode at the edges: every coefficient and beta 0, 1 or p - 1,
    # and each group of cosets that folds once (1, 2, 4, 8 blocks of a
    # cluster) at the wormhole's round and at a 2^16 codeword; a strided
    # batch; more proofs than a launch's betas (two launches)
    for value in (0, 1, P - 1):
        c = (gl_full((2, n), value), gl_full((2, n), value))
        beta = np.full((2, 2), value, dtype=np.uint64)
        check(f"k9_round_constant_{value}", fri_cuda.fold_round(*c, beta, 4, 4, 3, shift),
              fd._fold_round_plain(*c, *gf.ext_pair(beta, "cuda"), 4, 4, 3, shift))
    for g in range(4):
        for size, a in ((n, 4), (1 << 17, 4)):
            c = (gl_random(gen, (2, size)), gl_random(gen, (2, size)))
            beta = host_betas(gen, 2)
            check(f"k9_round_group_{g}_n_{size}",
                  fri_cuda.fold_round(*c, beta, a, 4, 3, shift, group_log=g),
                  fd._fold_round_plain(*c, *gf.ext_pair(beta, "cuda"), a, 4, 3, shift))
    c = (gl_random(gen, (6, n)), gl_random(gen, (6, n)))
    beta = host_betas(gen, 6)
    check("k9_round_strided", fri_cuda.fold_round(c[0][::2], c[1][::2], beta[::2], 4, 4, 3,
                                                  shift),
          fd._fold_round_plain(c[0][::2], c[1][::2], *gf.ext_pair(beta[::2], "cuda"), 4, 4, 3,
                               shift))
    many = fri_cuda.K9_MAX_BATCH + 2
    c = (gl_random(gen, (many, 1 << 10)), gl_random(gen, (many, 1 << 10)))
    beta = host_betas(gen, many)
    check("k9_round_two_launches", fri_cuda.fold_round(*c, beta, 4, 4, 3, shift),
          fd._fold_round_plain(*c, *gf.ext_pair(beta, "cuda"), 4, 4, 3, shift))
    check("k9_fold_two_launches", fri_cuda.fold(*c, beta, 4),
          fd._fold_plain(*c, *gf.ext_pair(beta, "cuda"), 4))
    # K7's row groups and tiles: groups of 1 and 3 rows (ending inside the
    # oracles' sets; the g*zeta rows a group of their own), tiles forced to
    # 2048 coefficients at one proof and to 256 at B=4, n below one tile
    saved = fri_cuda.K7_GROUP, fri_cuda.K7_MIN_TILE, fri_cuda.K7_MAX_TILE
    try:
        for name, group, tile, batch, n_k7 in (("group_1", 1, None, 2, n),
                                               ("group_3", 3, None, BATCH, n),
                                               ("tile_2048", 32, 2048, 1, n),
                                               ("tile_256_b4", 32, 256, BATCH, n),
                                               ("n_100_group_3", 3, None, 3, 100)):
            fri_cuda.K7_GROUP = group
            if tile:
                fri_cuda.K7_MIN_TILE = fri_cuda.K7_MAX_TILE = tile
            inp = fri_inputs(gen, widths, n_k7, batch, nz)
            check(f"k7_{name}", fri_calls(inp)["k7"](), fri_calls(inp, plain=True)["k7"]())
            fri_cuda.K7_GROUP, fri_cuda.K7_MIN_TILE, fri_cuda.K7_MAX_TILE = saved
    finally:
        fri_cuda.K7_GROUP, fri_cuda.K7_MIN_TILE, fri_cuda.K7_MAX_TILE = saved
    # the sharded path's calls (plonk/prover_sharded.py, fri/fri_sharded.py):
    # each shard's pieces of the four oracles at zeta and their alpha
    # reduction (zeros past an oracle's polynomials), the Z rows at g*zeta
    # on the first shard, a 1-D fold of each shard's coefficients
    e = SHARDS
    kps = [-(-k // e) for k in widths]
    zp = gl_random(gen, (1, 2, 1))
    alpha = gl_random(gen, (1, 2, 1))
    for j in range(e):
        pieces = [(gl_random(gen, (k, n)), 0) for k in kps]
        # the alpha reduction's pieces: each oracle's rows on shard j before
        # its zero padding, at the power of alpha of its first row
        reduced, off = [], 0
        for (x, _), k, kp in zip(pieces, widths, kps):
            real = min(max(k - j * kp, 0), kp)
            if real:
                reduced.append((x[:real], 0, off + j * kp))
            off += k
        check(f"sharded_{j}/k7", fri_cuda.openings(pieces, zp),
              fd._openings_plain(pieces, zp))
        check(f"sharded_{j}/k8_point", fri_cuda.reduce_alpha(reduced, alpha),
              fd._reduce_alpha_plain(reduced, alpha))
        c = (gl_random(gen, (n // e,)), gl_random(gen, (n // e,)))
        beta = host_betas(gen, 1)[0]
        check(f"sharded_{j}/k9", fri_cuda.fold(*c, beta, 4),
              fd._fold_plain(*c, *gf.ext_pair(beta, "cuda"), 4))
    zs = [(gl_random(gen, (nz, n)), 0, 0)]
    check("sharded_zs_next/k7", fri_cuda.openings(zs, zp), fd._openings_plain(zs, zp))
    check("sharded_zs_next/k8_point", fri_cuda.reduce_alpha(zs, alpha),
          fd._reduce_alpha_plain(zs, alpha))
    state["fri_max_abs_err"] = 0
    emit({"phase": "fri_check", "equal_integers": True, "cases": checked,
          "launches": {k: v - before[k] for k, v in fri_launches().items()}})


# (kernel, name on the kernels line, what it computes, the JAX program, the
# prefix of fri_time's rows whose sum is its figure: a wormhole proof's)
FRI_KERNELS = (("k7", "fri_openings", "openings at zeta and g*zeta",
                "_make_openings_run :158, jitted :173 and :181", "k7"),
               ("k8", "fri_compose", "alpha reduction (point kernel) and divide-by-linear "
                "(scan)", "_make_compose_run :193 (_reduce_alpha :70, _ddl :96), jitted "
                ":227, :237, :246, without its round-0 NTT and commit", "k8"),
               ("k9", "fri_fold", "fold rounds: the fold, the next codeword's coset NTT and "
                "its fiber leaves in one launch a round, the last round's fold alone",
                "_make_fold_commit_run :255 without its Merkle levels (_fold_dev :136, "
                "_ext_coset_ntt_dev :108, _fiber_leaves :120) and _final_fold_fn :289",
                "k9_r"))


def phase_fri_time(state) -> None:
    """K7-K9's device time (graph_ms) at fri_cases' shapes beside their
    plain versions and bounds (fri_work), the host time a wrapper call; a
    proof's five launches in one graph; ptxas's registers and spills and
    the SASS counts of each kernel."""
    import torch

    from zk_circuits_torch.fri import fri_cuda

    gen = torch.Generator(device="cuda").manual_seed(2053)
    parent, parent_fd = parent_kernels().get("fri"), parent_fri_device()
    rows, paired = [], []
    for name, common, widths, batch in fri_cases(state):
        n, nz = common.degree, common.config.num_challenges
        ins = [fri_inputs(gen, widths, n, batch, nz) for _ in range(FRI_TIMED_CALLS)]
        calls = [fri_calls(i) for i in ins]
        plain = fri_calls(ins[0], plain=True)
        folds = [fri_fold_inputs(gen, common, batch) for _ in range(FRI_TIMED_CALLS)]
        timed = [(k, [c[k] for c in calls], plain[k], fri_work(k, widths, n, batch, nz),
                  {"n": n}) for k in ("k7", "k8_point", "k8_scan", "k8")]
        for r, case in enumerate(folds[0]):
            a, size, nxt = case[0], case[1][0].shape[-1], case[3]
            mode = "round" if nxt else "fold"
            shape = {"n": size, "arity_bits": a}
            if nxt:
                log_m = size.bit_length() - 1 - a
                group = fri_cuda.round_group_log(nxt[1], log_m, a)
                shape.update(next_arity_bits=nxt[0], rate_bits=nxt[1], group_log=group,
                             blocks=batch << (nxt[1] + 1),
                             smem_bytes=fri_cuda.round_smem(log_m, group))
            timed.append((f"k9_r{r + 1}_{mode}", [fri_fold_call(f[r]) for f in folds],
                          fri_fold_call(case, plain=True),
                          fri_work(f"k9_{mode}", widths, size, batch, nz, a, nxt), shape))
        for kernel, fns, plain_fn, (nbytes, muls), shape in timed:
            g = graph_ms(fns)
            bound, by = k4_bound_ms(nbytes, muls)
            rows.append({"shape": name, "kernel": kernel, "batch": batch, **shape,
                         "widths": list(widths), **g,
                         "plain_ms": cuda_ms(plain_fn, reps=3, warmup=1),
                         "bound_ms": bound, "bound_by": by, "bytes": nbytes, "muls": muls,
                         "share_of_bound": bound / g["ms"], "library_ms": None,
                         "host_us_per_call": host_us_per_call(fns[0])})

        def proof_calls(c, f):
            folds_f = [fri_fold_call(x) for x in f]

            def run():
                comp = c["k8"]()
                return c["k7"](), comp, [fn() for fn in folds_f]
            return run

        rows.append({"shape": name, "kernel": "k7_k8_k9", "batch": batch,
                     "launches": sum(v for k, v in expected_fri_launches(common).items()
                                     if k in ("k7", "k8", "k9")),
                     **graph_ms([proof_calls(c, f) for c, f in zip(calls, folds)])})
        if parent is not None:   # K8 and K9, unchanged, against the parent's as controls
            pcalls = [fri_calls(i, kernels=parent) for i in ins]
            paired.append({"shape": name, "kernel": "k8", "batch": batch, **paired_ms(
                [c["k8"] for c in calls], [c["k8"] for c in pcalls])})
            for r, case in enumerate(folds[0]):
                paired.append({
                    "shape": name, "kernel": f"k9_r{r + 1}_{'round' if case[3] else 'fold'}",
                    "batch": batch, "parent_is": "its K9 in the same mode", **paired_ms(
                        [fri_fold_call(f[r]) for f in folds],
                        [fri_fold_call(f[r], parent=parent_fd) for f in folds])})
            del pcalls
        del ins, calls, folds
    over = [r for r in rows if r.get("share_of_bound", 0) > 1.05]
    if over:
        raise AssertionError(f"K7-K9 timed below their bound: {over}")
    emit({"phase": "fri_time", "int32_mul_per_s": INT32_MUL_PER_S,
          "paired_with_parent": paired, "parent": PARENT_COMMIT if parent else None,
          "parent_sass": kernel_sass_counts(parent.build(), parent.build_log, "k9_")
          if parent else None,
          "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "timing": f"ms: CUDA events around the replay of a CUDA graph of {FRI_TIMED_CALLS} "
                    f"calls on inputs of their own, L2 emptied first, per call, median of 8 "
                    f"replays (min_ms/max_ms: their range); k8 is both of K8's launches, "
                    f"k9_rN_round K9's round mode in fold round N, k9_rN_fold its fold mode, "
                    f"k7_k8_k9 a proof's (or batch's) launches of all three; plain_ms: CUDA "
                    f"events around one call of the plain version (fri/fri_device.py's "
                    f"_openings_plain, _reduce_alpha_plain, _compose_plain, _fold_plain, "
                    f"_fold_round_plain), median of 3; paired_with_parent: paired_ms, the "
                    f"parent's K8 and K9 (unchanged: controls); host_us_per_call: perf_counter around 100 wrapper calls; "
                    f"library_ms: none, no PyTorch call computes these functions",
          "rows": rows, "sass": kernel_sass_counts(fri_cuda.build(), fri_cuda.build_log,
                                                   "k[789]_")})
    for kernel, name, what, replaces, prefix in FRI_KERNELS:
        mine = [r for r in rows if r["kernel"] == prefix or
                (prefix == "k9_r" and r["kernel"].startswith(prefix))]
        main = [r for r in mine if r["shape"] == "wormhole"]
        ms, plain_ms, bound = (sum(r[k] for r in main) for k in ("ms", "plain_ms", "bound_ms"))
        state.setdefault("kernels", []).append({
            "name": name, "route": "cuda", "source": FRI_SOURCE,
            "replaces": f"{FRI_REPLACES} {replaces}; no Pallas kernel ({what})",
            "launches": state["fri_launches"][kernel],
            **({"round_mode_launches": state["fri_launches"]["k9_round"]}
               if kernel == "k9" else {}),
            "launches_by_path": {"wormhole": state["fri_launches"][kernel],
                                 "batch": state["fri_launches_batch"][kernel],
                                 "sharded": state["fri_launches_sharded"][kernel],
                                 "aggregate": state["aggregate_launches"][kernel]},
            "max_abs_err": state["fri_max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": main[0]["bound_by"], "library_ms": None,
            "ms_by_shape": {f"{r['shape']}/{r['kernel']}": r["ms"] for r in mine}})


def gather_trees_of(gen, common, widths, batch: int) -> tuple:
    """The query gather's inputs at a proof's shapes (the call of
    fri_device.open_and_fri_device_batch): the four oracles' trees (the
    constants/sigmas (w, N) shared, the others (B, w, N), column-major) and
    each fold round's FRI tree ((B, m, 2 A) row-major), every word any u64
    (in [p, 2^64) too), levels as K1's tree mode lays them out (views of
    one buffer, leaf digests first, the cap last); and the (B, Q) query
    indices, as fri_device.query_indices draws them, 0, N - 1 and a repeat
    leading each proof's.  Returns (trees, idxs, shared, colmajor)."""
    import numpy as np
    import torch

    fri = common.config.fri_config
    lde, cap = common.lde_size, fri.cap_height

    def words(*shape):
        return torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen, device="cuda",
                             dtype=torch.int64)

    def tree(lead, leaf_shape, n):
        sizes = [n >> lv for lv in range(n.bit_length() - cap)]
        return words(*lead, *leaf_shape), list(torch.split(words(*lead, sum(sizes), 4), sizes,
                                                           dim=-2))

    trees = [tree((), (widths[0], lde), lde)] + [tree((batch,), (w, lde), lde)
                                                 for w in widths[1:]]
    size, ms = lde, []
    for a in fri.reduction_arities(common.degree_bits):
        size >>= a
        trees.append(tree((batch,), (size, 2 << a), size))
        ms.append(size)
    rng = np.random.default_rng(int(torch.randint(1 << 62, (1,), generator=gen,
                                                  device="cuda").item()))
    idx = rng.integers(0, lde, (batch, fri.num_query_rounds))
    idx[:, :3] = [0, lde - 1, 0]
    idxs = [idx] * 4 + [idx % m for m in ms]
    return trees, idxs, [True] + [False] * (len(trees) - 1), [True] * 4 + [False] * len(ms)


def gather_work(trees: list, idxs: list, colmajor: list) -> int:
    """Bytes of one query gather: each gathered word read once and written
    once, and the query indices read once (K10's descriptors are not the
    function's)."""
    words = 0
    for (leaves, levels), idx, cm in zip(trees, idxs, colmajor):
        w = leaves.shape[-2] if cm else leaves.shape[-1]
        words += idx.size * (w + 4 * (len(levels) - 1))
    return 16 * words + 8 * sum(i.size for i in idxs)


def sharded_gather_call(state, mesh) -> tuple:
    """(trees, idxs, colmajor) of the query gather of one warm sharded
    proof of the wormhole over ``mesh`` (the trees' row-sharded pieces
    where the proof left them), caught at fri_device._gather_pieces."""
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.plonk.prover_sharded import prove_sharded

    cd, targets, inputs = state["wormhole"]
    real, seen = fd._gather_pieces, []

    def caught(trees, idxs, colmajor, lib=None):
        seen.append((trees, idxs, list(colmajor)))
        return real(trees, idxs, colmajor, lib=lib)

    fd._gather_pieces = caught
    try:
        pw = WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness
        prove_sharded(cd, pw, mesh)
    finally:
        fd._gather_pieces = real
    if len(seen) != 1:
        raise AssertionError(f"a sharded proof gathered through K10 {len(seen)} times")
    return seen[0]


def phase_gather_check(state) -> None:
    """K10 against its plain version (fri/fri_device.py's _gather_plain) on
    the card, equal integers: the query gather of one wormhole proof, of
    B=4 and of the level-1 batch (its three FRI trees), each with the
    constants/sigmas tree shared, every word any u64, indices 0, N - 1 and
    repeated; a tree with no sibling level; gather_trees_batch's host arrays
    against the CPU's; the row-sharded trees of one warm sharded proof
    (E=SHARDS, one card; spread over the cards too where there are
    several) against ``_take_all`` with ``_take_sharded``.  One launch a
    call."""
    import torch

    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.fri import gather_cuda
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.plonk import prover_sharded as ps

    gen = torch.Generator(device="cuda").manual_seed(2061)
    before = gather_cuda.launches
    checked = []

    def check(name, trees, idxs, shared, colmajor):
        got = gather_cuda.gather(trees, idxs, shared, colmajor)
        want = fd._gather_plain(trees, idxs, shared, colmajor)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"gather_check/{name}: K10 != its plain version")
        checked.append({"name": name, "trees": len(trees), "batch": int(idxs[0].shape[0]),
                        "queries": int(idxs[0].shape[1]), "words": got.numel()})

    for name, common, widths, batch in fri_cases(state):
        trees, idxs, shared, cm = gather_trees_of(gen, common, widths, batch)
        check(name, trees, idxs, shared, cm)
        if name == "wormhole_batch":    # the host arrays of the whole call, against the CPU's
            cpu = [(lf.cpu(), [lv.cpu() for lv in lvs]) for lf, lvs in trees]
            for (gr, gs), (wr, ws) in zip(fd.gather_trees_batch(trees, idxs, shared, cm),
                                          fd.gather_trees_batch(cpu, idxs, shared, cm)):
                if not (gr.shape == wr.shape and (gr == wr).all() and gs.shape == ws.shape
                        and (gs == ws).all()):
                    raise AssertionError("gather_check: gather_trees_batch on the card != "
                                         "on the CPU")
            checked.append({"name": "gather_trees_batch_host_arrays", "batch": batch})
        del trees
    common = state["wormhole"][0].common
    widths = fri_widths(state["wormhole_proof"])
    trees, idxs, shared, cm = gather_trees_of(gen, common, widths, 2)
    capped = (torch.randint(-(1 << 63), (1 << 63) - 1, (2, 16, 8), generator=gen,
                            device="cuda", dtype=torch.int64), [])
    capped[1].append(torch.randint(-(1 << 63), (1 << 63) - 1, (2, 16, 4), generator=gen,
                                   device="cuda", dtype=torch.int64))
    check("tree_without_sibling_level", trees[:2] + [capped] + trees[2:],
          idxs[:2] + [idxs[-1] % 16] + idxs[2:], shared[:2] + [False] + shared[2:],
          cm[:2] + [False] + cm[2:])
    del trees, capped
    cards = torch.cuda.device_count()
    meshes = [("sharded_one_card", meshm.Mesh((torch.device("cuda", 0),) * SHARDS))]
    if cards > 1:
        meshes.append(("sharded_over_cards", meshm.make_mesh(SHARDS)))
    for name, mesh in meshes:
        trees, idxs, cm = sharded_gather_call(state, mesh)
        got, _ = fd._gather_pieces(trees, idxs, cm)
        want, _ = fd._take_all(trees, idxs, cm, lambda sh, i, c: ps._take_sharded(
            sh, i, c, mesh.first))
        _sync_all()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"gather_check/{name}: K10 over the shards' pieces != the "
                                 f"plain takes")
        checked.append({"name": name, "trees": len(trees), "shards": SHARDS,
                        "cards": sorted({str(p.device) for p in trees[0][0]}),
                        "queries": int(len(idxs[0])), "words": got.numel(),
                        "pieces_by_level": [len(lv) for lv in trees[0][1]]})
        del trees
    state["k10_max_abs_err"] = 0
    emit({"phase": "gather_check", "equal_integers": True, "cases": checked,
          "launches": gather_cuda.launches - before})


def host_paired_ms(fn, parent_fn, calls: int = K10_HOST_CALLS) -> dict:
    """Host milliseconds a call of ``fn`` and of ``parent_fn`` (each ending
    in its fetch), in turns: parent, this, this, parent; each turn the
    median of ``calls`` calls after one."""
    def turn(f):
        f()
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            f()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    runs = [turn(f) for f in (parent_fn, fn, fn, parent_fn)]
    return {"ms": runs[1:3], "parent_ms": [runs[0], runs[3]]}


def phase_gather_time(state) -> None:
    """K10's device time (graph_ms of its launch on prepared calls, each its
    own indices) at the main path's three shapes beside the plain version
    (CUDA events around one call), the bound (gather_work) and the host
    time of one gather_trees_batch call (its upload, launch and fetch),
    paired on the host clock with the parent's eager gather on the same
    trees.  A call's device operations are scripts/gather_device_ops.py's
    count, made in a process of its own."""
    import numpy as np
    import torch

    from zk_circuits_torch.fri import fri_device as fd
    from zk_circuits_torch.fri import gather_cuda

    gen = torch.Generator(device="cuda").manual_seed(2063)
    parent_fd = parent_fri_device()
    rows = []
    for name, common, widths, batch in fri_cases(state):
        trees, idxs, shared, cm = gather_trees_of(gen, common, widths, batch)
        q, lde = common.config.fri_config.num_query_rounds, common.lde_size
        one = lambda: fd.gather_trees_batch(trees, idxs, shared, cm)   # noqa: E731
        draws = []
        for k in range(K10_TIMED_CALLS):    # each launch its own queries
            rng = np.random.default_rng(k)
            i = rng.integers(0, lde, (batch, q))
            draws.append([i] * 4 + [i % (lf.shape[-2]) for lf, _ in trees[4:]])
        preps = [gather_cuda.prepare(trees, d, shared, cm) for d in draws]
        g = graph_ms([lambda p=p: gather_cuda.launch(p) for p in preps])
        nbytes = gather_work(trees, idxs, cm)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": name, "batch": batch, "trees": len(trees), "queries": q,
               "words": int(preps[0].out.numel()), "blob_words": int(preps[0].blob.numel()),
               "blocks_per_tree": preps[0].call.blocks, **g,
               "plain_ms": cuda_ms(lambda: fd._gather_plain(trees, idxs, shared, cm), reps=3,
                                   warmup=1),
               "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
               "share_of_bound": bound / g["ms"], "library_ms": None,
               "host_us_per_call": host_us_per_call(one)}
        if parent_fd is not None:
            row["paired_with_parent"] = host_paired_ms(
                one, lambda: parent_fd.gather_trees_batch(trees, idxs, shared, cm))
        rows.append(row)
        del trees, preps
    over = [r for r in rows if r["share_of_bound"] > 1.05]
    if over:
        raise AssertionError(f"K10 timed below its bound: {over}")
    emit({"phase": "gather_time", "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "parent": PARENT_COMMIT if parent_fd else None,
          "timing": f"ms: CUDA events around the replay of a CUDA graph of {K10_TIMED_CALLS} "
                    f"K10 launches on prepared calls (their blobs uploaded before), each its "
                    f"own query indices, L2 emptied first, per launch, median of 8 replays "
                    f"(min_ms/max_ms: their range); plain_ms: CUDA events around one call of "
                    f"fri/fri_device.py's _gather_plain (its uploads among it), median of 3; "
                    f"host_us_per_call: perf_counter around 100 gather_trees_batch calls, each "
                    f"its blob's upload, K10 and the fetch; paired_with_parent: "
                    f"host ms a gather_trees_batch call, this tree's and the parent's eager "
                    f"gather on the same trees, in turns (parent, this, this, parent), each "
                    f"the median of {K10_HOST_CALLS}; library_ms: none, no PyTorch call "
                    f"gathers rows and sibling paths of several trees",
          "rows": rows, "sass": kernel_sass_counts(gather_cuda.build(), gather_cuda.build_log,
                                                   "k10_")})
    main = next(r for r in rows if r["shape"] == "wormhole")
    state.setdefault("kernels", []).append({
        "name": "fri_query_gather", "route": "cuda", "source": K10_SOURCE,
        "replaces": f"{K10_REPLACES} _gather_fn and :384 _gather_batch_fn (called at :597 and "
                    f":790); no Pallas kernel (every tree's query rows and sibling paths)",
        "launches": state["fri_launches"]["k10"],
        "launches_by_path": {"wormhole": state["fri_launches"]["k10"],
                             "batch": state["fri_launches_batch"]["k10"],
                             "sharded": state["fri_launches_sharded"]["k10"],
                             "aggregate": state["aggregate_launches"]["k10"]},
        "max_abs_err": state["k10_max_abs_err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_by_shape": {r["shape"]: r["ms"] for r in rows}})
    state.pop("level1_cd", None)
    state.pop("level1_proof", None)


MESH_BATCH = 8          # proofs of the batch_mesh phase, over a mesh of SHARDS shards


def card_busy(prof, wall: float) -> dict:
    """Each card's device busy seconds (CUDA kernels and copies) and idle
    share over ``wall`` seconds, from a torch.profiler run's raw events."""
    busy: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and \
                not getattr(e, "is_hidden_event", lambda: False)():
            key = f"cuda:{e.device_index()}"
            busy[key] = busy.get(key, 0.0) + e.duration_ns() / 1e9
    if not busy:
        raise AssertionError("the trace recorded no device time")
    return {card: {"busy_s": s, "idle_share": 1.0 - s / wall} for card, s in sorted(busy.items())}


def by_card(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def phase_batch_mesh(state) -> None:
    """prove_batch of MESH_BATCH zk wormhole proofs over make_mesh(SHARDS)
    beside the unsharded batch (see the module doc)."""
    import os
    import tempfile

    import torch

    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.hash import poseidon_cuda as pc
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils import profiling
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cd, targets, inputs = state["wormhole"]
    mesh = meshm.make_mesh(SHARDS)
    sub = MESH_BATCH // SHARDS
    shards_on = {}
    for d in mesh.devices:
        shards_on[str(d)] = shards_on.get(str(d), 0) + 1
    k1_sub = expected_k1_launches(cd.common, sub)
    k3_sub = sum(expected_k3_launches(cd).values())

    def witnesses():
        return [WormholeProver(circuit_data=cd, targets=targets).commit(inputs)
                .partial_witness for _ in range(MESH_BATCH)]

    def run(m):
        pws = witnesses()
        k1, k3 = dict(pc.launches_by_device), dict(witness_cuda.launches_by_device)
        k1_mode = dict(pc.launches_by_mode)
        with host_witness_calls() as host_witnesses:
            proofs, secs = _synced(lambda: prove_batch(cd, pws, mesh=m))
        digests = {hashlib.sha256(proof_to_bytes(p)).hexdigest() for p in proofs}
        if len(proofs) != MESH_BATCH or digests != {GOLDEN_WORMHOLE_ZK_SHA256}:
            raise AssertionError(f"batch_mesh: sha256s {digests} != pinned")
        if host_witnesses:
            raise AssertionError(f"batch_mesh: {len(host_witnesses)} host witnesses")
        return proofs, secs, {"k1_by_card": by_card(k1, pc.launches_by_device),
                              "k3_by_card": by_card(k3, witness_cuda.launches_by_device),
                              "k1_by_mode": {k: v - k1_mode[k]
                                             for k, v in pc.launches_by_mode.items()}}

    pc.reset_launches()                 # the mesh batch path starts here
    witness_cuda.reset_launches()
    runs = {}
    for name in ("mesh_cold", "mesh_warm"):
        proofs, secs, launches = run(mesh)
        sweeps = proofs[0].proof.opening_proof.pow_witness // GRIND_ROWS + 1
        k1_want = {card: n * (k1_sub["tree"] + k1_sub["top"] + sweeps)
                   for card, n in shards_on.items()}
        k3_want = {card: n * k3_sub for card, n in shards_on.items()}
        mode_want = {"tree": SHARDS * k1_sub["tree"], "top": SHARDS * k1_sub["top"],
                     "sponge": SHARDS * sweeps}
        if launches["k1_by_card"] != k1_want or launches["k3_by_card"] != k3_want or \
                launches["k1_by_mode"] != mode_want:
            raise AssertionError(f"batch_mesh {name}: launches {launches}, want K1 {k1_want} "
                                 f"({mode_want}), K3 {k3_want}")
        runs[name] = {"s": secs, **launches, "k1_expected_by_card": k1_want,
                      "k3_expected_by_card": k3_want}
    k1_path, k3_path = pc.launches, witness_cuda.launches   # the mesh batch path ends here
    _, secs, launches = run(None)       # the first batch of 8: nothing left to build
    runs["unsharded"] = {"s": secs, **launches}
    cd.verify(proofs[0])
    _refuses_tampering(cd, proofs[0])

    # one more mesh batch under device_trace (torch.profiler, CPU and CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ZKT_PROFILE_DIR"] = tmp
        try:
            pws = witnesses()
            t0 = time.perf_counter()
            with profiling.device_trace("batch_mesh") as prof:
                prove_batch(cd, pws, mesh=mesh)
                _sync_all()
                wall = time.perf_counter() - t0
            traced_s = time.perf_counter() - t0
        finally:
            del os.environ["ZKT_PROFILE_DIR"]
        trace_files = sorted(str(p.relative_to(tmp)) for p in
                             __import__("pathlib").Path(tmp).rglob("*.json"))
        trace_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in trace_files)
    if not trace_files:
        raise AssertionError("batch_mesh: device_trace wrote no trace")
    cards = card_busy(prof, wall)
    del prof
    for k in state.get("kernels", []):
        if k["name"] == "poseidon_leaf_hash":
            k["launches_by_path"]["batch_mesh"] = k1_path
        if k["name"] == "witness_schedule":
            k["launches_by_path"]["batch_mesh"] = k3_path
    emit({"phase": "batch_mesh", "batch": MESH_BATCH, "shards": SHARDS,
          "mesh": [str(d) for d in mesh.devices], "sub_batch": sub,
          "sha256": GOLDEN_WORMHOLE_ZK_SHA256, "golden": True, "verified": True,
          "tamper_rejected": True, "host_witnesses": 0, "runs": runs,
          "mesh_warm_over_unsharded": runs["mesh_warm"]["s"] / runs["unsharded"]["s"],
          "k1_launches": k1_path, "k3_launches": k3_path,
          "trace": {"files": trace_files, "bytes": trace_bytes, "traced_s": traced_s,
                    "wall_s": wall, "cards": cards},
          "timing": "s: perf_counter around prove_batch, ending in a synchronise of every "
                    "card; trace: device_trace (torch.profiler, CPU and CUDA activities) "
                    "around one more mesh batch, busy_s the sum of each card's kernel and "
                    "copy durations, idle_share 1 - busy_s / wall_s"})
    torch.cuda.empty_cache()


def phase_aggregate_mesh(state) -> None:
    """The aggregate phase's tree over make_mesh(SHARDS) (see the module doc)."""
    import numpy as np

    from zk_circuits_torch.aggregation import tree as treem
    from zk_circuits_torch.aggregation.aggregator import WormholeProofAggregator
    from zk_circuits_torch.circuits.wormhole.inputs import PublicCircuitInputs
    from zk_circuits_torch.hash import poseidon_cuda as pc
    from zk_circuits_torch.iop import witness_cuda
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.plonk import prover_batch
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    cd = state["wormhole"][0]
    leaf = state["wormhole_proof"]
    mesh = meshm.make_mesh(SHARDS)
    n_cached = len(treem._LEVEL_CACHE)
    splits = []
    real = prover_batch.prove_batch_mesh

    def spy(data, pws, m, check_witness=False):
        splits.append((len(pws), m.size))
        return real(data, pws, m, check_witness)

    prover_batch.prove_batch_mesh = spy
    cards = len(set(mesh.devices))
    runs = []
    try:
        with level_prove_records() as records:
            pc.reset_launches()             # the mesh aggregate path starts here
            witness_cuda.reset_launches()
            for _ in range(2 if cards > 1 else 1):   # first, and warm where cards were new
                agg = WormholeProofAggregator(cd.common, cd.verifier_only,
                                              treem.TreeAggregationConfig(*AGG_CONFIG),
                                              mesh=mesh, dummy_loader=lambda: leaf,
                                              device="cuda")
                for _ in range(AGG_PUSHES):
                    agg.push(leaf)
                root, secs = _synced(agg.aggregate)
                runs.append((root, secs))
            k1_path, k3_path = pc.launches, witness_cuda.launches   # ... ends here
    finally:
        prover_batch.prove_batch_mesh = real
    depth = AGG_CONFIG[1]
    leaves = AGG_CONFIG[0] ** depth
    if len(treem._LEVEL_CACHE) != n_cached:
        raise AssertionError("aggregate_mesh: a level circuit was built again")
    if splits != [(leaves // AGG_CONFIG[0], SHARDS)] * len(runs):
        raise AssertionError(f"aggregate_mesh: mesh splits {splits}, want level 1's "
                             f"{leaves // AGG_CONFIG[0]} chunks over {SHARDS} shards, twice")
    data = proof_to_bytes(runs[0][0])
    digest = hashlib.sha256(data).hexdigest()
    if digest != GOLDEN_AGGREGATE_ZK_SHA256 or proof_to_bytes(runs[-1][0]) != data:
        raise AssertionError(f"aggregate_mesh root sha256 {digest} != pinned "
                             f"{GOLDEN_AGGREGATE_ZK_SHA256}")
    agg.root_circuit_data.verify(runs[-1][0])
    public = PublicCircuitInputs.try_from_slice(np.asarray(leaf.public_inputs))
    if agg.extract_leaf_public_inputs() != [public] * leaves:
        raise AssertionError("aggregate_mesh: the leaves do not extract")
    levels = []
    for i, r in enumerate(records):
        common = r["level"].circuit_data.common
        sharded = r["batch"] % SHARDS == 0 and r["batch"] > 1
        per = r["batch"] // SHARDS if sharded else r["batch"]
        k1_want = expected_k1_launches(common, per)
        calls = SHARDS if sharded else 1
        k3_want = {k: calls * v for k, v in expected_k3_launches(r["level"].circuit_data).items()}
        k1 = r["k1"]
        sweeps = sum(max(r["pow_sweeps"][j:j + per]) for j in range(0, r["batch"], per))
        if (k1["tree"], k1["top"], k1["sponge"]) != (calls * k1_want["tree"],
                                                     calls * k1_want["top"], sweeps) \
                or r["k3"] != k3_want or r["host_witnesses"]:
            raise AssertionError(f"aggregate_mesh level {i % depth + 1}: K1 {k1}, K3 {r['k3']} "
                                 f"(want {calls} x {k1_want}, {sweeps} sweeps; {k3_want})")
        levels.append({"run": "first" if i < depth else "warm", "level": i % depth + 1,
                       "batch": r["batch"], "sharded": sharded, "s": r["s"],
                       "k1_launches_by_mode": k1, "k3_launches_by_kernel": r["k3"]})
    unsharded = state.get("aggregate_warm_level_s", {})
    for k in state.get("kernels", []):
        if k["name"] == "poseidon_leaf_hash":
            k["launches_by_path"]["aggregate_mesh"] = k1_path
        if k["name"] == "witness_schedule":
            k["launches_by_path"]["aggregate_mesh"] = k3_path
    emit({"phase": "aggregate_mesh", "shards": SHARDS, "mesh": [str(d) for d in mesh.devices],
          "tree": {"branching_factor": AGG_CONFIG[0], "depth": depth, "leaves": leaves},
          "sha256": digest, "golden": True, "verified": True, "leaves_extracted": leaves,
          "aggregate_s": [r[1] for r in runs],
          "unsharded_warm_aggregate_s": state.get("aggregate_warm_s"),
          "level_proves": levels, "unsharded_warm_level_s": unsharded,
          "mesh_splits": splits, "k1_launches": k1_path, "k3_launches": k3_path,
          "timing": "s: perf_counter, ending in a synchronise of every card; the "
                    "unsharded figures are the aggregate phase's warm run"})


def phase_multihost(state) -> None:
    """scripts/torch_multihost_sim.py with 2 processes on the card(s) (see
    the module doc), beside the four-step over make_mesh(SHARDS) in this
    process."""
    import os

    import numpy as np
    import torch

    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.parallel.ntt_sharded import ntt_sharded

    procs, local = 2, SHARDS // 2
    cards = torch.cuda.device_count()
    # processes that own their cards take nccl; sharing cuda:0, gloo
    backend = "nccl" if cards >= procs * local else "gloo"
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_multihost_sim.py")
    cmd = [sys.executable, script, "--procs", str(procs), "--local-shards", str(local),
           "--log2n", str(NTT_LOG), "--device", "cuda", "--backend", backend,
           "--timeout", str(SIM_TIMEOUT)]
    res_proc, secs = _synced(lambda: subprocess.run(cmd, capture_output=True, text=True,
                                                    timeout=SIM_TIMEOUT + 60))
    if res_proc.returncode != 0:
        raise AssertionError(f"multihost: rc {res_proc.returncode}\n"
                             f"{res_proc.stdout[-3000:]}\n{res_proc.stderr[-3000:]}")
    res = json.loads([ln for ln in res_proc.stdout.splitlines() if ln.startswith("{")][-1])
    if not (res["ok"] and res["ntt_equal_host"] and res["intt_of_ntt_equal_input"]
            and res["lde_dcn_equal_host"] and res["backend"] == backend):
        raise AssertionError(f"multihost: {res}")
    per_card = local if cards >= procs * local else 1
    want = 3 * 3 * per_card             # 3 four-steps (NTT cold, warm, INTT), 3 exchanges
    if [p["launches"] for p in res["k2_by_process"]] != [want] * procs:
        raise AssertionError(f"multihost: K2 launches {res['k2_by_process']}, want {want} "
                             f"a process")
    # the same four-step in this process over SHARDS shards of make_mesh
    mesh = meshm.make_mesh(SHARDS)
    x = gf.from_u64(np.random.default_rng(7).integers(0, P, 1 << NTT_LOG, dtype=np.uint64),
                    "cuda")
    xs = meshm.shard_last(x, mesh)
    ntt_sharded(xs, mesh)
    _sync_all()
    one_process = [_synced(lambda: ntt_sharded(xs, mesh))[1] for _ in range(3)]
    del x, xs
    for k in state.get("kernels", []):
        if k["name"] == "block_exchange":
            k["launches_by_path"]["multihost"] = sum(p["launches"] for p in res["k2_by_process"])
    emit({"phase": "multihost", "procs": procs, "local_shards": local, "backend": backend,
          "cards_a_process": per_card,
          "log2n": NTT_LOG, "sim": res, "sim_wall_s": secs,
          "one_process_ntt_warm_s": statistics.median(one_process),
          "timing": "ntt_*_s: perf_counter between barriers of every process, ending in "
                    "a synchronise of its cards; one_process_ntt_warm_s: the four-step over "
                    "make_mesh(4) in this process, median of 3, ending in a synchronise"})


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


COMPAT_ROWS = 4096      # rows K1 hashes in the compat phase, one permutation each
COMPAT_SAMPLE = 64      # of them, those also held to the fast permutation


def phase_compat(state) -> None:
    """The reference-format layer on the card's machine (see the module doc)."""
    import numpy as np

    from zk_circuits_torch.field import goldilocks as gf
    from zk_circuits_torch.hash import poseidon_cuda

    t = time.perf_counter()
    from zk_circuits_torch.compat import poseidon_fast, refcircuit   # fast-Poseidon self-check
    import_s = time.perf_counter() - t

    # K1 against its plain version and against the reference engine's fast
    # permutation: a row of 8 felts is one permutation of row || 0^4.
    rng = np.random.default_rng(2610)
    rows = rng.integers(0, P, size=(COMPAT_ROWS, 8), dtype=np.uint64)
    rows[0], rows[1] = 0, P - 1
    x = gf.from_u64(rows, "cuda")
    before = poseidon_cuda.launches
    got = gf.to_u64(poseidon_cuda.hash_rows(x))
    launches = poseidon_cuda.launches - before
    plain = gf.to_u64(poseidon_cuda.hash_rows_plain(x))
    if launches != 1 or not np.array_equal(got, plain):
        raise AssertionError(f"compat: K1 != plain on {COMPAT_ROWS} rows ({launches} launches)")
    sample = np.r_[0, 1, rng.choice(np.arange(2, COMPAT_ROWS), COMPAT_SAMPLE - 2, replace=False)]
    t = time.perf_counter()
    fast = [poseidon_fast.fast_permute(poseidon_fast.HOST_ALG,
                                       [int(v) for v in rows[i]] + [0] * 4)[:4] for i in sample]
    fast_s = time.perf_counter() - t
    if [[int(v) for v in got[i]] for i in sample] != fast:
        raise AssertionError("compat: K1 != fast_permute lanes 0-3")

    # the emulated reference layout, held to the JAX package's digest
    layout, build_s = _synced(lambda: refcircuit.build_wormhole_layout(True))
    sigma, sigma_s = _synced(layout.sigma_polys)
    polys = np.concatenate([layout.selector_polys(), layout.constant_polys(), sigma])
    digest = hashlib.sha256(np.ascontiguousarray(polys, dtype="<u8").tobytes()).hexdigest()
    shape = (layout.degree_bits, tuple(layout.gate_list), tuple(layout.selector_groups))
    if shape != (COMPAT_DEGREE_BITS, COMPAT_GATE_LIST, COMPAT_SELECTOR_GROUPS):
        raise AssertionError(f"compat: layout {shape} is not the JAX package's")
    if digest != GOLDEN_COMPAT_LAYOUT_SHA256:
        raise AssertionError(f"compat: layout sha256 {digest} != pinned "
                             f"{GOLDEN_COMPAT_LAYOUT_SHA256}")
    for k in state.get("kernels", []):
        if k["name"] == "poseidon_leaf_hash":
            k["launches_by_path"]["compat"] = launches
    emit({"phase": "compat", "nvidia_smi": state["smi"], "import_s": import_s,
          "k1_rows": COMPAT_ROWS, "k1_equal_plain": True, "k1_launches": launches,
          "fast_permute_rows": len(sample), "fast_permute_s": fast_s,
          "k1_equal_fast_permute": True, "degree_bits": layout.degree_bits,
          "gate_list": layout.gate_list, "selector_groups": layout.selector_groups,
          "virtual_targets": layout.builder.n_virtual,
          "copy_constraints": len(layout.builder.copy_constraints),
          "build_s": build_s, "sigma_s": sigma_s, "sha256": digest, "golden": True,
          "timing": "seconds of perf_counter on the host (the layer is host numpy); "
                    "import_s includes the fast-Poseidon derivation and self-check"})


NATIVE_LEAVES = (1 << 13, 135)   # wires-shaped leaves: 2^13 rows of 135 felts
NATIVE_POLYS = (80, 1 << 13)     # host_intt of the circuit build's polys
NATIVE_STATES = 4096             # states of the batched permutation


def transcript_split(timings: dict, stage: str, tag: str) -> dict:
    """``stage`` (the openings+fri timer) against the sum of its ``fri/*``
    timers, by their medians: the remainder is the host transcript and
    the rest the timers do not cover."""
    fri = {k: statistics.median(v) for k, v in timings.items()
           if k.startswith("fri/") and k.endswith(tag)}
    whole = statistics.median(timings[stage])
    return {"stage": stage, "stage_s": whole, "fri_timers_s": fri,
            "fri_sum_s": sum(fri.values()), "remainder_s": whole - sum(fri.values())}


def phase_native(state) -> None:
    """The host runtime (zk_circuits_torch.native, csrc/host_native.cpp,
    built by g++ in the card phase) on the card's host: every function
    held to its numpy plain version at the circuit's sizes, one
    permutation's time native and plain, and the transcript's share of a
    warm proof's and a warm batch's openings+fri stage."""
    import numpy as np
    import torch

    from zk_circuits_torch import native
    from zk_circuits_torch.api.prover import WormholeProver
    from zk_circuits_torch.host import gl
    from zk_circuits_torch.host import poseidon as hposeidon
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils import profiling

    rng = np.random.default_rng(2611)
    edge = np.array([0, 1, P - 1, P - 2, 2**32 - 1, 2**64 - 1], dtype=np.uint64)
    checks, seconds = {}, {}

    def held(name, fast, plain):
        t = time.perf_counter()
        got = fast()
        t1 = time.perf_counter()
        want = plain()
        seconds[name] = {"native_s": t1 - t, "plain_s": time.perf_counter() - t1}
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"native: {name} differs from its plain version")
        checks[name] = list(got.shape)

    rows, cols = NATIVE_LEAVES
    leaves = rng.integers(0, P, (rows, cols), dtype=np.uint64)
    leaves[0], leaves[1, :edge.size] = P - 1, edge
    held("hash_leaves", lambda: native.hash_leaves(leaves, or_noop=True),
         lambda: hposeidon.batch_hash_no_pad_plain(leaves))
    short = leaves[:, :20]
    held("hash_no_pad_batch", lambda: hposeidon.batch_hash_no_pad(short),
         lambda: hposeidon.batch_hash_no_pad_plain(short))
    digests = native.hash_leaves(leaves)
    held("compress_level", lambda: native.compress_level(digests),
         lambda: hposeidon.permute_plain(np.concatenate(
             [digests[0::2], digests[1::2], np.zeros((rows // 2, 4), np.uint64)], 1))[:, :4])
    states = rng.integers(0, P, (NATIVE_STATES, 12), dtype=np.uint64)
    states[:edge.size] = edge[:, None]
    held("poseidon_permute", lambda: hposeidon.permute(states),
         lambda: hposeidon.permute_plain(states))
    polys = rng.integers(0, P, NATIVE_POLYS, dtype=np.uint64)
    held("host_intt", lambda: nttm.host_intt(polys), lambda: nttm.host_intt_plain(polys))
    held("host_ntt", lambda: nttm.host_ntt(polys), lambda: nttm.host_ntt_plain(polys))
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    few = polys[:8]
    held("coset_lde", lambda: native.coset_lde(few, 3, shift),
         lambda: nttm.host_ntt_plain(gl._mul_np(
             np.pad(few, ((0, 0), (0, 7 * few.shape[1]))),
             gl._powers_np(shift, 8 * few.shape[1]))))
    flat_a, flat_b = polys.ravel(), np.roll(polys.ravel(), 1)
    flat_a[:edge.size], flat_b[:edge.size] = edge, edge[::-1]
    for op in ("add", "sub", "mul"):
        held(f"gl_{op}", lambda: getattr(gl, op)(flat_a, flat_b),
             lambda: getattr(gl, f"_{op}_np")(flat_a, flat_b))
    base = int(rng.integers(2, P, dtype=np.uint64))
    held("gl_powers", lambda: gl.powers(base, polys.size), lambda: gl._powers_np(base, polys.size))
    held("gl_inv", lambda: native.gl_inv(flat_a[:4096]), lambda: gl.inverse(flat_a[:4096]))

    # one permutation of one state, the challenger's call
    one = states[7].copy()
    reps = {"native": 2000, "plain": 20}
    per_call = {}
    for name, fn in (("native", hposeidon.permute), ("plain", hposeidon.permute_plain)):
        t = time.perf_counter()
        for _ in range(reps[name]):
            fn(one)
        per_call[name] = (time.perf_counter() - t) / reps[name] * 1e6

    # warm proofs and batches with the runtime: the transcript's share
    cd, targets, inputs = state["wormhole"]

    def pw():
        return WormholeProver(circuit_data=cd, targets=targets).commit(inputs).partial_witness

    profiling.reset_timings()
    native.reset_calls()            # the proof path starts here
    single_s = [_synced(lambda: cd.prove(pw(), device="cuda"))[1] for _ in range(3)]
    single_calls = dict(native.calls)   # the proof path ends here
    single = transcript_split(profiling.get_timings(), "prove/openings+fri", "")
    profiling.reset_timings()
    batch_s = [_synced(lambda: prove_batch(cd, [pw() for _ in range(BATCH)]))[1]
               for _ in range(2)]
    batch = transcript_split(profiling.get_timings(), "batch/openings+fri", "(batch)")
    if not single_calls.get("poseidon_permute"):
        raise AssertionError(f"native: the proofs made no native permutation ({single_calls})")
    emit({"phase": "native", "nvidia_smi": state["smi"], **state["native_build"],
          "threads": torch.get_num_threads(), "equal_plain": checks, "check_s": seconds,
          "permute_one_state_us": per_call, "permute_calls": reps,
          "calls_in_3_proofs": single_calls, "warm_single_s": single_s,
          "warm_batch_s": batch_s, "batch_size": BATCH,
          "single": single, "batch": batch,
          "timing": "seconds of perf_counter on the host; the stage times are "
                    "medians over the 3 warm proofs and the 2 warm batches"})


PHASES = {"card": phase_card, "square": phase_square,
          "wide_configs": phase_wide_configs, "wormhole": phase_wormhole, "batch": phase_batch,
          "witness_check": phase_witness_check, "k1_check": phase_k1_check,
          "k4_check": phase_k4_check, "profile": phase_profile,
          "k2_check": phase_k2_check, "sharded": phase_sharded,
          "k1_time": phase_k1_time, "k2_time": phase_k2_time,
          "k4_time": phase_k4_time, "aggregate": phase_aggregate,
          "k5_check": phase_k5_check, "k6_check": phase_k6_check,
          "k5_time": phase_k5_time, "k6_time": phase_k6_time,
          "fri_check": phase_fri_check, "fri_time": phase_fri_time,
          "gather_check": phase_gather_check, "gather_time": phase_gather_time,
          "batch_mesh": phase_batch_mesh, "aggregate_mesh": phase_aggregate_mesh,
          "multihost": phase_multihost, "voting": phase_voting, "api": phase_api,
          "compat": phase_compat, "native": phase_native}


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
