"""The Poseidon work that proofs need, and the least time an H100 can do it
in.  Frozen here so that a change to the program cannot change the count.

A proof's hash work, whatever kernel does it: each oracle's leaves read
once at ceil(cols / 8) permutations a row, each inner node up to the cap
one permutation, the FRI trees likewise, the PoW grind at (witness + 1)
permutations (what the smallest passing witness needs, not the whole
sweep a kernel launches), and each digest written once.  The circuit's
constants/sigmas tree is built at set-up, not by a proof, and is not
counted.

The peaks: HBM at 3.35e12 B/s (NVIDIA's H100 SXM data sheet).  The
multiply rate is derived, not published and not measured: 132 SMs x 64
32-bit multiply(-add) results a clock an SM (CUDA C++ Programming Guide,
arithmetic instruction throughput, compute capability 9.0) x 1.98e9 Hz,
the boost clock behind the data sheet's 67 TFLOP/s FP32 (132 x 128 x 2 x
1.98e9).  A permutation costs 3,776 32-bit multiplies in its cheapest
formulation: 118 S-boxes (8 full rounds x 12 + 22 partial) of four
64x64 products of 8 multiplies each, and an MDS layer of shifts and adds
in the frequency domain.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
SBOX_MULS = (8 * 12 + 22) * 4 * 8
MULS_PER_PERM = SBOX_MULS
POW_ROW_FELTS = 5          # a PoW candidate: the 4-felt base and the witness


def tree_work(n: int, cols: int, cap_height: int | None = None) -> tuple:
    """(permutations, bytes) of hashing n rows of ``cols`` felts, each row
    read once and each digest written once; with ``cap_height`` also the
    tree's inner nodes up to the cap."""
    perms, nbytes = n * ((cols + 7) // 8), n * cols * 8 + n * 32
    if cap_height is not None:
        inner = n - (1 << cap_height)
        perms, nbytes = perms + inner, nbytes + inner * 32
    return perms, nbytes


def pow_work(witness: int) -> tuple:
    """(permutations, bytes) of a grind that stops at ``witness``."""
    return tree_work(int(witness) + 1, POW_ROW_FELTS)


def proof_trees(proof, degree_bits: int, rate_bits: int) -> list:
    """(rows, cols) of every Merkle tree a proof commits: its three
    oracles (widths as opened, salts included) at the LDE size, then each
    FRI round's tree of fibers (arity x 2 felts a row)."""
    p = proof.proof
    rows = 1 << (degree_bits + rate_bits)
    trees = [(rows, len(p.openings.wires)), (rows, len(p.openings.zs_partial_products)),
             (rows, len(p.openings.quotient))]
    rounds = p.opening_proof.query_rounds
    for step in (rounds[0].steps if rounds else []):
        arity = len(step.coset_values)
        rows //= arity
        trees.append((rows, 2 * arity))
    return trees


def proof_work(proof, degree_bits: int, rate_bits: int, cap_height: int) -> tuple:
    """(permutations, bytes) of one proof's hash work."""
    perms, nbytes = pow_work(proof.proof.opening_proof.pow_witness)
    for rows, cols in proof_trees(proof, degree_bits, rate_bits):
        p, b = tree_work(rows, cols, cap_height)
        perms, nbytes = perms + p, nbytes + b
    return perms, nbytes


def bound_s(perms: int, nbytes: int) -> tuple:
    """The least seconds for the work, and which bound it is."""
    t_ops = perms * MULS_PER_PERM / INT32_MUL_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
