"""hash_roofline.agg: the least time for the Poseidon work of the window's
level proves (zkbench/yardstick/hash_work.py) over the device time of
K1's kernels, in percent.  Every level proof has the root's trees (each
level circuit has the configuration's 2^level_degree_bits rows, which the
driver holds the root to); only the root's PoW witness leaves the
aggregator, so the other level proofs' grinds count at their least, one
permutation each, and the share is a lower bound by that much."""

from zkbench.harness import readers

K1_KERNELS = ("k1_",)    # csrc/poseidon_leaf.cu: k1_sponge_kernel, k1_top_kernel


def read(window):
    d = window.driver
    if d.shape_proof is None:
        return None
    root, bits = d.shape_proof
    per_aggregation = sum(d.b ** k for k in range(d.d))      # b^(d-1) + ... + 1
    witnesses = []
    for w in d.roots:
        witnesses += [w] + [0] * (per_aggregation - 1)
    return readers.hash_roofline_pct(window, K1_KERNELS, [(root, witnesses, bits)])
