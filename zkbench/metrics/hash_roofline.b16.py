"""hash_roofline.b16: the least time for the Poseidon work that the
window's proofs need (zkbench/yardstick/hash_work.py) over the device
time of K1's kernels, in percent."""

from zkbench.harness import readers

K1_KERNELS = ("k1_",)    # csrc/poseidon_leaf.cu: k1_leaf_kernel, k1_top_kernel, ...


def read(window):
    d = window.driver
    if d.shape_proof is None:
        return None
    return readers.hash_roofline_pct(window, K1_KERNELS,
                                     [(d.shape_proof, d.pow_witnesses, d.program.degree_bits)])
