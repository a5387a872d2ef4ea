"""The torch port's CUDA kernel on the card, against its plain version.

Needs an NVIDIA GPU and nvcc; skipped without a card.  Imports no JAX, so
it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as gf
from zk_circuits_torch.hash import poseidon as plain
from zk_circuits_torch.hash import poseidon_cuda
from zk_circuits_torch.hash import poseidon_pallas as pp

P = 2**64 - 2**32 + 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the leaf kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,cols", [(1, 5), (127, 9), (4096, 139), (5000, 32)])
def test_leaf_kernel_matches_plain(cuda, n, cols):
    x = np.random.default_rng(n + cols).integers(0, P, (n, cols), dtype=np.uint64)
    x[0, 0] = 2**64 - 1                       # non-canonical input lane
    rows = torch.from_numpy(x.view(np.int64)).to(cuda)
    before = poseidon_cuda.launches
    want = gf.to_u64(plain.batch_hash_no_pad(rows))
    got_rows = gf.to_u64(pp.hash_leaves(rows))
    got_vals = gf.to_u64(pp.hash_values(rows.t().contiguous()))
    torch.cuda.synchronize()
    assert poseidon_cuda.launches == before + 2
    assert np.array_equal(got_rows, want)
    assert np.array_equal(got_vals, want)
    assert (got_rows < np.uint64(P)).all()


def test_square_proof_cuda_equals_cpu(cuda):
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.plonk.config import CircuitConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    out = []
    for device in ("cuda", "cpu"):
        b = CircuitBuilder(CircuitConfig.standard_recursion_zk_config())
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        data = b.build(device=device)
        pw = PartialWitness()
        pw.set_target(x, 5)
        out.append(proof_to_bytes(data.prove(pw, device=device)))
    assert out[0] == out[1]
