"""The port's four-step NTT (zk_circuits_torch/ntt/ntt_mxu.py) on the CPU
against the JAX package's (zk_circuits_tpu/ntt/ntt_mxu.py), equal
integers: ``ntt_mxu`` and ``intt_mxu`` at n = 2, 8 and 128 (the direct
DFT), 256 and 2048 (``_split``'s small branch) and 2^14 (its n >= 128 *
128 branch) over batches (2, n) and (2, 3, n), and at 2^16 alone.  JAX's
eager ntt_mxu takes 1-9 s a call on a CPU, so one JAX call on the (2, 3, n)
batch serves both of the port's: the (2, n) batch is its rows [:, 0].
On the card ntt_mxu is K4 (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.ntt import ntt as tntt
from zk_circuits_torch.ntt import ntt_mxu as tmxu
from zk_circuits_tpu.field.goldilocks import GF
from zk_circuits_tpu.ntt import ntt_mxu as jmxu

P = 2**64 - 2**32 + 1
U64 = np.uint64


def _jax(fn, x: np.ndarray) -> np.ndarray:
    g = GF(jnp.asarray((x & U64(0xFFFFFFFF)).astype(np.uint32)),
           jnp.asarray((x >> U64(32)).astype(np.uint32)))
    y = fn(g)
    return np.asarray(y.lo).astype(U64) | (np.asarray(y.hi).astype(U64) << U64(32))


@pytest.mark.parametrize("fn", ["ntt_mxu", "intt_mxu"])
@pytest.mark.parametrize("n", [2, 8, 128, 256, 2048, 1 << 14, 1 << 16])
def test_ntt_mxu_matches_jax(n, fn):
    rng = np.random.default_rng(n + len(fn))
    lead = (1,) if n == 1 << 16 else (2, 3)
    x = rng.integers(0, P, (*lead, n), dtype=U64)
    x.reshape(-1, n)[0, : min(n, 3)] = np.array([0, 1, P - 1], dtype=U64)[: min(n, 3)]
    want = _jax(getattr(jmxu, fn), x)
    port = getattr(tmxu, fn)
    got = tgf.to_u64(port(tgf.from_u64(x)))
    assert np.array_equal(got, want)
    if lead == (2, 3):
        rows = np.ascontiguousarray(x[:, 0])
        assert np.array_equal(tgf.to_u64(port(tgf.from_u64(rows))), want[:, 0])
    stage_loop = tntt.ntt_plain if fn == "ntt_mxu" else tntt.intt_plain
    assert np.array_equal(got, tgf.to_u64(stage_loop(tgf.from_u64(x))))


def test_ntt_mxu_tables_match_jax():
    """The DFT matrix (u64 here, bf16 limb planes in the JAX package) and
    the geometric rows the four-step builds from."""
    for n in (2, 8, 128):
        planes = np.asarray(jmxu._dft_matrix_limbs(n), dtype=np.float32).astype(U64)
        want = sum(planes[i] << U64(8 * i) for i in range(8))
        assert np.array_equal(tmxu._dft_matrix(n), want)
    row = tmxu._geometric_row(12345, 37)
    assert np.array_equal(row, jmxu._geometric_row(12345, 37))
    assert np.array_equal(tmxu._vandermonde(row, 5), jmxu._vandermonde(row, 5))


def test_ntt_mxu_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tmxu.ntt_mxu(torch.zeros(16, dtype=torch.int64, device="meta"))
