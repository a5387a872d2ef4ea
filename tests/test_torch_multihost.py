"""The port's multi-process runtime against the JAX package's
(tests/test_multihost.py's counterparts).

- In one process, ``hybrid_mesh(num_hosts=2)`` over 8 CPU shards: the
  four-step NTT and INTT over the combined ("dcn", "ici") axis (and over
  ("ici", "dcn")) equal to JAX's ``ntt_sharded(..., axis=("dcn", "ici"))``
  on its hybrid mesh of the conftest's 8 virtual devices and to the host
  NTT; the batch LDE over "dcn" alone equal to JAX's and to ``host_lde``.
- Two real OS processes of scripts/torch_multihost_sim.py joined by
  torch.distributed's gloo backend on the CPU: each process's shards of
  the NTT and the "dcn" batch LDE equal to the host's, and of the INTT of
  the NTT equal to the input; ``prove_batch`` over the two processes'
  shards equal to the unsharded batch.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from zk_circuits_torch.field import goldilocks as tgf
from zk_circuits_torch.parallel import distributed as tdist
from zk_circuits_torch.parallel import mesh as tmesh
from zk_circuits_torch.parallel import ntt_sharded as tns
from zk_circuits_tpu.field import goldilocks as jgf
from zk_circuits_tpu.host import gl
from zk_circuits_tpu.ntt import ntt as jntt
from zk_circuits_tpu.parallel import ntt_sharded as jns
from zk_circuits_tpu.parallel.distributed import hybrid_mesh as j_hybrid_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _joined(shards, mesh, axis, dim=-1):
    """The full vector from shards split over ``axis``, in block order."""
    blocks = mesh.block_index(axis)
    return tgf.to_u64(tmesh.gather([shards[blocks.index(b)] for b in range(max(blocks) + 1)],
                                   dim=dim))


def test_hybrid_mesh_ntt_matches_jax_and_host():
    mesh = tdist.hybrid_mesh(num_hosts=2, local_shards=8, device="cpu")
    assert mesh.shape == {"dcn": 2, "ici": 4}
    n = 1 << 10
    rng = np.random.default_rng(3)
    poly = rng.integers(0, gl.P_INT, size=n, dtype=np.uint64)
    j_mesh = j_hybrid_mesh(num_hosts=2)
    x = jax.device_put(jgf.from_u64(poly), NamedSharding(j_mesh, P(("dcn", "ici"))))
    want = jgf.to_u64(jns.ntt_sharded(x, j_mesh, axis=("dcn", "ici")))
    assert np.array_equal(want, jntt.host_ntt(poly))
    for axis in (("dcn", "ici"), ("ici", "dcn")):
        xs = tmesh.shard_last(tgf.from_u64(poly), mesh, axis)
        assert np.array_equal(_joined(tns.ntt_sharded(xs, mesh, axis=axis), mesh, axis), want)
        assert np.array_equal(_joined(tns.intt_sharded(xs, mesh, axis=axis), mesh, axis),
                              jntt.host_intt(poly))
    with pytest.raises(ValueError, match="every axis"):
        tns.ntt_sharded(tmesh.shard_last(tgf.from_u64(poly), mesh, "dcn"), mesh, axis="dcn")


def test_hybrid_mesh_coset_lde_over_both_axes():
    mesh = tdist.hybrid_mesh(num_hosts=2, local_shards=8, device="cpu")
    rng = np.random.default_rng(5)
    coeffs = rng.integers(0, gl.P_INT, size=1 << 8, dtype=np.uint64)
    axis = ("ici", "dcn")
    got = tns.coset_lde_sharded(tmesh.shard_last(tgf.from_u64(coeffs), mesh, axis), 2, mesh,
                                axis=axis)
    assert np.array_equal(_joined(got, mesh, axis), jntt.host_lde(coeffs, 2))


def test_hybrid_mesh_batch_lde_dcn_only():
    mesh = tdist.hybrid_mesh(num_hosts=2, local_shards=8, device="cpu")
    rng = np.random.default_rng(4)
    coeffs = rng.integers(0, gl.P_INT, size=(4, 128), dtype=np.uint64)
    j_mesh = j_hybrid_mesh(num_hosts=2)
    want = jgf.to_u64(jns.lde_batch_sharded(jgf.from_u64(coeffs), 3, j_mesh, axis="dcn"))
    assert np.array_equal(want, jntt.host_lde(coeffs, 3))
    shards = tmesh.shard_batch(tgf.from_u64(coeffs), mesh, "dcn")
    got = tns.lde_batch_sharded(shards, 3, mesh, axis="dcn")
    assert got[0] is got[3] and got[4] is got[7]    # one LDE per host's block
    assert np.array_equal(_joined(got, mesh, "dcn", dim=0), want)


def test_two_process_simulation():
    """scripts/torch_multihost_sim.py: 2 processes x 2 CPU shards, gloo,
    n = 2^9; every process's shards equal to the host's; a batch of 4
    square proofs over the 4 shards (each process proving its two, the
    others' arriving in the all-gather) equal to the unsharded batch."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_multihost_sim.py"),
         "--procs", "2", "--local-shards", "2", "--log2n", "9", "--device", "cpu",
         "--backend", "gloo", "--timeout", "100", "--batch", "4"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "torch.distributed backend gloo" in proc.stdout
    res = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert res["ok"] and res["procs"] == 2 and res["shards"] == 4
    assert res["mesh"] == {"dcn": 2, "ici": 2} and res["backend"] == "gloo"
    assert res["ntt_equal_host"] and res["intt_of_ntt_equal_input"] and res["lde_dcn_equal_host"]
    batch = res["batch"]
    assert batch["equal_unsharded"] and len(set(batch["sha256"])) == 4


def test_initialize_binds_nccl_to_the_current_card(monkeypatch):
    """Under nccl the group is bound to the process's current card, so no
    collective guesses a card from the rank (a guess that put a rank's
    barrier and its exchanges on two cards, two communicators, and hung);
    under gloo no card is named."""
    import torch
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: calls[-1][0])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    tdist.initialize("localhost:1234", 2, 1, backend="nccl")
    tdist.initialize("localhost:1234", 2, 1, backend="gloo")
    tcp = dict(init_method="tcp://localhost:1234", world_size=2, rank=1)
    assert calls == [("nccl", dict(tcp, device_id=torch.device("cuda", 1))), ("gloo", tcp)]
    with pytest.raises(ValueError, match="name the backend"):
        tdist.initialize("localhost:1234", 2, 1)

