"""The aggregator's level prove over a mesh that spans two processes, on
the CPU.

Two OS processes (this file run as a script) join torch.distributed's
gloo backend and hold one CPU shard each of ``hybrid_mesh``; each calls
``LevelCircuit.prove_level(..., mesh=mesh)`` (what ``aggregate_to_tree``
runs for a level of more than b proofs) on level 1 of the tree of
tests/test_torch_mesh_aggregate.py: the pushed square proof of 2 and
three padding proofs of 1, b=2.  Each process proves its own chunk and
receives the other's proof in the all-gather.  Both proofs must verify
and be byte-equal, in both processes, to the level-1 proofs under the
root that file holds to the JAX package's mesh aggregate: their sha256,
pinned below, come from that tree proved in one process, whose root
equals ``JAX_MESH_ROOT_SHA256``.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS = 2
THREADS = 2         # torch threads a process (the plain sponge's proofs)
LEVEL1_SHA256 = ["a3bcae2eb3bae415bcf546b752fffa6c385d735fa30a80d0856706d0cd8828b6",
                 "a08d18ba0c92a72e06530c5a6b35e857781e254d2393131ef161081225468597"]


def worker(rank: int, port: int) -> None:
    sys.path.insert(0, REPO)
    import hashlib

    import torch
    import torch.distributed as dist

    from zk_circuits_torch.aggregation.tree import LevelCircuit
    from zk_circuits_torch.iop.builder import CircuitBuilder
    from zk_circuits_torch.iop.witness import PartialWitness
    from zk_circuits_torch.parallel import distributed
    from zk_circuits_torch.plonk import prover_batch
    from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    torch.set_num_threads(THREADS)
    distributed.initialize(f"localhost:{port}", PROCS, rank, backend="gloo")
    mesh = distributed.hybrid_mesh(local_shards=1, device="cpu")
    b = CircuitBuilder(CircuitConfig(zero_knowledge=True, fri_config=FriConfig(
        num_query_rounds=2, proof_of_work_bits=1)))
    x = b.add_virtual_target()
    b.register_public_input(b.square(x))
    data = b.build(device="cpu")

    def prove(v):
        pw = PartialWitness()
        pw.set_target(x, v)
        return data.prove(pw, device="cpu")

    leaves = [prove(2)] + [prove(1)] * 3
    level = LevelCircuit.cached(data.common, 2, device="cpu")
    batches = []
    real = prover_batch.prove_batch_device

    def spy(cd, pws, device, *args, **kw):
        if cd is level.circuit_data:
            batches.append(len(pws))
        return real(cd, pws, device, *args, **kw)

    prover_batch.prove_batch_device = spy
    proofs = level.prove_level(leaves, data.verifier_only, mesh=mesh)
    for p in proofs:
        level.circuit_data.verify(p)
    mine = {"rank": rank, "sha256": [hashlib.sha256(proof_to_bytes(p)).hexdigest()
                                     for p in proofs], "batches": batches}
    every = [None] * PROCS
    dist.all_gather_object(every, mine)
    if rank == 0:
        print(json.dumps({"mesh": mesh.shape, "processes": every}), flush=True)
    dist.destroy_process_group()


def test_level_prove_over_two_processes_matches_the_pinned_tree():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r),
                               "--port", str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO)
             for r in range(PROCS)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-3000:]
    res = json.loads([ln for ln in outs[0][0].splitlines() if ln.startswith("{")][-1])
    assert res["mesh"] == {"dcn": 2, "ici": 1}
    for rank, got in enumerate(res["processes"]):
        assert got["rank"] == rank
        assert got["sha256"] == LEVEL1_SHA256
        assert got["batches"] == [1]    # its own chunk only; the other's arrived


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    a = ap.parse_args()
    worker(a.worker, a.port)
