"""Multi-process run of the torch port's sharded NTT: N OS processes, each
holding ``--local-shards`` shards of one hybrid (dcn, ici) mesh.

The counterpart of scripts/multihost_sim.py.  Every process joins
torch.distributed (parallel/distributed.py; the backend named by
``--backend``) and runs

1. the four-step NTT and its inverse over the combined ("dcn", "ici")
   axis: each of the three exchanges sends the blocks other processes
   read in one all_to_all_single, then K2's fused mode (on CUDA shards;
   its plain version on CPU shards) runs over local sources;
2. a batch LDE with the polynomial axis over "dcn" alone (no
   communication);
3. with ``--batch B``, ``prove_batch`` of B witnesses of one circuit
   over the same mesh, every process proving its own shards' witnesses
   and receiving the others' proofs in one all-gather (``--circuit``:
   the zk wormhole of the golden inputs under
   standard_recursion_zk_config, or the square circuit under a cheap FRI
   config with witnesses 2, 3, ...), cold and warm, and on process 0 the
   same batch unsharded in that process alone.

Each process checks its own shards against the host NTT (and LDE) of
the same seeded input, and the INTT of the NTT against the input; each
proof of the batch against the unsharded batch's.  Process 0 prints ONE
JSON line: the backend, the mesh, the seconds of a warm NTT (all
processes synchronised around it), every process's K2 launches by mode
and, with ``--batch``, the batch's seconds and the proofs' sha256.

    python scripts/torch_multihost_sim.py --procs 2 --local-shards 2 \\
        --log2n 9 --device cpu --backend gloo
    python scripts/torch_multihost_sim.py --procs 2 --local-shards 2 \\
        --log2n 22 --device cuda --backend nccl

With ``--device cuda`` each process gets ``cards // procs`` cards of its
own (CUDA_VISIBLE_DEVICES), its shards placed on them as make_mesh
places them; with fewer cards than processes every process uses cuda:0,
which only ``gloo`` allows (NCCL refuses two ranks on one card).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from zk_circuits_torch.field import goldilocks as gfd
    from zk_circuits_torch.host import gl
    from zk_circuits_torch.ntt import ntt as nttm
    from zk_circuits_torch.parallel import distributed, exchange_cuda
    from zk_circuits_torch.parallel import mesh as meshm
    from zk_circuits_torch.parallel import ntt_sharded as nts

    if args.device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)    # the processes share the host's cores
    distributed.initialize(f"localhost:{args.port}", args.procs, args.worker,
                           backend=args.backend)
    mesh = distributed.hybrid_mesh(local_shards=args.local_shards, device=args.device)
    axis = ("dcn", "ici")
    n = 1 << args.log2n
    rng = np.random.default_rng(7)
    x_host = rng.integers(0, gl.P_INT, size=n, dtype=np.uint64)
    xs = meshm.shard_last(gfd.from_u64(x_host), mesh, axis)
    want = nttm.host_ntt(x_host)
    blocks = mesh.block_index(axis)
    m = n // mesh.size

    def check(name, got, ref):
        for i, y in zip(mesh.local, got):
            b = blocks[i]
            if not np.array_equal(gfd.to_u64(y), ref[b * m:(b + 1) * m]):
                raise AssertionError(f"process {args.worker}: {name} shard {i} != host")

    def synced(fn):
        dist.barrier()
        t = time.perf_counter()
        out = fn()
        if args.device == "cuda":
            for d in dict.fromkeys(mesh.devices[i] for i in mesh.local):
                torch.cuda.synchronize(d)
        dist.barrier()
        return out, time.perf_counter() - t

    exchange_cuda.reset_launches()
    y, cold_s = synced(lambda: nts.ntt_sharded(xs, mesh, axis=axis))
    check("NTT", y, want)
    y, warm_s = synced(lambda: nts.ntt_sharded(xs, mesh, axis=axis))
    check("NTT", y, want)
    z, intt_s = synced(lambda: nts.intt_sharded(y, mesh, axis=axis))
    check("INTT", z, x_host)
    k2 = {"launches": exchange_cuda.launches, "by_mode": dict(exchange_cuda.launches_by_mode),
          "by_card": dict(exchange_cuda.launches_by_device)}

    # the batch LDE over "dcn" alone: host h extends polynomial block h
    hosts = mesh.shape["dcn"]
    coeffs = rng.integers(0, gl.P_INT, size=(2 * hosts, 256), dtype=np.uint64)
    out = nts.lde_batch_sharded(meshm.shard_batch(gfd.from_u64(coeffs), mesh, "dcn"), 3,
                                mesh, axis="dcn")
    want_lde = nttm.host_lde(coeffs, 3)
    dcn = mesh.block_index("dcn")
    for i, o in zip(mesh.local, out):
        h = dcn[i]
        if not np.array_equal(gfd.to_u64(o), want_lde[2 * h:2 * h + 2]):
            raise AssertionError(f"process {args.worker}: LDE shard {i} != host")

    batch = prove_batch_over(args, mesh, synced) if args.batch else None
    launches = [None] * args.procs
    dist.all_gather_object(launches, k2)
    if args.worker == 0:
        print(json.dumps({
            "ok": True, "procs": args.procs, "backend": dist.get_backend(),
            "device": args.device,
            "cards": torch.cuda.get_device_name(0) if args.device == "cuda" else None,
            "mesh": mesh.shape, "shards": mesh.size,
            "devices": [str(mesh.devices[i]) for i in mesh.local],
            "log2n": args.log2n, "ntt_equal_host": True, "intt_of_ntt_equal_input": True,
            "lde_dcn_equal_host": True, "ntt_cold_s": cold_s, "ntt_warm_s": warm_s,
            "intt_s": intt_s, "k2_by_process": launches, "batch": batch}), flush=True)
    dist.destroy_process_group()


def prove_batch_over(args, mesh, synced) -> dict:
    """``--batch`` witnesses proved over ``mesh`` (every process calls
    prove_batch with the same witnesses), cold and warm; process 0 then
    proves them unsharded alone and checks every proof's bytes."""
    import hashlib

    import torch.distributed as dist

    from zk_circuits_torch.plonk.prover import prove_batch
    from zk_circuits_torch.utils.serialization import proof_to_bytes

    device = mesh.first
    from zk_circuits_torch.plonk.config import CircuitConfig, FriConfig

    if args.circuit == "wormhole":
        from zk_circuits_torch.api.prover import WormholeProver
        from zk_circuits_torch.circuits.wormhole import golden_fixtures

        built = WormholeProver(CircuitConfig.standard_recursion_zk_config(), device=device)
        cd = built.circuit_data
        pws = [WormholeProver(circuit_data=cd, targets=built.targets)
               .commit(golden_fixtures.test_inputs()).partial_witness
               for _ in range(args.batch)]
    else:
        from zk_circuits_torch.iop.builder import CircuitBuilder
        from zk_circuits_torch.iop.witness import PartialWitness

        b = CircuitBuilder(CircuitConfig(zero_knowledge=True, fri_config=FriConfig(
            proof_of_work_bits=2, num_query_rounds=3, reduction_arity_bits=2,
            final_poly_bits=1)))
        x = b.add_virtual_target()
        b.register_public_input(b.square(x))
        cd = b.build(device=device)
        pws = []
        for v in range(2, 2 + args.batch):
            pw = PartialWitness()
            pw.set_target(x, v)
            pws.append(pw)
    proofs, cold_s = synced(lambda: prove_batch(cd, pws, mesh=mesh, device=args.device))
    proofs, warm_s = synced(lambda: prove_batch(cd, pws, mesh=mesh, device=args.device))
    out = {"circuit": args.circuit, "batch": args.batch, "cold_s": cold_s, "warm_s": warm_s,
           "sha256": [hashlib.sha256(proof_to_bytes(p)).hexdigest() for p in proofs]}
    if args.worker == 0:
        alone, unsharded_s = synced_local(lambda: prove_batch(cd, pws, device=device), device)
        if [proof_to_bytes(p) for p in alone] != [proof_to_bytes(p) for p in proofs]:
            raise AssertionError("the batch over processes != the batch unsharded")
        out.update(unsharded_s=unsharded_s, equal_unsharded=True)
    dist.barrier()
    return out


def synced_local(fn, device):
    """``fn()`` and its seconds in this process, ending in a synchronise."""
    import torch

    t = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, time.perf_counter() - t


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parent(args) -> int:
    env = dict(os.environ)
    cards = 0
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if cards < args.procs and args.backend == "nccl":
            raise SystemExit(f"nccl needs a card per process: {cards} cards, "
                             f"{args.procs} processes")
    per = cards // args.procs
    port = args.port or free_port()
    procs = []
    for pid in range(args.procs):
        penv = dict(env)
        if per:
            penv["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(pid * per + j) for j in range(per))
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", str(pid),
               "--procs", str(args.procs), "--local-shards", str(args.local_shards),
               "--log2n", str(args.log2n), "--device", args.device,
               "--backend", args.backend, "--port", str(port),
               "--batch", str(args.batch), "--circuit", args.circuit]
        procs.append(subprocess.Popen(cmd, env=penv, stdout=None if pid == 0 else
                                      subprocess.DEVNULL))
    rc = 0
    try:
        for p in procs:
            p.wait(timeout=args.timeout)
            rc |= p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc |= 1
    return rc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--log2n", type=int, default=12)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--circuit", choices=("square", "wormhole"), default="square")
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is None:
        sys.exit(parent(args))
    worker(args)


if __name__ == "__main__":
    main()
