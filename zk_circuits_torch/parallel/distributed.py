"""Multi-process runtime: torch.distributed set-up and the hybrid
(hosts x cards) mesh.

Counterpart of the JAX package's parallel/distributed.py.  Processes join
through :func:`initialize` (``torch.distributed.init_process_group``);
each process owns its shards and holds only their tensors.
:func:`hybrid_mesh` builds the 2-D mesh with a slow outer ``"dcn"`` axis
(one index per process, or per virtual host in one process) and a fast
inner ``"ici"`` axis (the shards of one process).  Batch axes shard over
``"dcn"`` with no communication (``ntt_sharded.lde_batch_sharded(...,
axis="dcn")``); the four-step NTT shards one polynomial over both axes
(``axis=("dcn", "ici")``), its cross-process blocks crossing in one
collective per exchange (parallel/ntt_exchange.py).

The backend is named by the caller and never switched: ``"nccl"`` for
processes that each own their cards, ``"gloo"`` on the CPU or where
processes share a card (NCCL refuses two ranks on one device); with
``gloo`` the cross-process blocks of CUDA shards are staged through host
memory.  scripts/torch_multihost_sim.py runs N such processes.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, local_devices

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None) -> None:
    """Join the process group: ``tcp://coordinator_address`` with the
    world size ``num_processes`` and this process's rank ``process_id``
    when they are given, else torchrun's environment (``env://``).
    ``backend`` ("nccl" or "gloo") must be named; the backend in use is
    printed.  Under nccl the group is bound to the process's current card
    (``torch.cuda.set_device`` first), and every collective of the port
    runs on that card."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"name the backend, one of {BACKENDS}: 'nccl' for processes that "
                         f"each own their cards, 'gloo' on the CPU or for processes that "
                         f"share a card; got {backend!r}")
    given = (coordinator_address, num_processes, process_id)
    if all(v is not None for v in given):
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                  rank=process_id)
    elif any(v is not None for v in given):
        raise ValueError("give coordinator_address, num_processes and process_id "
                         "together, or none of them (torchrun's environment)")
    else:
        kw = dict(init_method="env://")
    if backend == "nccl":
        # bind the group to this process's current card: left unbound, the
        # first barrier guesses the card from the rank (rank % cards), and a
        # collective on another card then opens a second communicator that
        # the other ranks never join
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, **kw)
    print(f"[zkt] process {dist.get_rank()} of {dist.get_world_size()}: "
          f"torch.distributed backend {dist.get_backend()}", flush=True)


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def hybrid_mesh(dcn_axis: str = "dcn", ici_axis: str = "ici",
                num_hosts: int | None = None, *, local_shards: int | None = None,
                device="cuda") -> Mesh:
    """The (num_hosts, shards per host) mesh: the outer axis crosses
    processes, the inner one stays in a process.  ``local_shards`` (the
    shards this process holds, by default one per card) are placed as
    ``make_mesh`` places them; every process holds as many.  With several
    processes ``num_hosts`` defaults to, and must equal, their count; in
    one process ``num_hosts`` (default 1) splits the local shards into
    virtual hosts, as the JAX package's tests do."""
    devices = local_devices(local_shards, device)
    procs, rank = process_count(), process_index()
    if procs > 1:
        if num_hosts not in (None, procs):
            raise ValueError(f"num_hosts={num_hosts} across {procs} processes")
        return Mesh(devices * procs, (dcn_axis, ici_axis), (procs, len(devices)),
                    tuple(p for p in range(procs) for _ in devices), rank)
    num_hosts = num_hosts or 1
    if len(devices) % num_hosts:
        raise ValueError(f"{len(devices)} shards are not divisible by {num_hosts} hosts")
    return Mesh(devices, (dcn_axis, ici_axis), (num_hosts, len(devices) // num_hosts))


def host_local_slice(mesh: Mesh, axis: str = "dcn") -> int:
    """The index of this process along the DCN axis (for host-sharded IO)."""
    return process_index() % mesh.shape[axis]


def all_to_all(send: list, recv_sizes: list, device) -> list:
    """One ``all_to_all_single``: ``send[q]`` (int64, empty for this
    process) goes to process q, and process p sends ``recv_sizes[p]``
    elements here; returns them, 1-D, on ``device``.  Under gloo, CUDA
    tensors cross through host memory; under nccl, through the card the
    group is bound to."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        stage = torch.device("cpu")
    else:                           # the card the group is bound to
        stage = torch.device("cuda", torch.cuda.current_device())
    inp = torch.cat([t.reshape(-1).to(stage) for t in send])
    out = torch.empty(sum(recv_sizes), dtype=torch.int64, device=stage)
    dist.all_to_all_single(out, inp, list(recv_sizes), [t.numel() for t in send])
    return list(torch.split(out.to(device), list(recv_sizes)))
