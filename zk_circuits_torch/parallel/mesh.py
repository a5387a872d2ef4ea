"""Device mesh helpers for the distributed prover.

Counterpart of the JAX package's parallel/mesh.py.  A mesh is a tuple of E
shard devices and an axis name; a sharded tensor is a list of E per-shard
tensors, shard i on ``mesh.devices[i]``.  On a machine with ``count`` cards
shard i lives on ``cuda:(i % count)``, so a one-card machine holds all E
shards on ``cuda:0`` (E logical shards; the block exchange, K2, moves
their data on that card) and a machine with several cards spreads them.
On the CPU every shard is ``cpu``.

``shard_last``, ``shard_batch`` and ``replicated`` split or copy a tensor
onto the mesh (the JAX versions returned shardings for ``device_put``);
``gather`` joins shards back into one tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple   # torch.device of each shard
    axis: str = "x"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int | None = None, axis: str = "x",
              device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards (a power of two) on the cards, or on
    the CPU with ``device="cpu"``.  Without CUDA, ``device="cuda"`` raises.
    ``n_devices`` defaults to the number of cards (1 on the CPU)."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = (torch.device("cpu"),) * (n_devices or 1)
    else:
        count = torch.cuda.device_count()
        n = n_devices or count
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    if len(devices) & (len(devices) - 1):
        raise ValueError(f"the mesh size must be a power of two, got {len(devices)}")
    return Mesh(devices, axis)


def shard_last(x: torch.Tensor, mesh: Mesh) -> list:
    """Split the last dimension into E contiguous blocks, one per shard."""
    if x.shape[-1] % mesh.size:
        raise ValueError(f"length {x.shape[-1]} is not a multiple of {mesh.size}")
    return [c.contiguous().to(d) for c, d in
            zip(torch.chunk(x, mesh.size, dim=-1), mesh.devices)]


def shard_batch(x: torch.Tensor, mesh: Mesh) -> list:
    """Split the first (batch) dimension into E blocks, one per shard."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of {mesh.size}")
    return [c.contiguous().to(d) for c, d in
            zip(torch.chunk(x, mesh.size, dim=0), mesh.devices)]


def replicated(x: torch.Tensor, mesh: Mesh) -> list:
    """The same tensor on every shard's device."""
    return [x.to(d) for d in mesh.devices]


def gather(shards: list, dim: int = -1, device=None) -> torch.Tensor:
    """Concatenate shards along ``dim`` on ``device`` (default: the first
    shard's)."""
    device = shards[0].device if device is None else device
    return torch.cat([s.to(device) for s in shards], dim=dim)


def reshard(pieces: list, total: int, mesh: Mesh, dim: int = -1) -> list:
    """Block-shard the concatenation of ``pieces`` along ``dim`` (in order,
    on any devices), zero-padded to ``total``: E blocks of total/E, block i
    on shard i.  A plain copy, used where a vector or a batch changes
    length or owner (the LDE's zero padding, a fold that left too few
    coefficients per shard, the poly axis of a commit)."""
    e = mesh.size
    if total % e:
        raise ValueError(f"length {total} is not a multiple of {e}")
    size = total // e
    starts, pos = [], 0
    for p in pieces:
        starts.append(pos)
        pos += p.shape[dim]
    if pos > total:
        raise ValueError(f"{pos} entries do not fit in {total}")
    out = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * size, (i + 1) * size
        parts = []
        for p, s in zip(pieces, starts):
            a, b = max(lo - s, 0), min(hi - s, p.shape[dim])
            if a < b:
                parts.append(p.narrow(dim, a, b - a).to(dev))
        have = sum(t.shape[dim] for t in parts)
        if have < size:
            shape = list(pieces[0].shape)
            shape[dim] = size - have
            parts.append(torch.zeros(shape, dtype=torch.int64, device=dev))
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim))
    return out
