"""Device mesh helpers for the distributed prover.

Counterpart of the JAX package's parallel/mesh.py.  A mesh is a tuple of E
shard devices laid out row-major over named axes (a 1-D mesh has the one
axis ``"x"``; parallel/distributed.py's hybrid mesh has ``("dcn",
"ici")``), with ``shape`` mapping each name to its size as JAX's
``mesh.shape`` does, and the process that owns each shard.  A process
holds only its own shards: a sharded tensor is a list with one tensor per
shard of this process (``mesh.local``), shard i on ``mesh.devices[i]``.
On a machine with ``count`` cards shard i lives on ``cuda:(i % count)``,
so a one-card machine holds all E shards on ``cuda:0`` (E logical shards;
the block exchange, K2, moves their data on that card) and a machine with
several cards spreads them.  On the CPU every shard is ``cpu``.

``shard_last``, ``shard_batch`` and ``replicated`` split or copy a tensor
onto the mesh, as the JAX versions' PartitionSpecs place it: split over
the axes named by ``axis`` (a name or a tuple of names, every axis by
default) and copied along the others.  ``gather`` joins shards back into
one tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple            # torch.device of every shard, row-major over the axes
    axis_names: tuple = ("x",)
    axis_sizes: tuple = ()    # default: one axis over every shard
    processes: tuple = ()     # the owning process of every shard; default: all 0
    process: int = 0          # this process's index

    def __post_init__(self):
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if not self.processes:
            object.__setattr__(self, "processes", (0,) * len(self.devices))
        if len(self.axis_names) != len(self.axis_sizes) or \
                math.prod(self.axis_sizes) != len(self.devices) or \
                len(self.processes) != len(self.devices):
            raise ValueError(f"axes {self.axis_names} of sizes {self.axis_sizes} and "
                             f"{len(self.processes)} owners do not fit "
                             f"{len(self.devices)} shards")
        if self.process not in self.processes:
            raise ValueError(f"process {self.process} holds no shard of the mesh")

    @property
    def shape(self) -> dict:
        """Each axis name's size, as JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Every shard of the mesh, in all processes."""
        return len(self.devices)

    @property
    def local(self) -> tuple:
        """The indices of the shards this process holds."""
        return tuple(i for i, p in enumerate(self.processes) if p == self.process)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.processes)) > 1

    @property
    def first(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[self.local[0]]

    def axes(self, axis=None) -> tuple:
        """``axis`` (a name, a tuple of names, or None for every axis) as a
        tuple of names of this mesh."""
        names = self.axis_names if axis is None else (
            (axis,) if isinstance(axis, str) else tuple(axis))
        if any(a not in self.axis_names for a in names) or len(set(names)) != len(names):
            raise ValueError(f"axis {axis!r} is not a set of the mesh's axes {self.axis_names}")
        return names

    def block_index(self, axis=None) -> tuple:
        """The block of a tensor split over ``axis`` that each shard holds:
        its coordinates along those axes, row-major in the order given."""
        names = self.axes(axis)
        out = []
        for i in range(self.size):
            coords, rest = {}, i
            for name, size in reversed(list(zip(self.axis_names, self.axis_sizes))):
                coords[name] = rest % size
                rest //= size
            b = 0
            for name in names:
                b = b * self.shape[name] + coords[name]
            out.append(b)
        return tuple(out)


def flatten(mesh: Mesh, axis=None) -> tuple[Mesh, tuple]:
    """A vector split over ``axis`` (every axis of a one-process mesh) as
    the 1-D mesh whose shard b holds block b, and the block each shard of
    ``mesh`` holds."""
    if mesh.spans_processes or set(mesh.axes(axis)) != set(mesh.axis_names):
        raise ValueError(f"expected every axis of a one-process mesh {mesh.axis_names}, "
                         f"got {axis!r}")
    blocks = mesh.block_index(axis)
    devices = [None] * mesh.size
    for i, b in enumerate(blocks):
        devices[b] = mesh.devices[i]
    return Mesh(tuple(devices)), blocks


def axis_mesh(mesh: Mesh, axis) -> Mesh:
    """The one-process ``mesh`` as the 1-D mesh over ``axis`` (a name, or a
    tuple of names covering every axis): shard b holds block b.  An
    ``axis`` that is neither raises TypeError."""
    if not (isinstance(axis, str) or (isinstance(axis, tuple) and axis
                                      and all(isinstance(a, str) for a in axis))):
        raise TypeError(f"axis must be a mesh axis name or a tuple of names, got {axis!r}")
    return flatten(mesh, axis)[0]


def _axis_size(mesh: Mesh, axis=None) -> int:
    """The number of blocks along one axis name or a tuple of names
    (every axis by default)."""
    return math.prod(mesh.shape[a] for a in mesh.axes(axis))


def make_mesh(n_devices: int | None = None, axis: str = "x",
              device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` shards (a power of two) on the cards, or
    on the CPU with ``device="cpu"``.  Without CUDA, ``device="cuda"``
    raises.  ``n_devices`` defaults to the number of cards (1 on the CPU)."""
    return Mesh(local_devices(n_devices, device), (axis,))


def local_devices(n: int | None = None, device="cuda") -> tuple:
    """``n`` shard devices of this process (a power of two): shard i on
    ``cuda:(i % count)``, or every shard on the CPU; ``n`` defaults to the
    number of cards."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = (torch.device("cpu"),) * (n or 1)
    else:
        count = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i % count) for i in range(n or count))
    if len(devices) & (len(devices) - 1):
        raise ValueError(f"the mesh size must be a power of two, got {len(devices)}")
    return devices


def _place(x: torch.Tensor, mesh: Mesh, dim: int, axis) -> list:
    """Split ``dim`` of ``x`` over ``axis`` (no axis: the whole tensor) and
    hand each local shard its block on its device; shards that hold one
    block on one device share one tensor."""
    k = _axis_size(mesh, axis)
    if x.shape[dim] % k:
        raise ValueError(f"length {x.shape[dim]} is not a multiple of {k}")
    blocks = mesh.block_index(axis)
    chunks = torch.chunk(x, k, dim=dim)
    placed: dict = {}
    out = []
    for i in mesh.local:
        key = (blocks[i], mesh.devices[i])
        if key not in placed:
            placed[key] = chunks[blocks[i]].contiguous().to(mesh.devices[i])
        out.append(placed[key])
    return out


def shard_last(x: torch.Tensor, mesh: Mesh, axis=None) -> list:
    """Split the last dimension into blocks over ``axis`` (every axis by
    default), one per shard along it."""
    return _place(x, mesh, -1, axis)


def shard_batch(x: torch.Tensor, mesh: Mesh, axis=None) -> list:
    """Split the first (batch) dimension into blocks over ``axis`` (every
    axis by default), one per shard along it."""
    return _place(x, mesh, 0, axis)


def replicated(x: torch.Tensor, mesh: Mesh) -> list:
    """The same tensor on every local shard's device."""
    return _place(x, mesh, 0, ())


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
