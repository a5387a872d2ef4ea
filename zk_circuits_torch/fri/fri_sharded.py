"""Cross-shard FRI commit phase: one proof's FRI codeword sharded over a
mesh.  Counterpart of the JAX package's fri/fri_sharded.py.

At every fold round the coefficients are BLOCK-sharded (shard d holds a
contiguous slice, in order):

- the coset NTT onto the round's codeword is the four-step of
  parallel/ntt_sharded.py (three K2 exchanges per ext component);
- the fiber regroup before hashing (leaf g holds the codeword values
  {k*m + g}) is one more K2 exchange: with arity a multiple of E, shard s
  holds whole segments k, and the part of each segment that belongs to
  destination d's leaf rows is one strided block;
- each shard's subtree is one K1 tree-mode call on its leaf rows
  (hash/merkle.py::sharded_tree); only the cap is fetched;
- the fold (new_c[m] = sum_j beta^j c[arity*m + j], K9's fold mode on the
  card, beta in the launch's parameters)
  reads contiguous arity-groups, so it is shard-local while every shard holds a multiple of
  arity coefficients; once it does not (a short last round), the few
  coefficients left are folded on the first shard's device.

``fri_commit_sharded`` returns (caps, betas, final_poly), bit-exact with the
host commit phase (the same challenger transcript).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..hash import merkle as merklem
from ..host import gl
from ..parallel.mesh import Mesh, axis_mesh, gather, make_mesh, shard_last
from ..parallel.ntt_exchange import all_to_all_blocks
from ..parallel.ntt_sharded import coset_ntt_pieces
from .fri_device import fold


def fiber_leaves_sharded(v0: list, v1: list, arity: int, mesh: Mesh) -> list:
    """Block-sharded codeword pair -> row-sharded Merkle leaves: shard d
    gets leaf rows [d*m/E, (d+1)*m/E) of the (m, 2*arity) fiber matrix
    (m = size/arity), ext components interleaved as on one device."""
    e = mesh.size
    size = sum(v.shape[-1] for v in v0)
    m = size // arity
    if arity % e or m % e:
        raise ValueError(f"the fiber regroup needs arity ({arity}) and rows "
                         f"({m}) divisible by the mesh size {e}")
    xs = [torch.stack([a, b], dim=-1).reshape(arity // e, e, 2 * m // e).permute(1, 0, 2)
          for a, b in zip(v0, v1)]
    out = all_to_all_blocks(xs)   # shard d: (E, arity/E, 2m/E), source-major = k order
    return [o.reshape(arity, m // e, 2).permute(1, 0, 2).reshape(m // e, 2 * arity)
            for o in out]


def _commit_level(p0: list, p1: list, shift: int, size: int, a_bits: int,
                  cap_height: int, mesh: Mesh):
    v0 = coset_ntt_pieces(p0, shift, size, mesh)
    v1 = coset_ntt_pieces(p1, shift, size, mesh)
    leaves = fiber_leaves_sharded(v0, v1, 1 << a_bits, mesh)
    levels = merklem.sharded_tree(leaves, cap_height)
    return leaves, levels


def _fold(p0: list, p1: list, beta, a_bits: int):
    if any(p.shape[-1] % (1 << a_bits) for p in p0):
        p0, p1 = [gather(p0)], [gather(p1)]
    out0, out1 = [], []
    for a, b in zip(p0, p1):
        f0, f1 = fold(a, b, beta, a_bits)
        out0.append(f0)
        out1.append(f1)
    return out0, out1


def commit_phase_sharded(p0: list, p1: list, fri_config, degree_bits: int, ch,
                         mesh: Mesh,
                         shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    """The FRI commit chain from block-sharded ext coefficients (p0, p1).
    Returns (caps, trees, betas, final p0, final p1): trees are each
    round's (row-sharded leaves, levels); the final pieces are in order."""
    size = (1 << degree_bits) << fri_config.rate_bits
    caps, trees, betas = [], [], []
    for a_bits in fri_config.reduction_arities(degree_bits):
        leaves, levels = _commit_level(p0, p1, shift, size, a_bits,
                                       fri_config.cap_height, mesh)
        cap = gfd.to_u64(gather(levels[-1], dim=0))
        caps.append(cap)
        trees.append((leaves, levels))
        ch.observe_cap(cap)
        beta = ch.get_extension_challenge()
        betas.append(beta)
        p0, p1 = _fold(p0, p1, beta, a_bits)
        shift = pow(shift, 1 << a_bits, gl.P_INT)
        size >>= a_bits
    return caps, trees, betas, p0, p1


def fri_commit_sharded(coeffs_ext: np.ndarray, degree_bits: int, fri_config,
                       challenger, mesh: Mesh | None = None, axis="x",
                       coset_shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR):
    """Sharded FRI commit phase for one (n, 2) ext coefficient vector,
    split over ``axis`` of a one-process mesh (a name, or a tuple of names
    covering every axis; anything else raises TypeError).

    Returns (caps, betas, final_poly), bit-exact with the host commit
    phase.  The mesh defaults to every card (``make_mesh()``)."""
    mesh = axis_mesh(make_mesh() if mesh is None else mesh, axis)
    coeffs_ext = np.asarray(coeffs_ext, dtype=np.uint64)
    p0, p1 = (shard_last(gfd.from_u64(np.ascontiguousarray(coeffs_ext[:, c]),
                                      mesh.first), mesh) for c in (0, 1))
    caps, _, betas, p0, p1 = commit_phase_sharded(
        p0, p1, fri_config, degree_bits, challenger, mesh, coset_shift)
    return caps, betas, gfd.to_ext(gather(p0), gather(p1))
