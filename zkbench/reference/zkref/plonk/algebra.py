"""Field-algebra abstraction for constraint evaluation.

Gate constraint evaluators are written once against this interface and run
in three contexts:

- ``HostBase``   — numpy u64 arrays, base field (host-side quotient checks,
                   small tests).
- ``HostExt``    — numpy arrays with trailing dim 2, GF(p^2) (verifier's
                   evaluation at zeta).
- ``TorchBase``  — torch int64 tensors on one device (the prover's quotient
                   evaluation over the 8n-point coset; the hot path).

Values are arrays of shape (npoints, k) (+ (2,) for ext).  ``mds12`` gives
backends an exact fast path for the Poseidon MDS layer.
"""

from __future__ import annotations

import numpy as np

from ..host import gl, gle


class HostBase:
    is_extension = False

    def zeros(self, npoints: int, k: int):
        return np.zeros((npoints, k), dtype=np.uint64)

    def broadcast_scalar(self, c: int, npoints: int):
        return np.full((npoints,), c % gl.P_INT, dtype=np.uint64)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_scalar(self, a, c: int):
        return gl.mul(a, np.uint64(c % gl.P_INT))

    def add_scalar(self, a, c: int):
        return gl.add(a, np.uint64(c % gl.P_INT))

    def sub_from_scalar(self, c: int, a):
        return gl.sub(np.uint64(c % gl.P_INT), a)

    def mds12(self, state):
        from ..host.poseidon import _mds_layer

        return _mds_layer(state)

    def stack(self, cols):
        return np.stack(cols, axis=-1)

    def col(self, a, i: int):
        return a[..., i]

    def cols(self, a, lo: int, hi: int):
        return a[..., lo:hi]


class HostExt:
    is_extension = True

    def zeros(self, npoints: int, k: int):
        return np.zeros((npoints, k, 2), dtype=np.uint64)

    def broadcast_scalar(self, c: int, npoints: int):
        out = np.zeros((npoints, 2), dtype=np.uint64)
        out[..., 0] = c % gl.P_INT
        return out

    def add(self, a, b):
        return gle.add(a, b)

    def sub(self, a, b):
        return gle.sub(a, b)

    def mul(self, a, b):
        return gle.mul(a, b)

    def mul_scalar(self, a, c: int):
        return gle.mul_base(a, np.uint64(c % gl.P_INT))

    def add_scalar(self, a, c: int):
        out = a.copy()
        out[..., 0] = gl.add(a[..., 0], np.uint64(c % gl.P_INT))
        return out

    def sub_from_scalar(self, c: int, a):
        out = gle.neg(a)
        out[..., 0] = gl.add(out[..., 0], np.uint64(c % gl.P_INT))
        return out

    def mds12(self, state):
        from ..host.poseidon import _mds_layer

        # Linear map: apply to each extension component.
        out0 = _mds_layer(state[..., 0])
        out1 = _mds_layer(state[..., 1])
        return np.stack([out0, out1], axis=-1)

    def stack(self, cols):
        return np.stack(cols, axis=-2)

    def col(self, a, i: int):
        return a[..., i, :]

    def cols(self, a, lo: int, hi: int):
        return a[..., lo:hi, :]


class TorchBase:
    """Base-field algebra on int64 tensors of one device."""

    is_extension = False
    is_torch = True

    def __init__(self, device):
        self.device = device

    def zeros(self, npoints: int, k: int):
        from ..field import goldilocks as gfd

        return gfd.zeros((npoints, k), self.device)

    def broadcast_scalar(self, c: int, npoints: int):
        from ..field import goldilocks as gfd

        return gfd.full((npoints,), c, self.device)

    def add(self, a, b):
        from ..field import goldilocks as gfd

        return gfd.add(a, b)

    def sub(self, a, b):
        from ..field import goldilocks as gfd

        return gfd.sub(a, b)

    def mul(self, a, b):
        from ..field import goldilocks as gfd

        return gfd.mul(a, b)

    def mul_scalar(self, a, c: int):
        from ..field import goldilocks as gfd

        return gfd.mul_const(a, c)

    def add_scalar(self, a, c: int):
        from ..field import goldilocks as gfd

        if c % gl.P_INT == 0:
            return a
        return gfd.add(a, gfd.scalar(c, a))

    def sub_from_scalar(self, c: int, a):
        from ..field import goldilocks as gfd

        return gfd.sub(gfd.scalar(c, a), a)

    def mds12(self, state):
        from ..hash.poseidon import mds_layer

        return mds_layer(state)

    def stack(self, cols):
        import torch

        return torch.stack(cols, dim=-1)

    def col(self, a, i: int):
        return a[..., i]

    def cols(self, a, lo: int, hi: int):
        return a[..., lo:hi]


HOST_BASE = HostBase()
HOST_EXT = HostExt()
