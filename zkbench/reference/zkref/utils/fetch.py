"""Packed device->host fetches.

Torch counterpart of the JAX package's utils/fetch.py.  A transcript stage
of the batched prover needs several small tensors on the host at once
(every proof's caps, opening evaluations, final polynomials); they are
flattened into one tensor on the device and copied with one ``.cpu()``,
so the stage waits for the device once and not once per tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch_packed(tensors: list) -> list[np.ndarray]:
    """Canonical int64 tensors of one device -> u64 numpy arrays of the same
    shapes, with a single device-to-host copy."""
    tensors = list(tensors)
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy().view(np.uint64)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos : pos + t.numel()].reshape(t.shape))
        pos += t.numel()
    return out
