"""zkref -- the benchmark's plain reference prover.

A frozen copy of the port's framework-free host modules and of the plain
PyTorch bodies that its kernels replace (the wormhole circuit, the
builder, the device witness schedule, the prover's stages, FRI, the
recursive verifier circuit and the tree aggregation), with every kernel
and every call of the port's native host runtime taken out: numpy on the
host, plain torch operations on whatever device the tensors are on.  It
imports torch and numpy only, and nothing of the program it judges.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Never falls back to the CPU:
    "cuda" without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
