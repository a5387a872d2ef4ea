"""zk_circuits_torch -- the Plonky2-class prover on PyTorch and CUDA.

A port of the JAX package ``zk_circuits_tpu`` for NVIDIA Hopper.  It
imports torch and numpy only.  Field elements are int64 tensors holding
u64 bit patterns; host code (transcript, witness, builder, verifier) is
numpy.  The Poseidon leaf sponge is a hand-written CUDA kernel
(csrc/poseidon_leaf.cu), built with nvcc at first use.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asks for ``device="cpu"``.
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
