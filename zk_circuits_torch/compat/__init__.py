"""Reference-format compatibility layer.

Readers for the byte formats produced by the reference stack (qp-plonky2's
DefaultGateSerializer artifacts and proof serialization — the reference
wormhole's bench-data/{common,verifier,proof}.bin) and a host verifier that
checks reference-produced proofs.  This is the interop/parity surface: a
user of the reference can hand the port their common.bin / verifier.bin /
proof.bin and verify them here (SURVEY.md §7.3 item 6).

Host numpy, like the port's other host modules: no device, no kernel.
The JAX package's copy is zk_circuits_tpu/compat/, whose NOTES.md holds
the reverse-engineering notes behind these formats and conventions.
"""

from .serde import (  # noqa: F401
    RefCommonData,
    RefProof,
    RefVerifierData,
    read_common_data,
    read_proof,
    read_verifier_data,
)
