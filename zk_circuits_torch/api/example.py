"""End-to-end example: prove a wormhole withdrawal and export the hex proof.

The analog of the reference's `wormhole-example` binary
(wormhole/example/src/main.rs:24-73): synthesize a 0-node storage proof
whose root hash is Poseidon(leaf inputs), build circuit inputs, prove on
the card, extract the public inputs, verify, and write the proof hex to a
file (the "for_pallet" export flow of prover_tests.rs:86-120).

Run:  python -m zk_circuits_torch.api.example [out_file]
"""

from __future__ import annotations

import sys

import numpy as np

from ..circuits.wormhole import golden_fixtures
from ..circuits.wormhole.inputs import PublicCircuitInputs
from ..plonk.config import CircuitConfig
from ..utils.serialization import proof_to_bytes
from .prover import WormholeProver
from .verifier import WormholeVerifier


def main(out_file: str = "proof.hex", device="cuda") -> None:
    inputs = golden_fixtures.test_inputs()

    print("building wormhole circuit…", flush=True)
    prover = WormholeProver(CircuitConfig.standard_recursion_config(), device=device)
    print("committing inputs and proving…", flush=True)
    proof = prover.commit(inputs).prove(device=device)

    public = PublicCircuitInputs.try_from_slice(np.asarray(proof.public_inputs))
    print(f"nullifier:      {public.nullifier.hex()}")
    print(f"root hash:      {public.root_hash.hex()}")
    print(f"funding amount: {public.funding_amount}")
    print(f"exit account:   {public.exit_account.hex()}")

    verifier = WormholeVerifier.from_parts(
        prover.circuit_data.common, prover.circuit_data.verifier_only
    )
    verifier.verify(proof)
    print("proof verified")

    blob = proof_to_bytes(proof)
    with open(out_file, "w") as f:
        f.write(blob.hex())
    print(f"wrote {len(blob)} proof bytes (hex) to {out_file}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "proof.hex")
