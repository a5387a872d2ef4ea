"""The plain reference: zkref, a frozen plain copy of the prover."""
