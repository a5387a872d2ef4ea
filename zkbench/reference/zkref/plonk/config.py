"""Circuit and FRI configuration.

Mirrors the reference engine's ``CircuitConfig`` presets
(``standard_recursion_config`` / ``standard_recursion_zk_config`` as used at
wormhole/circuit/src/circuit.rs:70 and
wormhole/tests/src/circuit_helpers.rs:14-16):
135 wires / 80 routed, 2 constants, 2 challenges, rate_bits=3, cap_height=4,
16-bit proof-of-work, ConstantArityBits(4, 5), 28 query rounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    # ConstantArityBits(arity_bits, final_poly_bits)
    reduction_arity_bits: int = 4
    final_poly_bits: int = 5
    num_query_rounds: int = 28

    def reduction_arities(self, degree_bits: int) -> list[int]:
        """Fold arities (in bits) for a codeword of degree 2^degree_bits."""
        arities = []
        while degree_bits > self.final_poly_bits:
            step = min(self.reduction_arity_bits, degree_bits - self.final_poly_bits)
            arities.append(step)
            degree_bits -= step
        return arities

    def num_queries_total(self) -> int:
        return self.num_query_rounds


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    use_base_arithmetic_gate: bool = True
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(default_factory=FriConfig)

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        return CircuitConfig(zero_knowledge=True)

    @staticmethod
    def test_config(num_query_rounds: int = 28) -> "CircuitConfig":
        """Smaller FRI for fast unit tests (soundness reduced, semantics kept)."""
        return CircuitConfig(
            fri_config=FriConfig(num_query_rounds=num_query_rounds)
        )

    @property
    def rate_bits(self) -> int:
        return self.fri_config.rate_bits
