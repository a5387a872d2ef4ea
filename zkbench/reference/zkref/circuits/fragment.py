"""CircuitFragment protocol + shared in-circuit gadgets.

Ports the reference's composition pattern and gadget semantics:
- CircuitFragment trait: common/src/circuit.rs:22-36
  (per-fragment Targets + static circuit() builder + fill_targets()).
- is_const_less_than / xor: common/src/gadgets.rs:14-65.
"""

from __future__ import annotations

from typing import Protocol

from ..iop.builder import CircuitBuilder
from ..iop.targets import BoolTarget
from ..iop.witness import PartialWitness


class CircuitFragment(Protocol):
    """Each fragment exposes a Targets container, a static circuit builder,
    and a witness filler (mirrors common/src/circuit.rs:22-36)."""

    @staticmethod
    def circuit(targets, builder: CircuitBuilder) -> None: ...

    def fill_targets(self, pw: PartialWitness, targets) -> None: ...


def xor(builder: CircuitBuilder, a: BoolTarget, b: BoolTarget) -> BoolTarget:
    """a XOR b = a + b - 2ab (gadgets.rs:53-65)."""
    ab = builder.mul(a.target, b.target)
    two_ab = builder.mul_const(2, ab)
    a_plus_b = builder.add(a.target, b.target)
    return BoolTarget(builder.sub(a_plus_b, two_ab))


def is_const_less_than(
    builder: CircuitBuilder, left: int, right: int, n_log: int
) -> BoolTarget:
    """True iff const ``left`` < target ``right`` (gadgets.rs:14-41).

    Decomposes ``right`` into n_log bits and compares MSB-first."""
    right_bits = builder.split_le(right, n_log)
    left_bits = [((left >> i) & 1) != 0 for i in range(n_log)]

    lt = builder._false()
    eq = builder._true()
    for i in range(n_log - 1, -1, -1):
        a = builder.constant_bool(left_bits[i])
        b = right_bits[i]
        not_a = builder.not_(a)
        not_a_and_b = builder.and_(not_a, b)
        this_lt = builder.and_(not_a_and_b, eq)
        lt = builder.or_(lt, this_lt)
        a_xor_b = xor(builder, a, b)
        not_xor = builder.not_(a_xor_b)
        eq = builder.and_(eq, not_xor)
    return lt
