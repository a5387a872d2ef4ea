"""CircuitBuilder: wire graph, gate placement, copy constraints, and the
static witness schedule.

API surface mirrors the reference engine's ``CircuitBuilder`` usage by the
circuits (SURVEY.md §2.2): add_virtual_target(s), constants, arithmetic
ops, connect, select, is_equal, split_le / range_check, boolean logic,
hash_n_to_hash_no_pad, connect_hashes, register_public_input(s),
add_virtual_hash(_public_input).

Unlike the reference's demand-driven witness generators
(fixpoint iteration in qp-plonky2), generators here are compiled at build
time into a *static level-ordered schedule* of vectorized passes — every
op of the same (kind, level) executes as one numpy batch (SURVEY.md §7.1(4)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..host import gl
from ..plonk.config import CircuitConfig
from . import targets as T
from .gates import (
    ArithmeticExtensionGate,
    ArithmeticGate,
    BaseSum2Gate,
    ConstantGate,
    Gate,
    NoopGate,
    PoseidonGate,
    PublicInputGate,
    RandomAccessGate,
)

P = gl.P_INT


@dataclass
class GeneratorOp:
    """A single witness-generation op recorded during building."""

    kind: str           # 'arith' | 'base_sum' | 'poseidon' | 'const' | 'eq_inv'
    row: int = -1
    data: tuple = ()
    inputs: tuple = ()  # input targets
    outputs: tuple = ()  # output targets (routed); unrouted wires written direct


class UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p.get(root, root) != root:
            root = p[root]
        while p.get(x, x) != x:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        # Record both endpoints so every connected target is enumerable.
        self.parent.setdefault(a, a)
        self.parent.setdefault(b, b)
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


class CircuitBuilder:
    def __init__(self, config: Optional[CircuitConfig] = None):
        self.config = config or CircuitConfig.standard_recursion_config()
        self.gates: list[Gate] = []            # gate per row
        self.row_constants: list[list[int]] = []
        self.num_virtual = 0
        self.uf = UnionFind()
        self.connected: set[tuple[int, int]] = set()
        self.public_inputs: list[int] = []
        self.generators: list[GeneratorOp] = []
        self._constant_cache: dict[int, int] = {}
        self._const_slots: tuple[int, int] | None = None  # (row, next_slot)
        self._arith_slots: dict[tuple[int, int], tuple[int, int]] = {}
        self._arith_ext_slots: dict[tuple[int, int], tuple[int, int]] = {}
        self._ra_slots: dict[int, tuple[int, int]] = {}  # bits -> (row, copy)
        self._built = False

    # ------------------------------------------------------------------
    # rows / targets
    # ------------------------------------------------------------------

    def _add_row(self, gate: Gate, constants: list[int] | None = None) -> int:
        row = len(self.gates)
        self.gates.append(gate)
        consts = list(constants or [])
        assert len(consts) <= self.config.num_constants
        consts += [0] * (self.config.num_constants - len(consts))
        self.row_constants.append(consts)
        return row

    def add_virtual_target(self) -> int:
        t = T.virtual(self.num_virtual)
        self.num_virtual += 1
        return t

    def add_virtual_targets(self, n: int) -> list[int]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self) -> T.HashOutTarget:
        return T.HashOutTarget.from_list(self.add_virtual_targets(4))

    def add_virtual_hash_public_input(self) -> T.HashOutTarget:
        h = self.add_virtual_hash()
        self.register_public_inputs(h.elements)
        return h

    def add_virtual_public_input(self) -> int:
        t = self.add_virtual_target()
        self.register_public_input(t)
        return t

    def add_virtual_bool_target_safe(self) -> T.BoolTarget:
        t = self.add_virtual_target()
        self.assert_bool_target(t)
        return T.BoolTarget(t)

    def add_virtual_bool_target_unsafe(self) -> T.BoolTarget:
        return T.BoolTarget(self.add_virtual_target())

    # ------------------------------------------------------------------
    # copy constraints & public inputs
    # ------------------------------------------------------------------

    def connect(self, a: int, b: int):
        self.uf.union(a, b)

    def connect_hashes(self, a: T.HashOutTarget, b: T.HashOutTarget):
        for x, y in zip(a.elements, b.elements):
            self.connect(x, y)

    def register_public_input(self, t: int):
        self.public_inputs.append(t)

    def register_public_inputs(self, ts):
        for t in ts:
            self.register_public_input(t)

    # ------------------------------------------------------------------
    # constants
    # ------------------------------------------------------------------

    def constant(self, c: int) -> int:
        c %= P
        if c in self._constant_cache:
            return self._constant_cache[c]
        if self._const_slots is None or self._const_slots[1] >= 2:
            row = self._add_row(ConstantGate(num_consts=2), [0, 0])
            self.generators.append(
                GeneratorOp("const", row=row, outputs=(T.wire(row, 0), T.wire(row, 1)))
            )
            self._const_slots = (row, 0)
        row, slot = self._const_slots
        self.row_constants[row][slot] = c
        self._const_slots = (row, slot + 1)
        t = T.wire(row, slot)
        self._constant_cache[c] = t
        return t

    def zero(self) -> int:
        return self.constant(0)

    def one(self) -> int:
        return self.constant(1)

    def two(self) -> int:
        return self.constant(2)

    def _false(self) -> T.BoolTarget:
        return T.BoolTarget(self.zero())

    def _true(self) -> T.BoolTarget:
        return T.BoolTarget(self.one())

    def constant_bool(self, b: bool) -> T.BoolTarget:
        return self._true() if b else self._false()

    # ------------------------------------------------------------------
    # arithmetic ops
    # ------------------------------------------------------------------

    def arithmetic(self, c0: int, c1: int, m0: int, m1: int, addend: int) -> int:
        """out = c0 * m0 * m1 + c1 * addend; returns the output target."""
        c0 %= P
        c1 %= P
        key = (c0, c1)
        slot = self._arith_slots.get(key)
        num_ops = ArithmeticGate().num_ops
        if slot is None or slot[1] >= num_ops:
            row = self._add_row(ArithmeticGate(num_ops=num_ops), [c0, c1])
            slot = (row, 0)
        row, i = slot
        self._arith_slots[key] = (row, i + 1)
        w_m0, w_m1, w_add, w_out = (T.wire(row, 4 * i + j) for j in range(4))
        self.connect(m0, w_m0)
        self.connect(m1, w_m1)
        self.connect(addend, w_add)
        self.generators.append(
            GeneratorOp(
                "arith",
                row=row,
                data=(c0, c1),
                inputs=(w_m0, w_m1, w_add),
                outputs=(w_out,),
            )
        )
        return w_out

    def add(self, a: int, b: int) -> int:
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a: int, b: int) -> int:
        return self.arithmetic(1, P - 1, a, self.one(), b)

    def mul(self, a: int, b: int) -> int:
        return self.arithmetic(1, 0, a, b, self.zero())

    def mul_const(self, c: int, a: int) -> int:
        return self.arithmetic(c, 0, a, self.one(), self.zero())

    def mul_add(self, a: int, b: int, c: int) -> int:
        return self.arithmetic(1, 1, a, b, c)

    def mul_sub(self, a: int, b: int, c: int) -> int:
        """a*b - c."""
        return self.arithmetic(1, P - 1, a, b, c)

    def add_const(self, a: int, c: int) -> int:
        return self.add(a, self.constant(c))

    def neg(self, a: int) -> int:
        return self.mul_const(P - 1, a)

    def square(self, a: int) -> int:
        return self.mul(a, a)

    def exp_u64(self, base: int, exponent: int) -> int:
        result = self.one()
        b = base
        while exponent > 0:
            if exponent & 1:
                result = self.mul(result, b)
            if exponent > 1:
                b = self.mul(b, b)
            exponent >>= 1
        return result

    # ------------------------------------------------------------------
    # extension arithmetic (GF(p^2) wire pairs) — used by the recursive
    # verifier; one gate op per ext operation instead of 4-6 base ops.
    # ------------------------------------------------------------------

    def arithmetic_extension(
        self, c0: int, c1: int,
        m0: tuple[int, int], m1: tuple[int, int], addend: tuple[int, int],
    ) -> tuple[int, int]:
        """out = c0 * (m0 ⊗ m1) + c1 * addend over GF(p^2); returns the
        output wire pair."""
        c0 %= P
        c1 %= P
        key = (c0, c1)
        slot = self._arith_ext_slots.get(key)
        num_ops = ArithmeticExtensionGate().num_ops
        if slot is None or slot[1] >= num_ops:
            row = self._add_row(ArithmeticExtensionGate(num_ops=num_ops), [c0, c1])
            slot = (row, 0)
        row, i = slot
        self._arith_ext_slots[key] = (row, i + 1)
        ws = [T.wire(row, 8 * i + j) for j in range(8)]
        for t, w in zip((*m0, *m1, *addend), ws[:6]):
            self.connect(t, w)
        self.generators.append(
            GeneratorOp(
                "arith_ext",
                row=row,
                data=(c0, c1),
                inputs=tuple(ws[:6]),
                outputs=(ws[6], ws[7]),
            )
        )
        return (ws[6], ws[7])

    # ------------------------------------------------------------------
    # random access (in-circuit list indexing)
    # ------------------------------------------------------------------

    def _ra_copies(self, bits: int) -> int:
        V = 1 << bits
        # A copy needs V+2 routed wires (index, claimed element, V list
        # entries) plus `bits` unrouted bit wires.  If even one copy does
        # not fit, fail loudly at build time: silently flooring to 1 copy
        # would drop list-wire connects at cols >= num_routed_wires from
        # the permutation argument (a soundness hole).
        if V + 2 > self.config.num_routed_wires or V + 2 + bits > self.config.num_wires:
            raise ValueError(
                f"random_access with {bits} index bits needs {V + 2} routed wires "
                f"(config has {self.config.num_routed_wires}) and {V + 2 + bits} "
                f"total wires (config has {self.config.num_wires})"
            )
        return min(self.config.num_routed_wires // (V + 2),
                   self.config.num_wires // (V + 2 + bits))

    def random_access(self, index: int, values: list[int]) -> int:
        """values[index] as a routed wire; len(values) must be a power of
        two.  One RandomAccessGate copy instead of a len-1 select tree."""
        V = len(values)
        bits = V.bit_length() - 1
        assert 1 << bits == V and bits >= 1
        copies = self._ra_copies(bits)
        gate = RandomAccessGate(bits=bits, num_copies=copies)
        slot = self._ra_slots.get(bits)
        if slot is None or slot[1] >= copies:
            row = self._add_row(gate)
            slot = (row, 0)
        row, c = slot
        self._ra_slots[bits] = (row, c + 1)
        idx_w = T.wire(row, gate.wire_index(c))
        claimed_w = T.wire(row, gate.wire_claimed(c))
        self.connect(index, idx_w)
        for k, t in enumerate(values):
            self.connect(t, T.wire(row, gate.wire_list(c, k)))
        bit_ws = tuple(T.wire(row, gate.wire_bit(c, j)) for j in range(bits))
        self.generators.append(
            GeneratorOp(
                "random_access",
                row=row,
                data=(bits,),
                inputs=(idx_w,) + tuple(
                    T.wire(row, gate.wire_list(c, k)) for k in range(V)),
                outputs=(claimed_w,) + bit_ws,
            )
        )
        return claimed_w

    # ------------------------------------------------------------------
    # boolean logic
    # ------------------------------------------------------------------

    def assert_bool_target(self, t: int):
        sq = self.mul_sub(t, t, t)  # t^2 - t
        self.connect(sq, self.zero())

    def not_(self, b: T.BoolTarget) -> T.BoolTarget:
        return T.BoolTarget(self.sub(self.one(), b.target))

    def and_(self, a: T.BoolTarget, b: T.BoolTarget) -> T.BoolTarget:
        return T.BoolTarget(self.mul(a.target, b.target))

    def or_(self, a: T.BoolTarget, b: T.BoolTarget) -> T.BoolTarget:
        ab = self.mul(a.target, b.target)
        return T.BoolTarget(self.sub(self.add(a.target, b.target), ab))

    def select(self, b: T.BoolTarget, x: int, y: int) -> int:
        """b ? x : y  ==  b*x - (b*y - y)."""
        t = self.mul_sub(b.target, y, y)
        return self.arithmetic(1, P - 1, b.target, x, t)

    def is_equal(self, x: int, y: int) -> T.BoolTarget:
        """1 if x == y else 0, via witness inverse (sound: eq * (x-y) == 0
        and (x-y) * inv == 1 - eq with witnessed inv)."""
        diff = self.sub(x, y)
        inv = self.add_virtual_target()
        self.generators.append(
            GeneratorOp("eq_inv", inputs=(diff,), outputs=(inv,))
        )
        prod = self.mul(diff, inv)
        eq = self.sub(self.one(), prod)
        # soundness: eq * diff == 0
        z = self.mul(eq, diff)
        self.connect(z, self.zero())
        return T.BoolTarget(eq)

    # ------------------------------------------------------------------
    # decomposition / range checks
    # ------------------------------------------------------------------

    def inverse(self, x: int) -> int:
        """Witnessed base-field inverse: constrain x * inv == 1 (x must be
        nonzero for a satisfiable witness)."""
        inv = self.add_virtual_target()
        self.generators.append(GeneratorOp("eq_inv", inputs=(x,), outputs=(inv,)))
        prod = self.mul(x, inv)
        self.connect(prod, self.one())
        return inv

    def div(self, x: int, y: int) -> int:
        return self.mul(x, self.inverse(y))

    def split_le(self, x: int, num_bits: int) -> list[T.BoolTarget]:
        # 64-bit decompositions (FRI query indices) share qp-plonky2's
        # documented ambiguity: felts < 2^32-1 have two 64-bit encodings
        # mod p; acceptable for query sampling.
        assert 1 <= num_bits <= 64
        gate = BaseSum2Gate(num_limbs=num_bits)
        row = self._add_row(gate)
        self.connect(x, T.wire(row, 0))
        bit_wires = tuple(T.wire(row, 1 + i) for i in range(num_bits))
        self.generators.append(
            GeneratorOp(
                "base_sum",
                row=row,
                data=(num_bits,),
                inputs=(T.wire(row, 0),),
                outputs=bit_wires,
            )
        )
        return [T.BoolTarget(w) for w in bit_wires]

    def range_check(self, x: int, num_bits: int):
        self.split_le(x, num_bits)

    # ------------------------------------------------------------------
    # hashing
    # ------------------------------------------------------------------

    def permute_poseidon(self, state: list[int]) -> list[int]:
        """Place one PoseidonGate row permuting 12 targets (swap = 0)."""
        assert len(state) == 12
        row = self._add_row(PoseidonGate())
        for i, t in enumerate(state):
            self.connect(t, T.wire(row, PoseidonGate.wire_input(i)))
        self.connect(self.zero(), T.wire(row, PoseidonGate.WIRE_SWAP))
        in_wires = tuple(T.wire(row, PoseidonGate.wire_input(i)) for i in range(12))
        out_wires = tuple(T.wire(row, PoseidonGate.wire_output(i)) for i in range(12))
        self.generators.append(
            GeneratorOp(
                "poseidon",
                row=row,
                inputs=in_wires + (T.wire(row, PoseidonGate.WIRE_SWAP),),
                outputs=out_wires,
            )
        )
        return list(out_wires)

    def hash_n_to_m_no_pad(self, inputs: list[int], num_outputs: int) -> list[int]:
        state = [self.zero()] * 12
        for i in range(0, len(inputs), 8):
            chunk = inputs[i : i + 8]
            state = list(chunk) + state[len(chunk) :]
            state = self.permute_poseidon(state)
        # All reference uses squeeze at most 4 outputs (one block).
        assert num_outputs <= 8
        return state[:num_outputs]

    def hash_n_to_hash_no_pad(self, inputs: list[int]) -> T.HashOutTarget:
        return T.HashOutTarget.from_list(self.hash_n_to_m_no_pad(inputs, 4))

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------

    def build(self, device="cuda"):
        from ..plonk.circuit_data import build_circuit_data

        assert not self._built
        self._built = True

        # Hash public inputs in-circuit and expose via the PublicInputGate.
        pi_hash = self.hash_n_to_hash_no_pad(list(self.public_inputs))
        pi_row = self._add_row(PublicInputGate())
        for i in range(4):
            self.connect(pi_hash.elements[i], T.wire(pi_row, i))

        # Pad to a power of two with noop rows.
        n = 1
        while n < len(self.gates):
            n *= 2
        n = max(n, 1 << (self.config.fri_config.cap_height + 1))
        while len(self.gates) < n:
            self._add_row(NoopGate())

        return build_circuit_data(self, device)
