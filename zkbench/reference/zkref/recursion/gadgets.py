"""In-circuit gadgets for the recursive verifier: quadratic-extension
arithmetic, the Fiat–Shamir challenger, and Merkle-path verification.

These are the building blocks of the verifier-as-circuit used by the
aggregator (the reference delegates to qp-plonky2's recursion module,
used at wormhole/aggregator/src/circuits/tree.rs:111-136).  Host builder
code: a copy of the JAX package's recursion/gadgets.py over the port's
builder, without change.
Extension semantics match the host model ``host/gle.py`` (GF(p^2) =
GF(p)[x]/(x^2 - 7)); challenger semantics match ``hash/challenger.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hash.constants import RATE, WIDTH
from ..iop.builder import CircuitBuilder, GeneratorOp
from ..iop.targets import BoolTarget, HashOutTarget

W = 7  # extension generator: x^2 = 7


@dataclass(frozen=True)
class ExtTarget:
    """A GF(p^2) element as two base-field targets."""

    c0: int
    c1: int


def ext_zero(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.zero(), b.zero())


def ext_one(b: CircuitBuilder) -> ExtTarget:
    return ExtTarget(b.one(), b.zero())


def ext_const(b: CircuitBuilder, c0: int, c1: int = 0) -> ExtTarget:
    return ExtTarget(b.constant(c0), b.constant(c1))


def ext_from_base(b: CircuitBuilder, t: int) -> ExtTarget:
    return ExtTarget(t, b.zero())


def _ext_one_t(b: CircuitBuilder) -> tuple[int, int]:
    return (b.one(), b.zero())


def _ext_zero_t(b: CircuitBuilder) -> tuple[int, int]:
    z = b.zero()
    return (z, z)


def _ae(b: CircuitBuilder, c0: int, c1: int, m0: ExtTarget,
        m1: tuple[int, int] | ExtTarget, addend: tuple[int, int] | ExtTarget
        ) -> ExtTarget:
    """One ArithmeticExtensionGate op: c0*(m0 ⊗ m1) + c1*addend."""
    m1t = (m1.c0, m1.c1) if isinstance(m1, ExtTarget) else m1
    adt = (addend.c0, addend.c1) if isinstance(addend, ExtTarget) else addend
    o0, o1 = b.arithmetic_extension(c0, c1, (m0.c0, m0.c1), m1t, adt)
    return ExtTarget(o0, o1)


def ext_add(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return _ae(b, 1, 1, x, _ext_one_t(b), y)


def ext_sub(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    from ..host import gl as _gl

    return _ae(b, 1, _gl.P_INT - 1, x, _ext_one_t(b), y)


def ext_neg(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    from ..host import gl as _gl

    return _ae(b, _gl.P_INT - 1, 0, x, _ext_one_t(b), _ext_zero_t(b))


def ext_mul(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    """(x0 + x1 φ)(y0 + y1 φ) = (x0y0 + 7 x1y1) + (x0y1 + x1y0) φ."""
    return _ae(b, 1, 0, x, y, _ext_zero_t(b))


def ext_mul_add(b: CircuitBuilder, x: ExtTarget, y: ExtTarget,
                z: ExtTarget) -> ExtTarget:
    """x ⊗ y + z in a single gate op."""
    return _ae(b, 1, 1, x, y, z)


def ext_mul_base(b: CircuitBuilder, x: ExtTarget, s: int) -> ExtTarget:
    """Multiply by a base-field *target* s."""
    return _ae(b, 1, 0, x, (s, b.zero()), _ext_zero_t(b))


def ext_mul_const(b: CircuitBuilder, x: ExtTarget, c: int) -> ExtTarget:
    return _ae(b, c, 0, x, _ext_one_t(b), _ext_zero_t(b))


def ext_mul_const_add(b: CircuitBuilder, x: ExtTarget, c: int,
                      z: ExtTarget) -> ExtTarget:
    """c * x + z in a single gate op."""
    return _ae(b, c, 1, x, _ext_one_t(b), z)


def ext_square(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    return ext_mul(b, x, x)


def ext_exp_power_of_2(b: CircuitBuilder, x: ExtTarget, k: int) -> ExtTarget:
    for _ in range(k):
        x = ext_square(b, x)
    return x


def ext_exp_u64(b: CircuitBuilder, x: ExtTarget, e: int) -> ExtTarget:
    result = ext_one(b)
    base = x
    while e > 0:
        if e & 1:
            result = ext_mul(b, result, base)
        if e > 1:
            base = ext_square(b, base)
        e >>= 1
    return result


def ext_mul_base_add(b: CircuitBuilder, x: ExtTarget, s: int,
                     z: ExtTarget) -> ExtTarget:
    """x * s + z (s a base-field target) in a single gate op."""
    return _ae(b, 1, 1, x, (s, b.zero()), z)


def ext_select(b: CircuitBuilder, cond: BoolTarget, x: ExtTarget,
               y: ExtTarget) -> ExtTarget:
    # y + cond * (x - y): two gate ops.
    d = ext_sub(b, x, y)
    return ext_mul_base_add(b, d, cond.target, y)


def ext_connect(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> None:
    b.connect(x.c0, y.c0)
    b.connect(x.c1, y.c1)


def ext_inverse(b: CircuitBuilder, x: ExtTarget) -> ExtTarget:
    """Witnessed inverse: constrain x * inv == 1 (sound; x must be != 0)."""
    inv = ExtTarget(b.add_virtual_target(), b.add_virtual_target())
    b.generators.append(
        GeneratorOp("ext_inv", inputs=(x.c0, x.c1), outputs=(inv.c0, inv.c1))
    )
    prod = ext_mul(b, x, inv)
    ext_connect(b, prod, ext_one(b))
    return inv


def ext_div(b: CircuitBuilder, x: ExtTarget, y: ExtTarget) -> ExtTarget:
    return ext_mul(b, x, ext_inverse(b, y))


def reduce_with_powers(b: CircuitBuilder, terms: list[ExtTarget],
                       alpha: ExtTarget) -> ExtTarget:
    """Σ_i alpha^i terms[i] via Horner from the top (one gate op/term)."""
    acc = ext_zero(b)
    for t in reversed(terms):
        acc = ext_mul_add(b, acc, alpha, t)
    return acc


def bits_to_index(b: CircuitBuilder, bits: list[BoolTarget]) -> int:
    """Σ_j 2^j bits[j] as a routed base target (for random_access)."""
    if not bits:
        return b.zero()
    acc = bits[0].target
    for j, bt in enumerate(bits[1:], start=1):
        acc = b.arithmetic(1 << j, 1, bt.target, b.one(), acc)
    return acc


def random_access_hashes(b: CircuitBuilder, index: int,
                         entries: list[HashOutTarget]) -> HashOutTarget:
    """entries[index] via 4 RandomAccessGate copies sharing the index."""
    return HashOutTarget.from_list([
        b.random_access(index, [e.elements[k] for e in entries])
        for k in range(4)
    ])


def random_access_ext(b: CircuitBuilder, index: int,
                      entries: list) -> "ExtTarget":
    """entries[index] for ExtTarget entries (2 copies sharing the index)."""
    return ExtTarget(
        b.random_access(index, [e.c0 for e in entries]),
        b.random_access(index, [e.c1 for e in entries]),
    )


# ---------------------------------------------------------------------------
# In-circuit Fiat–Shamir challenger (mirrors hash/challenger.py)
# ---------------------------------------------------------------------------


class RecursiveChallenger:
    """Duplex Poseidon sponge over targets.  The observe/squeeze sequence is
    static for a fixed CommonCircuitData, so the gate structure is fixed."""

    def __init__(self, builder: CircuitBuilder):
        self.b = builder
        zero = builder.zero()
        self.state: list[int] = [zero] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def observe_element(self, t: int):
        self.output_buffer.clear()
        self.input_buffer.append(t)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_elements(self, ts):
        for t in ts:
            self.observe_element(t)

    def observe_hash(self, h: HashOutTarget):
        self.observe_elements(h.elements)

    def observe_cap(self, cap: list[HashOutTarget]):
        for d in cap:
            self.observe_hash(d)

    def observe_extension_element(self, e: ExtTarget):
        self.observe_element(e.c0)
        self.observe_element(e.c1)

    def observe_extension_elements(self, es):
        for e in es:
            self.observe_extension_element(e)

    def _duplex(self):
        for i, t in enumerate(self.input_buffer):
            self.state[i] = t
        self.input_buffer.clear()
        self.state = self.b.permute_poseidon(self.state)
        self.output_buffer = list(self.state[:RATE])

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> ExtTarget:
        c = self.get_n_challenges(2)
        return ExtTarget(c[0], c[1])

    def get_hash(self) -> HashOutTarget:
        return HashOutTarget.from_list(self.get_n_challenges(4))


# ---------------------------------------------------------------------------
# In-circuit Merkle verification (hash/merkle.py semantics)
# ---------------------------------------------------------------------------


def hash_or_noop(b: CircuitBuilder, leaf: list[int]) -> HashOutTarget:
    if len(leaf) <= 4:
        zero = b.zero()
        padded = list(leaf) + [zero] * (4 - len(leaf))
        return HashOutTarget.from_list(padded)
    return b.hash_n_to_hash_no_pad(leaf)


def compress(b: CircuitBuilder, left: HashOutTarget,
             right: HashOutTarget) -> HashOutTarget:
    return b.hash_n_to_hash_no_pad(list(left.elements) + list(right.elements))


def verify_merkle_proof_with_cap_index(
    b: CircuitBuilder,
    leaf: list[int],
    index_bits: list[BoolTarget],
    cap: list[HashOutTarget],
    siblings: list[HashOutTarget],
) -> None:
    """Walk the path ordered by ``index_bits`` (LSB first, one per sibling),
    then connect to cap[index_bits[len(siblings):]] via select-mux."""
    current = hash_or_noop(b, leaf)
    for bit, sib in zip(index_bits, siblings):
        # bit == 1 -> current is the right child.
        left = HashOutTarget.from_list(
            [b.select(bit, sib.elements[k], current.elements[k]) for k in range(4)]
        )
        right = HashOutTarget.from_list(
            [b.select(bit, current.elements[k], sib.elements[k]) for k in range(4)]
        )
        current = compress(b, left, right)
    # Random-access the cap entry addressed by the remaining bits.
    cap_bits = index_bits[len(siblings):]
    assert len(cap) == 1 << len(cap_bits)
    if not cap_bits:
        cap_entry = cap[0]
    else:
        idx = bits_to_index(b, cap_bits)
        cap_entry = random_access_hashes(b, idx, cap)
    b.connect_hashes(current, cap_entry)
