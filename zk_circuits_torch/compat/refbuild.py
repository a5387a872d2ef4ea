"""Upstream-plonky2 CircuitBuilder layout emulator.

Rebuilds the reference wormhole circuit EXACTLY as qp-plonky2's builder
lays it out — row order, constant packing, selector assignment, sigma
cycles — so the resulting circuit artifacts can be diffed against
the reference's bench-data/{common,verifier}.bin and the proof's
FRI query openings (scripts/compat_points.npz gives all 84
constants/sigmas columns at 28 verified LDE points — the gradient this
emulator is iterated against).

This is NOT the production builder (iop/builder.py): the production
builder packs rows more efficiently (its wormhole circuit is degree 2^13
vs the reference's 2^14); this module's only job is byte parity with the
reference toolchain.

Sources of truth: the in-tree reference circuit code
(wormhole/circuit/src/*.rs, common/src/gadgets.rs) for
the op sequence, and upstream plonky2 semantics for the builder ops
(validated empirically — every uncertain detail is a VARIANTS flag).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..host import gl

P = gl.P_INT

# Upstream plonky2 Goldilocks constants (== qp-plonky2's; compat/NOTES.md r4)
GENERATOR = 14293326489335486720          # MULTIPLICATIVE_GROUP_GENERATOR
PO2_GENERATOR = 7277203076849721926       # g^((p-1)/2^32)


def root_of_unity(bits: int) -> int:
    return pow(PO2_GENERATOR, 1 << (32 - bits), P)


# Uncertain upstream details — flags the parity scripts can flip.
VARIANTS = dict(
    mul_addend="m0",          # mul(x,y): addend wire = m0 | zero
    select="mulsub2",         # 2x mul_sub (upstream) | sub_muladd | notb
    is_equal="inv_proto",     # see is_equal
    or_impl="add_sub_mul",    # a+b-ab | demorgan
    const_order="sorted",     # constant-gate packing: sorted | insertion
    sigma_dir="next",         # sigma: next-in-cycle | prev-in-cycle
    arith_dedup=True,         # upstream base_arithmetic_results cache
    arith_fold=True,          # upstream constant-folding special cases
    zk_blind=True,            # upstream blind(): Noop rows + z-pair copies
)


@dataclass
class GateInstance:
    kind: str                 # 'Arithmetic' | 'BaseSum' | 'Constant' | ...
    constants: list = field(default_factory=list)


class UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent
        r = x
        while p.get(r, r) != r:
            r = p[r]
        while p.get(x, x) != x:
            p[x], x = r, p[x]
        return r

    def union(self, a, b):
        self.parent.setdefault(a, a)
        self.parent.setdefault(b, b)
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


class RefBuilder:
    """Targets: ('w', row, col) wires, ('v', i) virtual."""

    NUM_WIRES = 135
    NUM_ROUTED = 80
    NUM_CONSTANTS = 2
    ARITH_OPS = 20
    BASE_SUM_LIMBS = 63

    def __init__(self, zero_knowledge: bool = True):
        self.zero_knowledge = zero_knowledge
        self.rows: list[GateInstance] = []
        self.n_virtual = 0
        self.copy_constraints: list = []
        self.public_inputs: list = []
        self.constants_to_targets: dict[int, tuple] = {}
        self.targets_to_constants: dict[tuple, int] = {}
        self._const_insertion: list[int] = []
        self.current_slots: dict = {}   # (kind, params) -> (row, next_slot)
        self.base_arithmetic_results: dict = {}

    # -- targets ----------------------------------------------------------
    def add_virtual_target(self):
        t = ("v", self.n_virtual)
        self.n_virtual += 1
        return t

    def add_virtual_targets(self, n):
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self):
        return self.add_virtual_targets(4)

    def add_virtual_hash_public_input(self):
        h = self.add_virtual_hash()
        for t in h:
            self.register_public_input(t)
        return h

    def add_virtual_public_input(self):
        t = self.add_virtual_target()
        self.register_public_input(t)
        return t

    def register_public_input(self, t):
        self.public_inputs.append(t)

    def connect(self, a, b):
        self.copy_constraints.append((a, b))

    def connect_hashes(self, a, b):
        for x, y in zip(a, b):
            self.connect(x, y)

    # -- gates ------------------------------------------------------------
    def add_gate(self, kind: str, constants: list) -> int:
        row = len(self.rows)
        self.rows.append(GateInstance(kind, list(constants)))
        return row

    def find_slot(self, kind: str, params: tuple, num_ops: int,
                  constants: list) -> tuple[int, int]:
        key = (kind, params)
        slot = self.current_slots.get(key)
        if slot is None:
            row = self.add_gate(kind, constants)
            slot = (row, 0)
        row, i = slot
        if i + 1 >= num_ops:
            self.current_slots.pop(key, None)
        else:
            self.current_slots[key] = (row, i + 1)
        return row, i

    # -- constants --------------------------------------------------------
    def constant(self, c: int):
        c %= P
        if c in self.constants_to_targets:
            return self.constants_to_targets[c]
        t = self.add_virtual_target()
        self.constants_to_targets[c] = t
        self.targets_to_constants[t] = c
        self._const_insertion.append(c)
        return t

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)

    def two(self):
        return self.constant(2)

    def _false(self):
        return self.zero()

    def _true(self):
        return self.one()

    def constant_bool(self, b: bool):
        return self._true() if b else self._false()

    def target_as_constant(self, t):
        return self.targets_to_constants.get(t)

    # -- arithmetic -------------------------------------------------------
    def arithmetic(self, c0: int, c1: int, m0, m1, addend):
        c0 %= P
        c1 %= P
        special = (self._arithmetic_special_cases(c0, c1, m0, m1, addend)
                   if VARIANTS["arith_fold"] else None)
        if special is not None:
            return special
        op = (c0, c1, m0, m1, addend)
        if VARIANTS["arith_dedup"] and op in self.base_arithmetic_results:
            return self.base_arithmetic_results[op]
        row, i = self.find_slot("Arithmetic", (c0, c1), self.ARITH_OPS, [c0, c1])
        w = [("w", row, 4 * i + j) for j in range(4)]
        self.connect(m0, w[0])
        self.connect(m1, w[1])
        self.connect(addend, w[2])
        self.base_arithmetic_results[op] = w[3]
        return w[3]

    def _arithmetic_special_cases(self, c0, c1, m0, m1, addend):
        zero = self.zero()
        m0c = self.target_as_constant(m0)
        m1c = self.target_as_constant(m1)
        adc = self.target_as_constant(addend)
        first_zero = c0 == 0 or m0 == zero or m1 == zero
        second_zero = c1 == 0 or addend == zero
        first_const = None
        if first_zero:
            first_const = 0
        elif m0c is not None and m1c is not None:
            first_const = c0 * m0c % P * m1c % P
        second_const = None
        if second_zero:
            second_const = 0
        elif adc is not None:
            second_const = c1 * adc % P
        if first_const is not None and second_const is not None:
            return self.constant((first_const + second_const) % P)
        if first_zero and c1 == 1:
            return addend
        if second_zero:
            if m0c is not None and c0 * m0c % P == 1:
                return m1
            if m1c is not None and c0 * m1c % P == 1:
                return m0
        return None

    def add(self, a, b):
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a, b):
        return self.arithmetic(1, P - 1, a, self.one(), b)

    def mul(self, a, b):
        addend = a if VARIANTS["mul_addend"] == "m0" else self.zero()
        return self.arithmetic(1, 0, a, b, addend)

    def mul_add(self, a, b, c):
        return self.arithmetic(1, 1, a, b, c)

    def mul_sub(self, a, b, c):
        return self.arithmetic(1, P - 1, a, b, c)

    def mul_const(self, c, x):
        return self.mul_const_add(c, x, self.zero())

    def mul_const_add(self, c, x, addend):
        return self.arithmetic(c, 1, x, self.one(), addend)

    def not_(self, b):
        return self.sub(self.one(), b)

    def and_(self, a, b):
        return self.mul(a, b)

    def or_(self, a, b):
        if VARIANTS["or_impl"] == "add_sub_mul":
            a_plus_b = self.add(a, b)
            ab = self.mul(a, b)
            return self.sub(a_plus_b, ab)
        # De Morgan: not(and(not a, not b))
        return self.not_(self.and_(self.not_(a), self.not_(b)))

    def select(self, b, x, y):
        v = VARIANTS["select"]
        if v == "mulsub2":
            # upstream: b(x-y)+y as two mul_sub ops
            tmp = self.mul_sub(b, y, y)          # b*y - y
            return self.mul_sub(b, x, tmp)       # b*x - (b*y - y)
        if v == "sub_muladd":
            tmp = self.sub(x, y)
            return self.mul_add(b, tmp, y)
        nb = self.not_(b)
        bx = self.mul(b, x)
        return self.mul_add(nb, y, bx)

    def assert_bool(self, b):
        z = self.mul_sub(b, b, b)
        self.connect(z, self.zero())

    def add_virtual_bool_target_safe(self):
        t = self.add_virtual_target()
        self.assert_bool(t)
        return t

    def is_equal(self, x, y):
        v = VARIANTS["is_equal"]
        zero = self.zero()
        if v == "inv_proto":
            inv = self.add_virtual_target()   # 1/(x-y) or 0 (generator)
            diff = self.sub(x, y)
            prod = self.mul(diff, inv)
            not_equal = prod
            equal = self.not_(not_equal)
            prod2 = self.mul(diff, equal)
            self.connect(prod2, zero)
            return equal
        if v == "safe_bool":
            # equal is a constrained virtual bool; not_equal = diff*inv
            equal = self.add_virtual_bool_target_safe()
            not_equal = self.not_(equal)
            inv = self.add_virtual_target()
            diff = self.sub(x, y)
            prod = self.mul(diff, inv)
            self.connect(prod, not_equal)
            prod2 = self.mul(diff, equal)
            self.connect(prod2, zero)
            return equal
        raise ValueError(v)

    # -- split / range ----------------------------------------------------
    def split_le(self, integer, num_bits: int):
        if num_bits == 0:
            return []
        assert num_bits <= self.BASE_SUM_LIMBS
        row = self.add_gate("BaseSum", [])
        bits = [("w", row, 1 + i) for i in range(self.BASE_SUM_LIMBS)]
        self.connect(integer, ("w", row, 0))
        zero = self.zero()
        for b in bits[num_bits:]:
            self.connect(b, zero)
        return bits[:num_bits]

    def range_check(self, x, n_log: int):
        self.split_le(x, n_log)

    # -- hashing ----------------------------------------------------------
    def permute(self, state12: list, swap=None):
        row = self.add_gate("Poseidon", [])
        if swap is None:
            swap = self._false()
        self.connect(swap, ("w", row, 24))
        for i in range(12):
            self.connect(state12[i], ("w", row, i))
        return [("w", row, 12 + i) for i in range(12)]

    def hash_n_to_hash_no_pad(self, inputs: list) -> list:
        zero = self.zero()
        state = [zero] * 12
        for start in range(0, len(inputs), 8):
            chunk = inputs[start:start + 8]
            state = list(state)
            state[: len(chunk)] = chunk
            state = self.permute(state)
        return state[:4]

    # -- build ------------------------------------------------------------
    def build(self):
        # 1. public-input hash (in-circuit) + PublicInput gate
        pi_hash = self.hash_n_to_hash_no_pad(list(self.public_inputs))
        pi_row = self.add_gate("PublicInput", [])
        for i in range(4):
            self.connect(pi_hash[i], ("w", pi_row, i))

        # 2. place constants into ConstantGate rows (2 per row)
        consts = list(self.constants_to_targets.items())
        if VARIANTS["const_order"] == "sorted":
            consts.sort(key=lambda kv: kv[0])
        else:
            consts = [(c, self.constants_to_targets[c])
                      for c in self._const_insertion]
        for c, t in consts:
            row, i = self.find_slot("Constant", (), self.NUM_CONSTANTS, [0, 0])
            self.rows[row].constants[i] = c
            self.connect(t, ("w", row, i))

        # 3. blind (upstream plonky2 blind(): with zero_knowledge,
        #    num_queries+2 Noop rows whose wires get random values, plus
        #    num_queries+3 PAIRS of Noop rows with all routed wires
        #    copy-constrained between the pair — the pairs CHANGE the sigma
        #    polynomials, not just the row count) and pad to a power of two
        if self.zero_knowledge and VARIANTS["zk_blind"]:
            num_queries = 28
            for _ in range(num_queries + 2):
                self.add_gate("Noop", [])
            for _ in range(num_queries + 3):
                g1 = self.add_gate("Noop", [])
                g2 = self.add_gate("Noop", [])
                for w in range(self.NUM_ROUTED):
                    self.connect(("w", g1, w), ("w", g2, w))
        n = len(self.rows)
        degree = 1 << (n - 1).bit_length()
        while len(self.rows) < degree:
            self.add_gate("Noop", [])
        return RefCircuitLayout(self)


GATE_DEGREES = {"Noop": 0, "Constant": 1, "PublicInput": 1, "BaseSum": 2,
                "Arithmetic": 3, "Poseidon": 7}
# stable sort by degree over the alphabetical (BTreeSet) gate-id order —
# reproduces the groups in common.bin: [Noop, Constant, PI, BaseSum,
# Arithmetic | Poseidon]
GATE_ORDER = ["Noop", "Constant", "PublicInput", "BaseSum", "Arithmetic",
              "Poseidon"]
UNUSED_SELECTOR = (1 << 32) - 1


class RefCircuitLayout:
    """Selector / constant / sigma polynomials of an emulated build."""

    def __init__(self, b: RefBuilder):
        self.builder = b
        self.degree = len(b.rows)
        self.degree_bits = self.degree.bit_length() - 1
        kinds = sorted({g.kind for g in b.rows},
                       key=lambda k: GATE_ORDER.index(k))
        kinds.sort(key=lambda k: GATE_DEGREES[k])   # stable
        self.gate_list = kinds
        self.gate_index = {k: i for i, k in enumerate(kinds)}
        # greedy selector groups bounded by quotient degree 8
        groups = []
        start = 0
        for i, k in enumerate(kinds):
            size = i - start + 1
            # filter degree = (size - 1) + 1 (UNUSED); constraint degree max
            fdeg = size  # (size-1 others) + UNUSED
            if fdeg + max(GATE_DEGREES[kk] for kk in kinds[start:i + 1]) > 8:
                groups.append((start, i))
                start = i
        groups.append((start, len(kinds)))
        self.selector_groups = groups
        self.num_selectors = len(groups)

    def selector_polys(self) -> np.ndarray:
        out = np.full((self.num_selectors, self.degree), UNUSED_SELECTOR,
                      dtype=np.uint64)
        for r, g in enumerate(self.builder.rows):
            gi = self.gate_index[g.kind]
            for si, (s, e) in enumerate(self.selector_groups):
                if s <= gi < e:
                    out[si, r] = gi
        return out

    def constant_polys(self) -> np.ndarray:
        out = np.zeros((RefBuilder.NUM_CONSTANTS, self.degree), dtype=np.uint64)
        for r, g in enumerate(self.builder.rows):
            for i, c in enumerate(g.constants[:RefBuilder.NUM_CONSTANTS]):
                out[i, r] = c
        return out

    def sigma_polys(self) -> np.ndarray:
        """80 sigma columns over the subgroup (upstream enumeration).

        Each copy class's routed wires, in row-major order (the order the
        upstream enumeration meets them), form a cycle: a wire's sigma is
        the next one's identity value (the previous one's with
        ``sigma_dir="prev"``).  The classes come from the copy constraints
        as connected components of wire and virtual-target ids, found with
        numpy (min-label propagation and pointer jumping); every id met in
        no constraint is a class of its own and keeps its identity sigma.
        The same polys as the JAX package's dict union-find over targets."""
        b = self.builder
        n = self.degree
        width, routed = RefBuilder.NUM_WIRES, RefBuilder.NUM_ROUTED

        def tid(t):
            return t[1] * width + t[2] if t[0] == "w" else n * width + t[1]

        edges = np.array([(tid(a), tid(c)) for a, c in b.copy_constraints],
                         dtype=np.int64).reshape(-1, 2)
        labels = np.arange(n * width + b.n_virtual, dtype=np.int64)
        while True:
            low = np.minimum(labels[edges[:, 0]], labels[edges[:, 1]])
            before = labels.copy()
            np.minimum.at(labels, edges[:, 0], low)
            np.minimum.at(labels, edges[:, 1], low)
            labels = labels[labels]
            if np.array_equal(labels, before):
                break

        g_sub = root_of_unity(self.degree_bits)
        pow_g = gl.powers(g_sub, n)
        k_is = gl.powers(GENERATOR, routed)
        sig = gl.mul(k_is[:, None], pow_g[None, :])     # identity sigma

        ids = np.unique(edges)
        ids = ids[(ids < n * width) & (ids % width < routed)]
        lab = labels[ids]
        order = np.lexsort((ids, lab))
        ids, lab = ids[order], lab[order]
        first = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
        size = np.diff(np.r_[first, ids.size])
        group = np.repeat(np.arange(first.size), size)
        pos = np.arange(ids.size) - first[group]
        step = 1 if VARIANTS["sigma_dir"] == "next" else -1
        other = ids[first[group] + (pos + step) % size[group]]
        keep = size[group] > 1
        ids, other = ids[keep], other[keep]
        sig[ids % width, ids // width] = gl.mul(k_is[other % width], pow_g[other // width])
        return sig
