"""Readers for the reference's binary artifact formats (qp-plonky2 1.1.x).

Layout reverse-engineered from the reference wormhole's bench-data/
{common.bin, verifier.bin, proof.bin} (the crate source is not vendored in
the reference tree; the decoded structure is validated by cryptographically
verifying proof.bin — see compat/verifier.py and tests/test_compat.py).

All integers are little-endian; `usize` is 8 bytes; bools are 1 byte;
field elements are canonical u64; hashes are 4 field elements.

CommonCircuitData layout (common.bin):
    CircuitConfig:
        num_wires, num_routed_wires, num_constants, security_bits,
        num_challenges, max_quotient_degree_factor  (usize each)
        use_base_arithmetic_gate, zero_knowledge    (bool each)
        FriConfig: rate_bits, cap_height, num_query_rounds (usize),
                   proof_of_work_bits (u32),
                   reduction_strategy (u8 tag: 0=Fixed(Vec<usize>),
                   1=ConstantArityBits(usize,usize), 2=MinSize(Option<usize>))
    FriParams: FriConfig (again), reduction_arity_bits (Vec<usize>),
               degree_bits (usize), hiding (bool)
    SelectorsInfo: selector_indices (Vec<usize>),
                   groups (Vec<(usize, usize)> ranges)
    quotient_degree_factor, num_gate_constraints, num_constants,
    num_public_inputs (usize each)
    k_is (Vec<u64>)
    num_partial_products, num_lookup_polys, num_lookup_selectors (usize)
    luts (Vec, empty here)
    gates (Vec: u32 tag + per-gate fields), tags per DefaultGateSerializer:
        0=Arithmetic{num_ops}, 2=BaseSum2{num_limbs}, 3=Constant{num_consts},
        9=Noop, 11=Poseidon, 12=PublicInput, 13=RandomAccess{bits,copies,ecs},
        ... (only the tags used by the reference circuits are implemented)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int = 8) -> int:
        v = int.from_bytes(self.data[self.pos : self.pos + n], "little")
        if len(self.data) < self.pos + n:
            raise ValueError("truncated input")
        self.pos += n
        return v

    def u32(self) -> int:
        return self.u(4)

    def boolean(self) -> bool:
        v = self.u(1)
        if v > 1:
            raise ValueError(f"bad bool byte {v} at {self.pos - 1}")
        return bool(v)

    def vec_usize(self, limit: int = 1 << 20) -> list[int]:
        n = self.u()
        if n > limit:
            raise ValueError(f"implausible vec length {n} at {self.pos - 8}")
        return [self.u() for _ in range(n)]

    def felts(self, n: int) -> np.ndarray:
        end = self.pos + 8 * n
        if end > len(self.data):
            raise ValueError("truncated field elements")
        out = np.frombuffer(self.data[self.pos : end], dtype="<u8").astype(np.uint64)
        self.pos = end
        return out

    def hashes(self, n: int) -> np.ndarray:
        return self.felts(4 * n).reshape(n, 4)

    def done(self) -> bool:
        return self.pos == len(self.data)


# ---------------------------------------------------------------------------
# Config / common data
# ---------------------------------------------------------------------------

@dataclass
class RefFriConfig:
    rate_bits: int
    cap_height: int
    num_query_rounds: int
    proof_of_work_bits: int
    reduction_strategy: tuple


@dataclass
class RefGate:
    kind: str
    params: dict = field(default_factory=dict)


GATE_TAGS = {
    0: "ArithmeticGate",
    1: "ArithmeticExtensionGate",
    2: "BaseSumGate",
    3: "ConstantGate",
    4: "CosetInterpolationGate",
    5: "ExponentiationGate",
    6: "LookupGate",
    7: "LookupTableGate",
    8: "MulExtensionGate",
    9: "NoopGate",
    10: "PoseidonMdsGate",
    11: "PoseidonGate",
    12: "PublicInputGate",
    13: "RandomAccessGate",
    14: "ReducingExtensionGate",
    15: "ReducingGate",
}


@dataclass
class RefCommonData:
    num_wires: int
    num_routed_wires: int
    config_num_constants: int
    security_bits: int
    num_challenges: int
    max_quotient_degree_factor: int
    use_base_arithmetic_gate: bool
    zero_knowledge: bool
    fri_config: RefFriConfig
    reduction_arity_bits: list[int]
    degree_bits: int
    hiding: bool
    selector_indices: list[int]
    selector_groups: list[tuple[int, int]]
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: np.ndarray
    num_partial_products: int
    num_lookup_polys: int
    num_lookup_selectors: int
    gates: list[RefGate]

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.fri_config.rate_bits

    @property
    def num_selectors(self) -> int:
        return len(self.selector_groups)

    @property
    def salt_size(self) -> int:
        return 4 if self.zero_knowledge else 0

    # oracle widths in leaf order (constants_sigmas, wires, zs_pp, quotient)
    @property
    def oracle_widths(self) -> list[int]:
        s = self.salt_size
        return [
            self.num_selectors + self.num_constants_only + self.num_routed_wires,
            self.num_wires + s,
            self.num_zs_partial_products + s,
            self.num_quotient_polys + s,
        ]

    @property
    def num_constants_only(self) -> int:
        # common.num_constants counts selectors + circuit constants
        return self.num_constants - self.num_selectors

    @property
    def num_zs_partial_products(self) -> int:
        return self.num_challenges * (1 + self.num_partial_products)

    @property
    def num_quotient_polys(self) -> int:
        return self.num_challenges * self.quotient_degree_factor


def _read_fri_config(r: Reader) -> RefFriConfig:
    rate = r.u()
    cap = r.u()
    rounds = r.u()
    pow_bits = r.u32()
    tag = r.u(1)
    if tag == 0:
        strategy = ("fixed", r.vec_usize(64))
    elif tag == 1:
        strategy = ("const_arity", r.u(), r.u())
    elif tag == 2:
        strategy = ("min_size", r.u() if r.boolean() else None)
    else:
        raise ValueError(f"bad reduction strategy tag {tag}")
    return RefFriConfig(rate, cap, rounds, pow_bits, strategy)


def _read_gate(r: Reader) -> RefGate:
    tag = r.u32()
    kind = GATE_TAGS.get(tag)
    if kind is None:
        raise ValueError(f"unknown gate tag {tag} at {r.pos - 4}")
    p: dict = {}
    if kind == "ArithmeticGate":
        p["num_ops"] = r.u()
    elif kind == "ArithmeticExtensionGate":
        p["num_ops"] = r.u()
    elif kind == "MulExtensionGate":
        p["num_ops"] = r.u()
    elif kind == "BaseSumGate":
        p["num_limbs"] = r.u()
        p["base"] = 2
    elif kind == "ConstantGate":
        p["num_consts"] = r.u()
    elif kind == "ExponentiationGate":
        p["num_power_bits"] = r.u()
    elif kind == "RandomAccessGate":
        p["bits"] = r.u()
        p["num_copies"] = r.u()
        p["num_extra_constants"] = r.u()
    elif kind == "ReducingGate":
        p["num_coeffs"] = r.u()
    elif kind == "ReducingExtensionGate":
        p["num_coeffs"] = r.u()
    elif kind == "CosetInterpolationGate":
        p["subgroup_bits"] = r.u()
        p["degree"] = r.u()
        p["barycentric_weights"] = [r.u() for _ in range(r.u())]
    elif kind in ("NoopGate", "PoseidonGate", "PoseidonMdsGate", "PublicInputGate"):
        pass
    else:
        raise ValueError(f"gate {kind} deserialization not implemented")
    return RefGate(kind, p)


def read_common_data(data: bytes) -> RefCommonData:
    r = Reader(data)
    num_wires = r.u()
    num_routed = r.u()
    cfg_num_consts = r.u()
    security = r.u()
    num_chal = r.u()
    max_q = r.u()
    use_base = r.boolean()
    zk = r.boolean()
    fri_cfg = _read_fri_config(r)
    fri_cfg2 = _read_fri_config(r)
    if fri_cfg2 != fri_cfg:
        raise ValueError("fri_params.config != config.fri_config")
    arities = r.vec_usize(64)
    degree_bits = r.u()
    hiding = r.boolean()
    sel_indices = r.vec_usize()
    n_groups = r.u()
    groups = [(r.u(), r.u()) for _ in range(n_groups)]
    quotient_degree_factor = r.u()
    num_gate_constraints = r.u()
    num_constants = r.u()
    num_public_inputs = r.u()
    n_kis = r.u()
    k_is = r.felts(n_kis)
    num_partial_products = r.u()
    num_lookup_polys = r.u()
    num_lookup_selectors = r.u()
    n_luts = r.u()
    if n_luts:
        raise ValueError("lookup tables not supported")
    n_gates = r.u()
    gates = [_read_gate(r) for _ in range(n_gates)]
    if not r.done():
        raise ValueError(f"{len(data) - r.pos} trailing bytes in common data")
    if len(sel_indices) != n_gates:
        raise ValueError("selector_indices length != num gates")
    return RefCommonData(
        num_wires, num_routed, cfg_num_consts, security, num_chal, max_q,
        use_base, zk, fri_cfg, arities, degree_bits, hiding,
        sel_indices, groups, quotient_degree_factor, num_gate_constraints,
        num_constants, num_public_inputs, k_is, num_partial_products,
        num_lookup_polys, num_lookup_selectors, gates,
    )


# ---------------------------------------------------------------------------
# Verifier data
# ---------------------------------------------------------------------------

@dataclass
class RefVerifierData:
    constants_sigmas_cap: np.ndarray  # (2^cap_height, 4)
    circuit_digest: np.ndarray        # (4,)
    common: RefCommonData | None = None


def read_verifier_data(data: bytes) -> RefVerifierData:
    """verifier.bin = VerifierCircuitData: verifier_only ‖ common.

    VerifierOnlyCircuitData layout: cap_height (usize), MerkleCap
    (2^cap_height hashes), circuit_digest (1 hash)."""
    r = Reader(data)
    cap_height = r.u()
    if cap_height > 16:
        raise ValueError(f"implausible cap height {cap_height}")
    cap = r.hashes(1 << cap_height)
    digest = r.felts(4)
    common = read_common_data(data[r.pos :]) if not r.done() else None
    return RefVerifierData(cap, digest, common)


# ---------------------------------------------------------------------------
# Proof
# ---------------------------------------------------------------------------

@dataclass
class RefOpenings:
    constants: np.ndarray          # (num_constants, 2) extension elements
    plonk_sigmas: np.ndarray       # (num_routed_wires, 2)
    wires: np.ndarray              # (num_wires, 2)
    plonk_zs: np.ndarray           # (num_challenges, 2)
    plonk_zs_next: np.ndarray      # (num_challenges, 2)
    partial_products: np.ndarray   # (num_challenges * num_partial_products, 2)
    quotient_polys: np.ndarray     # (num_quotient_polys, 2)
    lookup_zs: np.ndarray
    lookup_zs_next: np.ndarray

    def fri_batch0(self) -> np.ndarray:
        """Openings at zeta in FRI reduction order (plonky2 FriInstanceInfo
        batch 0: constants ‖ sigmas ‖ wires ‖ zs ‖ partial_products ‖
        quotient ‖ lookup_zs)."""
        return np.concatenate([
            self.constants, self.plonk_sigmas, self.wires, self.plonk_zs,
            self.partial_products, self.quotient_polys, self.lookup_zs,
        ])

    def fri_batch1(self) -> np.ndarray:
        """Openings at g*zeta (batch 1: zs_next ‖ lookup_zs_next)."""
        return np.concatenate([self.plonk_zs_next, self.lookup_zs_next])


@dataclass
class RefMerkleProof:
    siblings: np.ndarray  # (k, 4)


@dataclass
class RefInitialTreeProof:
    evals: list[np.ndarray]          # per oracle: (width,) base felts
    proofs: list[RefMerkleProof]


@dataclass
class RefQueryStep:
    evals: np.ndarray                # (arity, 2) extension elements
    proof: RefMerkleProof


@dataclass
class RefQueryRound:
    initial: RefInitialTreeProof
    steps: list[RefQueryStep]


@dataclass
class RefFriProof:
    commit_phase_caps: list[np.ndarray]   # each (2^cap_height, 4)
    query_rounds: list[RefQueryRound]
    final_poly: np.ndarray                # (final_len, 2)
    pow_witness: int


@dataclass
class RefProof:
    wires_cap: np.ndarray
    plonk_zs_partial_products_cap: np.ndarray
    quotient_polys_cap: np.ndarray
    openings: RefOpenings
    opening_proof: RefFriProof
    public_inputs: np.ndarray


def _read_ext_vec(r: Reader, n: int) -> np.ndarray:
    return r.felts(2 * n).reshape(n, 2)


def _read_merkle_proof(r: Reader) -> RefMerkleProof:
    n = r.u(1)
    if n > 64:
        raise ValueError(f"implausible merkle path length {n}")
    return RefMerkleProof(r.hashes(n))


def read_proof(data: bytes, common: RefCommonData) -> RefProof:
    r = Reader(data)
    cap_len = 1 << common.fri_config.cap_height
    wires_cap = r.hashes(cap_len)
    zs_pp_cap = r.hashes(cap_len)
    quot_cap = r.hashes(cap_len)

    nc = common.num_challenges
    openings = RefOpenings(
        constants=_read_ext_vec(r, common.num_constants),
        plonk_sigmas=_read_ext_vec(r, common.num_routed_wires),
        wires=_read_ext_vec(r, common.num_wires),
        plonk_zs=_read_ext_vec(r, nc),
        plonk_zs_next=_read_ext_vec(r, nc),
        partial_products=_read_ext_vec(r, nc * common.num_partial_products),
        quotient_polys=_read_ext_vec(r, common.num_quotient_polys),
        lookup_zs=_read_ext_vec(r, common.num_lookup_polys),
        lookup_zs_next=_read_ext_vec(r, common.num_lookup_polys),
    )

    n_commit_caps = len(common.reduction_arity_bits)
    commit_caps = [r.hashes(cap_len) for _ in range(n_commit_caps)]

    query_rounds = []
    widths = common.oracle_widths
    for _q in range(common.fri_config.num_query_rounds):
        evals, proofs = [], []
        for w in widths:
            evals.append(r.felts(w))
            proofs.append(_read_merkle_proof(r))
        steps = []
        for arity_bits in common.reduction_arity_bits:
            ev = _read_ext_vec(r, 1 << arity_bits)
            steps.append(RefQueryStep(ev, _read_merkle_proof(r)))
        query_rounds.append(RefQueryRound(RefInitialTreeProof(evals, proofs), steps))

    final_len = 1 << (common.degree_bits - sum(common.reduction_arity_bits))
    final_poly = _read_ext_vec(r, final_len)
    pow_witness = r.u()

    n_pis = r.u()
    if n_pis != common.num_public_inputs:
        raise ValueError(f"public input count {n_pis} != {common.num_public_inputs}")
    public_inputs = r.felts(n_pis)
    if not r.done():
        raise ValueError(f"{len(data) - r.pos} trailing bytes in proof")
    return RefProof(
        wires_cap, zs_pp_cap, quot_cap, openings,
        RefFriProof(commit_caps, query_rounds, final_poly, pow_witness),
        public_inputs,
    )
