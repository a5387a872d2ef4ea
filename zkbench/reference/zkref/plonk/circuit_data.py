"""Build output: preprocessed circuit data + compiled witness schedule.

The analog of the reference engine's CircuitData split
(CommonCircuitData / ProverOnlyCircuitData / VerifierOnlyCircuitData, cf.
wormhole/circuit/src/circuit.rs:12-30 artifact flow):

- selector polynomials with greedy degree-bounded gate grouping,
- constant polynomials,
- copy-constraint sigma polynomials over k_i-shifted cosets,
- the constants_sigmas commitment (Merkle cap), circuit digest,
- a *static level-ordered witness schedule*: every generator op is binned
  by (dependency level, kind) at build time so witness generation runs as
  a short sequence of vectorized numpy passes.
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..fri.oracle import PolynomialBatch
from ..host import gl, poseidon as hposeidon
from ..iop import targets as T
from ..iop.gates import Gate
from ..ntt import ntt as nttm
from .config import CircuitConfig

UNUSED_SELECTOR_SENTINEL = None  # resolved to num_gate_types at build


@dataclass
class SelectorGroup:
    gate_ids: list[str]          # gate ids in this group (global order indices)
    gate_indices: list[int]      # global indices of those gates


@dataclass
class CommonCircuitData:
    config: CircuitConfig
    degree_bits: int
    gate_types: list[Gate]                 # global ordered gate list
    selector_groups: list[list[int]]       # groups of global gate indices
    gate_to_group: dict[str, int]
    gate_to_index: dict[str, int]
    num_gate_constraints: int
    num_public_inputs: int
    k_is: np.ndarray                       # (num_routed,) coset shifts
    circuit_digest: np.ndarray = None

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    @property
    def num_selectors(self) -> int:
        return len(self.selector_groups)

    @property
    def quotient_degree_factor(self) -> int:
        return self.config.max_quotient_degree_factor

    @property
    def num_partial_products(self) -> int:
        r = self.config.num_routed_wires
        q = self.quotient_degree_factor
        return (r + q - 1) // q - 1

    @property
    def lde_size(self) -> int:
        return self.degree << self.config.rate_bits

    @property
    def num_constants_sigmas_polys(self) -> int:
        return self.num_selectors + self.config.num_constants + self.config.num_routed_wires

    @property
    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    @property
    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    @property
    def unused_selector(self) -> int:
        return len(self.gate_types)

    def fri_reduction_arities(self) -> list[int]:
        return self.config.fri_config.reduction_arities(self.degree_bits)


@dataclass
class ScheduleBatch:
    kind: str
    data: dict[str, Any]


@dataclass
class ProverOnlyCircuitData:
    constants_sigmas_commitment: PolynomialBatch
    sigmas_values: np.ndarray        # (num_routed, n) permutation images
    selectors_values: np.ndarray     # (num_selectors, n)
    constants_values: np.ndarray     # (num_constants, n)
    gates_by_row: list[Gate]
    rep_of_target: dict[int, int]    # target -> dense representative index
    num_reps: int
    wire_cell_reps: np.ndarray       # (num_cells, 3): row, col, rep
    schedule: list[ScheduleBatch]
    public_inputs: list[int]
    subgroup: np.ndarray             # (n,) powers of w
    # the schedule on each device (iop/witness_device.py), built at first use
    witness_tables: dict = field(default_factory=dict, repr=False, compare=False)
    # seed_batch's last (targets, reps sorted, the order that sorts them)
    seed_order: tuple | None = field(default=None, repr=False, compare=False)


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: np.ndarray
    circuit_digest: np.ndarray


@dataclass
class CircuitData:
    common: CommonCircuitData
    prover_only: ProverOnlyCircuitData
    verifier_only: VerifierOnlyCircuitData

    def prove(self, pw, check_witness: bool | None = None, device="cuda"):
        from .prover import prove

        return prove(self, pw, check_witness=check_witness, device=device)

    def verify(self, proof):
        from .verifier import verify

        return verify(self.common, self.verifier_only, proof)


def _selector_groups(gate_types: list[Gate], max_degree: int) -> list[list[int]]:
    """Greedy grouping: filter degree = |group| (incl. the unused-sentinel
    term when there are multiple groups); require filter + gate degree <=
    max_degree + 1."""
    order = sorted(
        range(len(gate_types)), key=lambda i: (-gate_types[i].degree, gate_types[i].id)
    )
    groups: list[list[int]] = []
    for gi in order:
        placed = False
        for g in groups:
            group_max_deg = max(gate_types[j].degree for j in g + [gi])
            if (len(g) + 1) + group_max_deg <= max_degree + 1:
                g.append(gi)
                placed = True
                break
        if not placed:
            groups.append([gi])
    return groups


def build_circuit_data(builder, device="cuda") -> CircuitData:
    from .. import resolve_device

    device = resolve_device(device)
    config: CircuitConfig = builder.config
    n = len(builder.gates)
    degree_bits = n.bit_length() - 1
    assert 1 << degree_bits == n

    # ---- gate bookkeeping -------------------------------------------------
    seen: dict[str, Gate] = {}
    for g in builder.gates:
        seen.setdefault(g.id, g)
    gate_types = sorted(seen.values(), key=lambda g: (-g.degree, g.id))
    gate_to_index = {g.id: i for i, g in enumerate(gate_types)}
    groups = _selector_groups(gate_types, config.max_quotient_degree_factor)
    gate_to_group = {}
    for grp_idx, grp in enumerate(groups):
        for gi in grp:
            gate_to_group[gate_types[gi].id] = grp_idx

    num_gate_constraints = max(g.num_constraints for g in gate_types)

    common = CommonCircuitData(
        config=config,
        degree_bits=degree_bits,
        gate_types=gate_types,
        selector_groups=groups,
        gate_to_group=gate_to_group,
        gate_to_index=gate_to_index,
        num_gate_constraints=num_gate_constraints,
        num_public_inputs=len(builder.public_inputs),
        k_is=gl.powers(gl.MULTIPLICATIVE_GROUP_GENERATOR, config.num_routed_wires),
    )

    # ---- selector & constant polynomials ----------------------------------
    unused = common.unused_selector
    selectors = np.full((len(groups), n), unused, dtype=np.uint64)
    for row, g in enumerate(builder.gates):
        grp = gate_to_group[g.id]
        selectors[grp, row] = gate_to_index[g.id]
    constants = np.zeros((config.num_constants, n), dtype=np.uint64)
    for row, cs in enumerate(builder.row_constants):
        for i, c in enumerate(cs):
            constants[i, row] = c

    # ---- copy constraints: representatives & sigmas -----------------------
    uf = builder.uf
    num_routed = config.num_routed_wires

    # Collect referenced routed wire cells (those participating in classes)
    # plus every class's members; assign dense rep indices.
    rep_of_target: dict[int, int] = {}
    rep_members: dict[int, list[int]] = defaultdict(list)
    for t in list(uf.parent.keys()):
        rep_members[uf.find(t)].append(t)
    # Singleton targets (never connected) still need reps: virtual targets
    # and wire cells referenced by generators.
    def _rep_index(t: int) -> int:
        r = uf.find(t)
        if r not in _rep_dense:
            _rep_dense[r] = len(_rep_dense)
        return _rep_dense[r]

    _rep_dense: dict[int, int] = {}
    for t in range(builder.num_virtual):
        _rep_index(T.virtual(t))
    for op in builder.generators:
        for t in op.inputs + op.outputs:
            _rep_index(t)
    # Wire cells in classes:
    wire_cells_by_class: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for t in list(uf.parent.keys()):
        if T.is_wire(t):
            row, col = T.wire_row_col(t)
            if col < num_routed:
                wire_cells_by_class[_rep_index(t)].append((row, col))

    for t, r in list(uf.parent.items()):
        rep_of_target[t] = _rep_index(t)
    for t in range(builder.num_virtual):
        rep_of_target[T.virtual(t)] = _rep_index(T.virtual(t))
    for op in builder.generators:
        for t in op.inputs + op.outputs:
            rep_of_target[t] = _rep_index(t)

    # sigma[col, row] = location (k_col' * w^row') of the next cell in cycle.
    w_powers = gl.powers(gl.primitive_root_of_unity(degree_bits), n)
    sigma = np.empty((num_routed, n), dtype=np.uint64)
    sigma[:] = gl.mul(common.k_is[:, None], w_powers[None, :])  # identity default
    for cells in wire_cells_by_class.values():
        if len(cells) < 2:
            continue
        for i, (row, col) in enumerate(cells):
            nrow, ncol = cells[(i + 1) % len(cells)]
            sigma[col, row] = gl.mul(common.k_is[ncol], w_powers[nrow])

    wire_cell_reps = []
    for rep, cells in wire_cells_by_class.items():
        for row, col in cells:
            wire_cell_reps.append((row, col, rep))
    wire_cell_reps = np.array(wire_cell_reps or np.zeros((0, 3)), dtype=np.int64)

    # ---- commitment to selectors + constants + sigmas ---------------------
    constants_sigmas_values = np.concatenate([selectors, constants, sigma], axis=0)
    commitment = PolynomialBatch.from_values(
        constants_sigmas_values,
        config.rate_bits,
        config.fri_config.cap_height,
        blinding=False,
        device=device,
    )

    digest_input = np.concatenate(
        [commitment.cap.reshape(-1), np.array([degree_bits], dtype=np.uint64)]
    )
    circuit_digest = hposeidon.hash_no_pad(digest_input)
    common.circuit_digest = circuit_digest

    # ---- static witness schedule ------------------------------------------
    schedule = _compile_schedule(builder, rep_of_target, len(_rep_dense))

    prover_only = ProverOnlyCircuitData(
        constants_sigmas_commitment=commitment,
        sigmas_values=sigma,
        selectors_values=selectors,
        constants_values=constants,
        gates_by_row=list(builder.gates),
        rep_of_target=rep_of_target,
        num_reps=len(_rep_dense),
        wire_cell_reps=wire_cell_reps,
        schedule=schedule,
        public_inputs=list(builder.public_inputs),
        subgroup=w_powers,
    )
    verifier_only = VerifierOnlyCircuitData(
        constants_sigmas_cap=commitment.cap.copy(),
        circuit_digest=circuit_digest,
    )
    return CircuitData(common, prover_only, verifier_only)


def _compile_schedule(builder, rep_of, num_reps: int) -> list[ScheduleBatch]:
    """Kahn-style leveling of generator ops over representative classes,
    then binning into (level, kind[, width]) vectorized batches."""
    ops = builder.generators
    produced_by: dict[int, list[int]] = defaultdict(list)
    for oi, op in enumerate(ops):
        for t in op.outputs:
            produced_by[rep_of[t]].append(oi)

    # Seeds: reps with no producers (user-set virtuals / untouched wires).
    rep_level = {}
    for r in range(num_reps):
        if r not in produced_by:
            rep_level[r] = 0

    op_level = [None] * len(ops)
    # BFS over readiness.
    remaining_inputs = []
    waiting: dict[int, list[int]] = defaultdict(list)  # rep -> ops waiting on it
    ready = deque()
    for oi, op in enumerate(ops):
        need = set()
        for t in op.inputs:
            r = rep_of[t]
            if r not in rep_level:
                need.add(r)
        remaining_inputs.append(need)
        if not need:
            ready.append(oi)
        else:
            for r in need:
                waiting[r].append(oi)

    resolved_levels = dict(rep_level)
    while ready:
        oi = ready.popleft()
        op = ops[oi]
        lvl = 0
        for t in op.inputs:
            lvl = max(lvl, resolved_levels[rep_of[t]])
        op_level[oi] = lvl + 1
        for t in op.outputs:
            r = rep_of[t]
            if r not in resolved_levels or resolved_levels[r] > lvl + 1:
                if r not in resolved_levels:
                    resolved_levels[r] = lvl + 1
                    for w in waiting.get(r, []):
                        remaining_inputs[w].discard(r)
                        if not remaining_inputs[w]:
                            ready.append(w)

    unscheduled = [i for i, l in enumerate(op_level) if l is None]
    if unscheduled:
        raise ValueError(
            f"{len(unscheduled)} witness generators cannot be scheduled "
            f"(cyclic or missing inputs), first: {ops[unscheduled[0]]}"
        )

    # Bin ops by (level, kind, width-key) and precompute index arrays.
    bins: dict[tuple, list[int]] = defaultdict(list)
    for oi, op in enumerate(ops):
        key_extra = op.data if op.kind in ("base_sum", "random_access") else ()
        bins[(op_level[oi], op.kind) + key_extra].append(oi)

    def _wire_outputs(batch_ops):
        """(rows, cols, flat_positions) of output targets that are wires, so
        witness values land in the wire matrix even when unconnected."""
        rows, cols, pos_list = [], [], []
        pos = 0
        for op in batch_ops:
            for t in op.outputs:
                if T.is_wire(t):
                    r, c = T.wire_row_col(t)
                    rows.append(r)
                    cols.append(c)
                    pos_list.append(pos)
                pos += 1
        return (
            np.array(rows, dtype=np.int64),
            np.array(cols, dtype=np.int64),
            np.array(pos_list, dtype=np.int64),
        )

    schedule = []
    for key in sorted(bins.keys(), key=lambda k: (k[0], str(k[1:]))):
        kind = key[1]
        idxs = bins[key]
        batch_ops = [ops[i] for i in idxs]
        data: dict[str, Any] = {"out_wires": _wire_outputs(batch_ops)}
        if kind == "arith":
            data["in_reps"] = np.array(
                [[rep_of[t] for t in op.inputs] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [rep_of[op.outputs[0]] for op in batch_ops], dtype=np.int64
            )
            data["c0"] = np.array([op.data[0] for op in batch_ops], dtype=np.uint64)
            data["c1"] = np.array([op.data[1] for op in batch_ops], dtype=np.uint64)
        elif kind == "base_sum":
            data["num_bits"] = batch_ops[0].data[0]
            data["in_reps"] = np.array(
                [rep_of[op.inputs[0]] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [[rep_of[t] for t in op.outputs] for op in batch_ops], dtype=np.int64
            )
        elif kind == "poseidon":
            data["rows"] = np.array([op.row for op in batch_ops], dtype=np.int64)
            data["in_reps"] = np.array(
                [[rep_of[t] for t in op.inputs] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [[rep_of[t] for t in op.outputs] for op in batch_ops], dtype=np.int64
            )
        elif kind == "const":
            data["rows"] = np.array([op.row for op in batch_ops], dtype=np.int64)
            data["out_reps"] = np.array(
                [[rep_of[t] for t in op.outputs] for op in batch_ops], dtype=np.int64
            )
        elif kind == "eq_inv":
            data["in_reps"] = np.array(
                [rep_of[op.inputs[0]] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [rep_of[op.outputs[0]] for op in batch_ops], dtype=np.int64
            )
        elif kind == "ext_inv":
            data["in_reps"] = np.array(
                [[rep_of[t] for t in op.inputs] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [[rep_of[t] for t in op.outputs] for op in batch_ops], dtype=np.int64
            )
        elif kind == "arith_ext":
            data["in_reps"] = np.array(
                [[rep_of[t] for t in op.inputs] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [[rep_of[t] for t in op.outputs] for op in batch_ops], dtype=np.int64
            )
            data["c0"] = np.array([op.data[0] for op in batch_ops], dtype=np.uint64)
            data["c1"] = np.array([op.data[1] for op in batch_ops], dtype=np.uint64)
        elif kind == "random_access":
            data["num_bits"] = batch_ops[0].data[0]
            data["in_reps"] = np.array(
                [[rep_of[t] for t in op.inputs] for op in batch_ops], dtype=np.int64
            )
            data["out_reps"] = np.array(
                [[rep_of[t] for t in op.outputs] for op in batch_ops], dtype=np.int64
            )
        else:
            raise ValueError(f"unknown generator kind {kind}")
        schedule.append(ScheduleBatch(kind, data))
    return schedule
