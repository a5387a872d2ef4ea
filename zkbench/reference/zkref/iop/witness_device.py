"""The witness on the device: the static schedule run over a table of
representative values that never leaves the card.

Torch counterpart of the JAX package's iop/witness_device.py.  The host
witness (iop/witness.py) runs the circuit's schedule in numpy and the
prover copies the whole wire matrix to the device; here the schedule's
index and constant arrays are uploaded once per circuit and device
(``device_table``), a proof sends only its seed values, and the wire
matrix is made on the device in the layout the wires stage reads, (B, W,
n) for B proofs.

On the card the schedule runs through the hand-written kernel K3
(csrc/witness.cu via iop/witness_cuda.py): one block a proof walks the
levels from the level records the table keeps beside its arrays, each
level of thousands of ops runs as a launch over the whole card between
the walk's runs, and one launch scatters the cells.
On the CPU it runs through ``witness_plain``, the eager torch counterpart
of the JAX package's ``_witness_body`` and ``_poseidon_trace_dev``, which
loops over the schedule batch by batch; the card check holds K3 to it.
The JAX module's scan segments (``_compile_segments``, ``_pack_*``) only
keep its XLA program small; eager torch has no program to keep small, so
they are not ported.

The host witness raises on conflicting assignments and unset values;
the JAX device program checks neither.  Here the seeds are checked on the
host (every rep an op reads and no op writes is seeded, two seeds of one
rep agree), and the writes that the host would hold to an earlier value
are checked on the device after the schedule: a rep's second and later
writes go to extra slots of the value table (``shadow``), compared with
the rep's value, and the seeded reps that an op also writes are compared
with their seeds.  ``witnesses_and_conflicts`` leaves the count on the
device for the prover's next fetch; ``generate_witnesses_device`` raises
``WitnessConflict`` itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import goldilocks as gfd
from ..iop.gates import PoseidonGate
from ..iop.witness import WitnessConflict

# Generator kinds of the schedule and their codes in csrc/witness.cuh.
KINDS = {"const": 0, "arith": 1, "arith_ext": 2, "eq_inv": 3, "ext_inv": 4,
         "base_sum": 5, "random_access": 6, "poseidon": 7}
# The host witness writes no wire outputs of these kinds at their batch
# (only the routed cells of their outputs, at the end).
_NO_WIRE_WRITES = {"eq_inv", "ext_inv"}
# The fields of a level's record in the table (csrc/witness.cuh, K3Level):
# the blob offsets of its input and output reps, constants and gate rows.
LEVEL_FIELDS = ("kind", "m", "nbits", "k_in", "k_out", "ins", "outs", "consts", "rows")


def supported(circuit_data) -> bool:
    """Whether every batch of the circuit's schedule is of a kind the
    device witness runs: every kind the port's builder emits."""
    return all(b.kind in KINDS for b in circuit_data.prover_only.schedule)


def _seed_order(po, pw) -> tuple[tuple, np.ndarray]:
    """The reps of the targets ``pw`` seeds, sorted, and the order that
    sorts its values so.  The order of the last target tuple seen is kept
    with the circuit, so a witness that seeds the same targets in the same
    order costs one comparison."""
    keys = tuple(pw.values)
    kept = po.seed_order     # read once: another thread may replace it
    if kept is None or kept[0] != keys:
        reps = []
        for t in keys:
            rep = po.rep_of_target.get(t)
            if rep is None:
                raise KeyError(f"target {t} is not part of the circuit")
            reps.append(rep)
        order = np.argsort(np.asarray(reps, np.int64), kind="stable")
        kept = po.seed_order = (keys, tuple(reps[i] for i in order), order)
    return kept[1], kept[2]


def seed_groups(circuit_data, pws) -> list[list[int]]:
    """The indices of ``pws`` grouped by the set of targets each seeds,
    the groups in the order of their first witness: each group is one
    ``seed_batch``."""
    groups: dict = {}
    for i, pw in enumerate(pws):
        groups.setdefault(_seed_order(circuit_data.prover_only, pw)[0], []).append(i)
    return list(groups.values())


def seed_batch(circuit_data, pws) -> tuple[tuple, np.ndarray]:
    """Check that every PartialWitness seeds the SAME target set (the
    wormhole/voting/recursion APIs always do: fill_targets assigns a fixed
    layout; ``seed_groups`` splits a batch that does not) and stack the
    seed values: returns (seed_reps sorted, (B, S) u64)."""
    po = circuit_data.prover_only
    seed_reps = None
    rows = []
    for pw in pws:
        reps, order = _seed_order(po, pw)
        if seed_reps is None:
            seed_reps = reps
        elif reps != seed_reps:
            raise ValueError("prove_batch witnesses seed different target sets")
        rows.append(np.fromiter(pw.values.values(), np.uint64, len(order))[order])
    return seed_reps, np.stack(rows)


@dataclass
class Step:
    """One schedule batch of m ops, as views into the table's tensor."""
    kind: str
    m: int
    nbits: int
    ins: torch.Tensor       # (m, k_in) input reps
    outs: torch.Tensor      # (m, k_out) output reps
    consts: torch.Tensor    # arith kinds: (2, m) c0, c1; const: (m, k_out)
    rows: torch.Tensor      # poseidon: (m,) the gates' rows
    wire_pos: torch.Tensor  # the batch's wire outputs: cell col * n + row,
    wire_src: torch.Tensor  # and its index in the flattened outputs


class WitnessTable:
    """A circuit's schedule on one device: every index and constant array
    in one int64 tensor, uploaded once.

    ``steps``: the schedule batches in order.  ``levels``: their
    records (L, LEVEL_FIELDS), at ``levels_off`` in the blob.
    ``cell_pos``/``cell_rep``: every cell of the wire matrix the witness
    sets from a rep, as col * n + row, for K3's final scatter: each
    batch's wire outputs (every rep is set once, so a batch's write equals
    the rep's final value) then the routed cells (``wire_cell_reps``), a
    cell written twice kept at its last write.  ``route_pos``/``route_rep``:
    the routed cells alone, for the plain version, which writes the wire
    outputs at their batch as the host does.  ``pi_reps``: the public
    inputs' reps.  ``shadow``/``shadow_rep``: the slots past the circuit's
    reps that take a rep's second and later writes in schedule order, and
    that rep; ``num_reps`` counts both."""

    def __init__(self, circuit_data, device):
        common, po = circuit_data.common, circuit_data.prover_only
        n = common.degree
        self.device = torch.device(device)
        self.n, self.num_wires = n, common.config.num_wires
        parts: list[np.ndarray] = []
        size = 0

        def put(a) -> tuple[int, tuple]:
            nonlocal size
            a = np.ascontiguousarray(a, dtype=np.int64)
            parts.append(a.ravel())
            size += a.size
            return size - a.size, a.shape

        layout, cells = [], []
        written = np.zeros(po.num_reps, bool)
        shadow_rep, reads, slots = [], [], po.num_reps
        for batch in po.schedule:
            kind, d = batch.kind, batch.data
            if kind not in KINDS:
                raise ValueError(f"the device witness has no kind {kind!r}")
            outs = np.asarray(d["out_reps"], np.int64)
            m = outs.shape[0]
            outs = outs.reshape(m, -1)
            ins = np.asarray(d.get("in_reps", np.zeros((m, 0))), np.int64).reshape(m, -1)
            reads.append(ins.ravel())
            flat = outs.ravel().copy()
            again = np.ones(flat.size, bool)
            again[np.unique(flat, return_index=True)[1]] = False
            again |= written[flat]
            written[flat] = True
            shadow_rep.append(flat[again])
            flat[again] = slots + np.arange(again.sum())
            slots += again.sum()
            outs = flat.reshape(m, -1)
            if kind in ("arith", "arith_ext"):
                consts = gfd.from_u64(np.stack([d["c0"], d["c1"]])).numpy()
            elif kind == "const":
                consts = gfd.from_u64(po.constants_values[:, d["rows"]].T[:, :outs.shape[1]]).numpy()
            else:
                consts = np.zeros((0,), np.int64)
            rows, cols, src = (np.asarray(a, np.int64) for a in d["out_wires"])
            if kind in _NO_WIRE_WRITES:
                rows = cols = src = np.zeros((0,), np.int64)
            pos = cols * n + rows
            cells.append((pos, outs.ravel()[src]))
            gate_rows = d["rows"] if kind == "poseidon" else np.zeros((0,), np.int64)
            layout.append((kind, m, int(d.get("num_bits", 0)), put(ins), put(outs),
                           put(consts), put(gate_rows), put(pos), put(src)))
        route = np.asarray(po.wire_cell_reps, np.int64).reshape(-1, 3)
        route_pos = route[:, 1] * n + route[:, 0]
        cells.append((route_pos, route[:, 2]))
        all_pos = np.concatenate([c[0] for c in cells])
        all_rep = np.concatenate([c[1] for c in cells])
        # the last write of each cell: first occurrence in the reversed order
        _, first = np.unique(all_pos[::-1], return_index=True)
        keep = np.sort(all_pos.size - 1 - first)
        pis = np.array([po.rep_of_target[t] for t in po.public_inputs], np.int64)
        self.num_reps = int(slots)
        tail = [put(all_pos[keep]), put(all_rep[keep]), put(route_pos), put(route[:, 2]),
                put(pis), put(np.arange(po.num_reps, slots)),
                put(np.concatenate(shadow_rep + [np.zeros(0, np.int64)]))]
        # for the seeds' check: the reps some op writes, and the reps an op
        # or a routed cell reads that no op writes
        self.written = written
        reads = np.concatenate(reads + [route[:, 2]])
        self.must_seed = np.unique(reads[~written[reads]])
        self._seeds_checked = None
        # one record a level (LEVEL_FIELDS), which K3's walk reads in place
        # of launch arguments
        records = [(KINDS[kind], m, nbits, ins[1][1], outs[1][1], ins[0], outs[0], consts[0],
                    rows[0]) for kind, m, nbits, ins, outs, consts, rows, _, _ in layout]
        self.levels_off, _ = put(np.asarray(records, np.int64).reshape(-1, len(LEVEL_FIELDS)))
        self.blob = torch.from_numpy(np.concatenate(parts)).to(self.device)

        def view(entry):
            off, shape = entry
            return self.blob[off : off + int(np.prod(shape))].view(shape)

        self.steps = [Step(kind, m, nbits, *(view(e) for e in entries))
                      for kind, m, nbits, *entries in layout]
        (self.cell_pos, self.cell_rep, self.route_pos, self.route_rep, self.pi_reps,
         self.shadow, self.shadow_rep) = (view(e) for e in tail)
        self.levels = view((self.levels_off, (len(layout), len(LEVEL_FIELDS))))
        self.launch_plans: dict = {}   # iop/witness_cuda.py's launches by level range

    def seeded_values(self, seed_reps, seeds: np.ndarray) -> torch.Tensor:
        """The (B, R) value table on the device: zeros but the B proofs'
        seeds (B, S) at ``seed_reps``, sent in one copy."""
        seeds = np.asarray(seeds, dtype=np.uint64)
        b, s = seeds.shape
        host = np.concatenate([np.asarray(seed_reps, np.int64).reshape(s),
                               seeds.view(np.int64).ravel()])
        sent = torch.from_numpy(host).to(self.device)
        values = torch.zeros((b, self.num_reps), dtype=torch.int64, device=self.device)
        values[:, sent[:s]] = sent[s:].view(b, s)
        return values

    def check_seeds(self, seed_reps, seeds: np.ndarray) -> torch.Tensor:
        """Raise as the host witness would on the seeds (B, S) at the
        sorted ``seed_reps``: a rep read and never written that no seed
        sets, two seeds of one rep that differ.  Returns the seeded reps
        that an op also writes, on the device, whose values the schedule
        must leave as seeded."""
        if self._seeds_checked is None or self._seeds_checked[0] is not seed_reps:
            reps = np.asarray(seed_reps, np.int64)
            missing = np.setdiff1d(self.must_seed, reps)
            if missing.size:
                raise ValueError(f"witness value not set for rep {int(missing[0])}")
            twice = np.flatnonzero(np.diff(reps) == 0)
            watch = torch.from_numpy(np.unique(reps[self.written[reps]])).to(self.device)
            self._seeds_checked = (seed_reps, twice, watch)
        _, twice, watch = self._seeds_checked
        if twice.size and (seeds[:, twice] != seeds[:, twice + 1]).any():
            raise WitnessConflict("Partition was set twice with different values "
                                  f"(rep {int(seed_reps[twice[0]])}, two seeds)")
        return watch


def device_table(circuit_data, device) -> WitnessTable:
    """The circuit's WitnessTable on ``device``, built at first use and
    kept with the circuit data."""
    cache = circuit_data.prover_only.witness_tables
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = WitnessTable(circuit_data, device)
    return cache[key]


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def poseidon_trace_plain(inputs: torch.Tensor, swap: torch.Tensor):
    """PoseidonGate traces of (..., 12) inputs and (...,) swap flags:
    (outputs (..., 12), trace (..., 110)), the trace being the deltas, full
    rounds 1-3, the partial rounds' lane 0 and the last four full rounds,
    each after the round constants (iop/witness.py::_poseidon_trace)."""
    from ..hash.constants import HALF_N_FULL_ROUNDS as H
    from ..hash.constants import N_PARTIAL_ROUNDS as PR
    from ..hash.poseidon import _sbox, _tables, mds_layer

    rc = _tables(inputs.device)[0]
    lo, hi = inputs[..., :4], inputs[..., 4:8]
    deltas = gfd.mul(swap[..., None], gfd.sub(hi, lo))
    state = torch.cat([gfd.add(lo, deltas), gfd.sub(hi, deltas), inputs[..., 8:]], dim=-1)
    trace = [deltas]
    for r in range(2 * H + PR):
        state = gfd.add(state, rc[r])
        if H <= r < H + PR:
            trace.append(state[..., :1])
            state = torch.cat([_sbox(state[..., :1]), state[..., 1:]], dim=-1)
        else:
            if r > 0:
                trace.append(state)
            state = _sbox(state)
        state = mds_layer(state)
    return state, torch.cat(trace, dim=-1)


def _ext_mul(a0, a1, b0, b1):
    return (gfd.add(gfd.mul(a0, b0), gfd.mul_const(gfd.mul(a1, b1), gfd.W)),
            gfd.add(gfd.mul(a0, b1), gfd.mul(a1, b0)))


def _bits(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., nbits) bits of the u64 patterns x, lowest first."""
    shifts = torch.arange(nbits, dtype=torch.int64, device=x.device)
    return (x[..., None] >> shifts) & 1


def _step_plain(st: Step, values: torch.Tensor, wires: torch.Tensor, n: int) -> torch.Tensor:
    """One schedule batch on every proof's values (B, R): the outputs (B,
    m, k_out); a Poseidon batch also writes its trace into ``wires``."""
    g = values[:, st.ins]                                    # (B, m, k_in)
    if st.kind == "const":
        return st.consts.expand(values.shape[0], *st.consts.shape)
    if st.kind == "arith":
        c0, c1 = st.consts
        out = gfd.add(gfd.mul(c0, gfd.mul(g[..., 0], g[..., 1])), gfd.mul(c1, g[..., 2]))
        return out[..., None]
    if st.kind == "arith_ext":
        c0, c1 = st.consts
        p0, p1 = _ext_mul(g[..., 0], g[..., 1], g[..., 2], g[..., 3])
        return torch.stack([gfd.add(gfd.mul(p0, c0), gfd.mul(g[..., 4], c1)),
                            gfd.add(gfd.mul(p1, c0), gfd.mul(g[..., 5], c1))], dim=-1)
    if st.kind == "eq_inv":
        return gfd.inverse(g)
    if st.kind == "ext_inv":
        a0, a1 = g[..., 0], g[..., 1]
        ninv = gfd.inverse(gfd.sub(gfd.mul(a0, a0), gfd.mul_const(gfd.mul(a1, a1), gfd.W)))
        return torch.stack([gfd.mul(a0, ninv), gfd.mul(gfd.neg(a1), ninv)], dim=-1)
    if st.kind == "base_sum":
        return _bits(g[..., 0], st.nbits)
    if st.kind == "random_access":
        idx = g[..., :1]                                     # < 2^nbits < 2^32
        inside = (idx >= 0) & (idx < g.shape[-1] - 1)        # the host refuses others
        claimed = torch.gather(g[..., 1:], -1, torch.where(inside, idx, 0))
        claimed = torch.where(inside, claimed, 0)
        return torch.cat([claimed, _bits(idx[..., 0], st.nbits)], dim=-1)
    # poseidon
    outputs, trace = poseidon_trace_plain(g[..., :12], g[..., 12])
    cols = torch.arange(PoseidonGate.START_DELTA, PoseidonGate.num_wires_used,
                        device=wires.device)
    wires[:, cols[None, :] * n + st.rows[:, None]] = trace
    return outputs


def witness_plain(table: WitnessTable, values: torch.Tensor):
    """Plain PyTorch version of K3: run the schedule on the seeded values
    (B, R) (filled in place); returns the wire matrix (B, W, n) and the
    public inputs (B, P)."""
    b, n = values.shape[0], table.n
    wires = torch.zeros((b, table.num_wires * n), dtype=torch.int64, device=values.device)
    for st in table.steps:
        out = _step_plain(st, values, wires, n).reshape(b, -1)
        values[:, st.outs.reshape(-1)] = out
        if st.wire_pos.numel():
            wires[:, st.wire_pos] = out[:, st.wire_src]
    wires[:, table.route_pos] = values[:, table.route_rep]
    return wires.view(b, table.num_wires, n), values[:, table.pi_reps]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def witnesses_and_conflicts(circuit_data, pws, device):
    """The witnesses of ``pws`` (one circuit, the same seeded targets) on
    ``device``: the wire matrices (B, W, n) and public inputs (B, P),
    int64 tensors there, and each proof's count of writes that the host
    witness would refuse, (B,) int64 there, or None where the circuit and
    the seeds write no rep twice.  CUDA runs K3, the CPU the plain
    version."""
    device = torch.device(device)
    seed_reps, seeds = seed_batch(circuit_data, pws)
    table = device_table(circuit_data, device)
    watch = table.check_seeds(seed_reps, seeds)
    values = table.seeded_values(seed_reps, seeds)
    seeded = values[:, watch]
    wires, pis = witness_plain(table, values)
    return wires, pis, count_conflicts(table, values, watch, seeded)


def count_conflicts(table: WitnessTable, values: torch.Tensor, watch: torch.Tensor,
                    seeded: torch.Tensor) -> torch.Tensor | None:
    """Each proof's count (B,) of writes the host witness would refuse in
    the filled value table (B, R): the reps ``watch`` no longer holding
    their seeds ``seeded`` (B, len(watch)), the shadow slots differing from
    their rep.  None where there is nothing to compare."""
    counts = None
    if watch.numel():
        counts = (values[:, watch] != seeded).sum(1)
    if table.shadow.numel():
        again = (values[:, table.shadow] != values[:, table.shadow_rep]).sum(1)
        counts = again if counts is None else counts + again
    return counts


def raise_conflicts(counts: np.ndarray) -> None:
    """Raise WitnessConflict, the host witness's error, for the first proof
    whose count from ``witnesses_and_conflicts`` is not 0."""
    bad = np.flatnonzero(counts)
    if bad.size:
        raise WitnessConflict("Partition was set twice with different values "
                              f"(proof {int(bad[0])}: {int(counts[bad[0]])} writes)")


def generate_witnesses_device(circuit_data, pws, device):
    """The witnesses of ``pws`` on ``device``, wire matrices (B, W, n) and
    public inputs (B, P) as ``witnesses_and_conflicts`` makes them; raises
    WitnessConflict where the host witness would."""
    wires, pis, conflicts = witnesses_and_conflicts(circuit_data, pws, device)
    if conflicts is not None:
        raise_conflicts(conflicts.cpu().numpy())
    return wires, pis


def generate_witness_device(circuit_data, pw, device, fetch_pis: bool = True):
    """One witness on ``device``: its wire matrix (W, n) and public inputs,
    numpy u64 when ``fetch_pis`` (the default), else the (P,) tensor."""
    wires, pis = generate_witnesses_device(circuit_data, [pw], device)
    return wires[0], (gfd.to_u64(pis[0]) if fetch_pis else pis[0])
