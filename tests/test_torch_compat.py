"""The port's compat/ against the JAX package's, value for value.

``zk_circuits_torch/compat`` is host numpy, a copy of
``zk_circuits_tpu/compat`` over the port's own host field, Poseidon,
challenger and codecs.  Each check here runs both packages on the same
seeded inputs and asks for equal integers (or the same exception type and
message):

- ``poseidon_fast``: the derived fast partial-round tables, and
  ``fast_permute`` against both packages' ``host/poseidon.permute``;
- ``gates``: the nine evaluators, ``compute_filter``, and
  ``evaluate_gate_constraints`` of the wormhole layout's gates at the 28
  reference points of scripts/compat_points.npz;
- ``refbuild``/``refcircuit``: both wormhole layouts, poly for poly, their
  per-column match against the reference's constants/sigmas openings, and
  the layout digest chip_smoke.py pins;
- ``serde``: the Reader primitives and the three readers on streams
  written here, whole, truncated and with one byte changed;
- ``verifier``: its helpers, and ``verify`` refusing seeded proofs.

The last tests are the port's counterparts of tests/test_compat.py: they
need the reference's bench-data/{common,verifier,proof}.bin in the
repository and skip until it is there.
"""

import copy
import dataclasses
import hashlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from zk_circuits_torch.compat import gates as t_gates
from zk_circuits_torch.compat import poseidon_fast as t_pf
from zk_circuits_torch.compat import refbuild as t_refbuild
from zk_circuits_torch.compat import refcircuit as t_refcircuit
from zk_circuits_torch.compat import serde as t_serde
from zk_circuits_torch.compat import verifier as t_verifier
from zk_circuits_torch.hash.challenger import Challenger as t_Challenger
from zk_circuits_torch.host import gl as t_gl
from zk_circuits_torch.host import poseidon as t_hp
from zk_circuits_tpu.compat import gates as j_gates
from zk_circuits_tpu.compat import poseidon_fast as j_pf
from zk_circuits_tpu.compat import refcircuit as j_refcircuit
from zk_circuits_tpu.compat import serde as j_serde
from zk_circuits_tpu.compat import verifier as j_verifier
from zk_circuits_tpu.host import poseidon as j_hp

ROOT = Path(__file__).resolve().parents[1]
P = t_gl.P_INT
FORK_G0 = 14293326489335486720    # the fork's group generator (compat/verifier.py)


def _rng(tag: int):
    return np.random.default_rng(20261017 + tag)


def _felts(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _plain(x):
    """A comparable form of a reader's result: dataclasses by field, arrays
    as (dtype, shape, values); the class name stands for the type."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple((f.name, _plain(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_plain(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((k, _plain(v)) for k, v in x.items())))
    return x


def _outcome(fn, *args, **kw):
    """("ok", the plain result) or (exception type name, message)."""
    try:
        return ("ok", _plain(fn(*args, **kw)))
    except Exception as e:  # both packages must fail alike
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# poseidon_fast
# ---------------------------------------------------------------------------

FAST_TABLES = ("FAST_PARTIAL_FIRST_ROUND_CONSTANT", "FAST_PARTIAL_ROUND_CONSTANTS",
               "FAST_PARTIAL_ROUND_INITIAL_MATRIX", "FAST_PARTIAL_ROUND_W_HATS",
               "FAST_PARTIAL_ROUND_VS")


@pytest.mark.parametrize("name", FAST_TABLES)
def test_fast_tables_match_jax(name):
    got, want = getattr(t_pf, name), getattr(j_pf, name)
    assert got.dtype == want.dtype == np.uint64
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_fast_scalars_and_mds_match_jax():
    assert t_pf.MDS0TO0 == j_pf.MDS0TO0
    assert t_pf._MDS_CACHE == j_pf._MDS_CACHE == t_pf._mds_matrix()


def test_fast_permute_matches_both_permutations():
    states = [list(map(int, s)) for s in _felts(_rng(1), 32, 12)]
    states += [[0] * 12, [P - 1] * 12]
    for s in states:
        fast = t_pf.fast_permute(t_pf.HOST_ALG, s)
        arr = np.array(s, dtype=np.uint64)
        assert fast == j_pf.fast_permute(j_pf.HOST_ALG, s)
        assert fast == [int(v) for v in t_hp.permute(arr.copy())]
        assert fast == [int(v) for v in j_hp.permute(arr.copy())]


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

GATES = {
    "ArithmeticGate": {"num_ops": 20},
    "ArithmeticExtensionGate": {"num_ops": 10},
    "MulExtensionGate": {"num_ops": 13},
    "BaseSumGate": {"num_limbs": 63, "base": 2},
    "ConstantGate": {"num_consts": 2},
    "PublicInputGate": {},
    "NoopGate": {},
    "PoseidonGate": {},
    "RandomAccessGate": {"bits": 4, "num_copies": 4, "num_extra_constants": 2},
}
POINTS = 8          # extension points each evaluator sees at once (leading axis)


def test_every_evaluator_is_covered():
    assert set(t_gates.EVALUATORS) == set(j_gates.EVALUATORS) == set(GATES)


@pytest.mark.parametrize("kind", sorted(GATES))
def test_evaluator_matches_jax(kind):
    rng = _rng(2 + sorted(GATES).index(kind))
    consts = list(_felts(rng, 4, POINTS, 2))
    wires = list(_felts(rng, 135, POINTS, 2))
    pi_hash = _felts(rng, 4)
    got = t_gates.EVALUATORS[kind](t_serde.RefGate(kind, dict(GATES[kind])), consts, wires,
                                   pi_hash)
    want = j_gates.EVALUATORS[kind](j_serde.RefGate(kind, dict(GATES[kind])), consts, wires,
                                    pi_hash)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_compute_filter_matches_jax():
    rng = _rng(20)
    seeded = _felts(rng, POINTS, 2)
    for s in (seeded, t_gates._ext(3), t_gates._ext(t_gates.UNUSED_SELECTOR)):
        for group in ((0, 5), (5, 6), (0, 1)):
            for row in range(group[0], group[1]):
                for many in (False, True):
                    got = t_gates.compute_filter(row, group, s, many)
                    assert np.array_equal(got, j_gates.compute_filter(row, group, s, many))
    assert t_gates.UNUSED_SELECTOR == j_gates.UNUSED_SELECTOR


def test_ext_alg_matches_jax():
    rng = _rng(21)
    a, b = _felts(rng, 2), _felts(rng, 2)
    for op in ("add", "sub", "mul"):
        assert np.array_equal(getattr(t_gates.EXT, op)(a, b), getattr(j_gates.EXT, op)(a, b))
    assert np.array_equal(t_gates.EXT.from_int(P + 5), j_gates.EXT.from_int(P + 5))


def test_gate_constraints_at_the_reference_points(wormhole_common):
    """evaluate_gate_constraints of the wormhole layout's gates, the 28
    points' wires and constants embedded as extension elements (one
    leading axis of 28)."""
    t_common, j_common = wormhole_common
    pts = np.load(ROOT / "scripts" / "compat_points.npz")
    lift = np.zeros((28, 2), dtype=np.uint64)

    def ext_columns(cols):
        out = []
        for c in cols.T:
            e = lift.copy()
            e[:, 0] = c
            out.append(e)
        return out

    constants = ext_columns(pts["constants_sigmas"][:, : t_common.num_constants])
    wires = ext_columns(pts["wires"][:, : t_common.num_wires])
    pi_hash = _felts(_rng(22), 4)
    got = t_gates.evaluate_gate_constraints(t_common, constants, wires, pi_hash)
    want = j_gates.evaluate_gate_constraints(j_common, constants, wires, pi_hash)
    assert len(got) == len(want) == 123
    for g, w in zip(got, want):
        assert g.shape == (28, 2)
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# refbuild / refcircuit
# ---------------------------------------------------------------------------


def _polys(layout):
    return np.concatenate([layout.selector_polys(), layout.constant_polys(),
                           layout.sigma_polys()])


@pytest.fixture(scope="module")
def layouts():
    """{zero_knowledge: (port layout, JAX layout, port polys, JAX polys)},
    the polys as selectors ‖ constants ‖ sigmas (84, 2^13)."""
    out = {}
    for zk in (True, False):
        t_layout = t_refcircuit.build_wormhole_layout(zk)
        j_layout = j_refcircuit.build_wormhole_layout(zk)
        out[zk] = (t_layout, j_layout, _polys(t_layout), _polys(j_layout))
    return out


def _layout_sha256(polys) -> str:
    return hashlib.sha256(np.ascontiguousarray(polys, dtype="<u8").tobytes()).hexdigest()


@pytest.mark.parametrize("zk", [True, False])
def test_layout_matches_jax(layouts, zk):
    t_layout, j_layout, t_polys, j_polys = layouts[zk]
    assert (t_layout.degree, t_layout.degree_bits) == (j_layout.degree, j_layout.degree_bits)
    assert t_layout.degree_bits == 13          # the reference's is 14 (ROADMAP.md Queue 3)
    assert t_layout.gate_list == j_layout.gate_list
    assert t_layout.selector_groups == j_layout.selector_groups
    assert t_layout.builder.n_virtual == j_layout.builder.n_virtual
    assert t_layout.builder.copy_constraints == j_layout.builder.copy_constraints
    assert [(g.kind, g.constants) for g in t_layout.builder.rows] == \
        [(g.kind, g.constants) for g in j_layout.builder.rows]
    for t_part, j_part in ((t_layout.selector_polys(), j_layout.selector_polys()),
                           (t_layout.constant_polys(), j_layout.constant_polys())):
        assert t_part.dtype == j_part.dtype and np.array_equal(t_part, j_part)
    assert t_polys.shape == (84, 1 << 13)
    assert np.array_equal(t_polys, j_polys)


def test_layout_digest_is_the_pinned_one(layouts):
    """chip_smoke's pin, re-derived from the JAX package here and by
    scripts/golden_digests.py."""
    t_layout, _, t_polys, j_polys = layouts[True]
    assert _layout_sha256(j_polys) == chip_smoke.GOLDEN_COMPAT_LAYOUT_SHA256
    assert _layout_sha256(t_polys) == chip_smoke.GOLDEN_COMPAT_LAYOUT_SHA256
    assert t_layout.gate_list == list(chip_smoke.COMPAT_GATE_LIST)
    assert t_layout.selector_groups == list(chip_smoke.COMPAT_SELECTOR_GROUPS)
    assert t_layout.degree_bits == chip_smoke.COMPAT_DEGREE_BITS


def _port_values_at(polys, root, xs):
    """scripts/compat_layout_parity.py's INTT over the subgroup of ``root``
    and Horner at ``xs``, on the port's host field."""
    n = polys.shape[-1]
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    x = polys[..., rev]
    inv_root = pow(root, P - 2, P)
    for s in range(bits):
        half = 1 << s
        tw = t_gl.powers(pow(inv_root, n // (2 * half), P), half)
        x = x.reshape(x.shape[:-1] + (n // (2 * half), 2, half))
        a, bm = x[..., 0, :], t_gl.mul(x[..., 1, :], tw)
        x = np.stack([t_gl.add(a, bm), t_gl.sub(a, bm)], axis=-2).reshape(polys.shape)
    coeffs = t_gl.mul(x, np.uint64(pow(n, P - 2, P)))
    acc = np.zeros((coeffs.shape[0], xs.shape[0]), dtype=np.uint64)
    for k in range(n - 1, -1, -1):
        acc = t_gl.add(t_gl.mul(acc, xs[None, :]), coeffs[:, k][:, None])
    return acc


def test_layout_columns_at_the_reference_points(layouts):
    """The port's 84 columns at the proof's 28 verified LDE points, against
    the reference's openings: the same values and the same per-column match
    vector as the JAX package's through scripts/compat_layout_parity.py."""
    t_layout, j_layout, t_polys, j_polys = layouts[True]
    spec = importlib.util.spec_from_file_location(
        "compat_layout_parity", ROOT / "scripts" / "compat_layout_parity.py")
    parity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parity)
    pts = np.load(ROOT / "scripts" / "compat_points.npz")
    xs, ref = pts["x"], pts["constants_sigmas"]
    root = t_refbuild.root_of_unity(t_layout.degree_bits)
    assert root == parity.refbuild.root_of_unity(j_layout.degree_bits)
    got = _port_values_at(t_polys, root, xs)
    want = parity.eval_at_points(parity.generic_intt(j_polys, root), xs)
    assert np.array_equal(got, want)
    t_match = [bool(np.array_equal(got[i], ref[:, i])) for i in range(84)]
    j_match = [bool(np.array_equal(want[i], ref[:, i])) for i in range(84)]
    assert t_match == j_match


def test_refbuild_helpers_match_jax():
    from zk_circuits_tpu.compat import refbuild as j_refbuild

    assert [t_refbuild.root_of_unity(b) for b in range(33)] == \
        [j_refbuild.root_of_unity(b) for b in range(33)]
    assert t_refbuild.VARIANTS == j_refbuild.VARIANTS
    assert t_refbuild.GATE_ORDER == j_refbuild.GATE_ORDER
    assert t_refbuild.GATE_DEGREES == j_refbuild.GATE_DEGREES
    assert t_refbuild.UNUSED_SELECTOR == j_refbuild.UNUSED_SELECTOR
    assert (t_refbuild.GENERATOR, t_refbuild.PO2_GENERATOR) == \
        (j_refbuild.GENERATOR, j_refbuild.PO2_GENERATOR)
    uf = t_refbuild.UnionFind()
    pairs = [tuple(p) for p in _rng(23).integers(0, 40, size=(30, 2)).tolist()]
    j_uf = j_refbuild.UnionFind()
    for a, b in pairs:
        uf.union(a, b)
        j_uf.union(a, b)
    assert [uf.find(i) for i in range(40)] == [j_uf.find(i) for i in range(40)]


@pytest.mark.parametrize("n_log", [1, 3, 5])
@pytest.mark.parametrize("sigma_dir", ["next", "prev"])
def test_gadgets_match_jax(n_log, sigma_dir, monkeypatch):
    """xor_gadget and is_const_less_than lay out the same rows, copies and
    targets on both builders, and their built layouts the same polys, with
    the sigma cycles in either direction."""
    from zk_circuits_tpu.compat import refbuild as j_refbuild

    def build(mod, refbuild):
        monkeypatch.setitem(refbuild.VARIANTS, "sigma_dir", sigma_dir)
        b = refbuild.RefBuilder(zero_knowledge=n_log == 3)
        x, y, r = b.add_virtual_target(), b.add_virtual_target(), b.add_virtual_target()
        out = [mod.xor_gadget(b, x, y)]
        out += [mod.is_const_less_than(b, left, r, n_log) for left in (0, 1, (1 << n_log) - 1)]
        b.connect(out[-1], y)
        layout = b.build()
        return (out, [(g.kind, g.constants) for g in b.rows], b.copy_constraints,
                b.n_virtual, layout.degree, _polys(layout).tolist())

    assert build(t_refcircuit, t_refbuild) == build(j_refcircuit, j_refbuild)


# ---------------------------------------------------------------------------
# serde: a writer in the reader's field order
# ---------------------------------------------------------------------------

TAGS = {v: k for k, v in t_serde.GATE_TAGS.items()}
GATE_FIELDS = {"ArithmeticGate": ("num_ops",), "ArithmeticExtensionGate": ("num_ops",),
               "MulExtensionGate": ("num_ops",), "BaseSumGate": ("num_limbs",),
               "ConstantGate": ("num_consts",), "ExponentiationGate": ("num_power_bits",),
               "RandomAccessGate": ("bits", "num_copies", "num_extra_constants"),
               "ReducingGate": ("num_coeffs",), "ReducingExtensionGate": ("num_coeffs",)}


def _u(v, n=8) -> bytes:
    return int(v).to_bytes(n, "little")


def _vec(vals) -> bytes:
    return _u(len(vals)) + b"".join(_u(v) for v in vals)


def _felt_bytes(a) -> bytes:
    return np.ascontiguousarray(a, dtype="<u8").tobytes()


def _fri_bytes(rate, cap, rounds, pow_bits, strategy) -> bytes:
    out = _u(rate) + _u(cap) + _u(rounds) + _u(pow_bits, 4)
    if strategy[0] == "fixed":
        return out + _u(0, 1) + _vec(strategy[1])
    if strategy[0] == "const_arity":
        return out + _u(1, 1) + _u(strategy[1]) + _u(strategy[2])
    if strategy[1] is None:
        return out + _u(2, 1) + _u(0, 1)
    return out + _u(2, 1) + _u(1, 1) + _u(strategy[1])


def _gate_bytes(kind, params) -> bytes:
    out = _u(TAGS[kind], 4)
    if kind == "CosetInterpolationGate":
        w = params["barycentric_weights"]
        return out + _u(params["subgroup_bits"]) + _u(params["degree"]) + _vec(w)
    return out + b"".join(_u(params[f]) for f in GATE_FIELDS.get(kind, ()))


def _common_bytes(c: dict) -> bytes:
    fri = _fri_bytes(*c["fri"])
    return b"".join([
        _u(c["num_wires"]), _u(c["num_routed_wires"]), _u(c["config_num_constants"]),
        _u(100), _u(c["num_challenges"]), _u(8), _u(0, 1), _u(int(c["zk"]), 1),
        fri, fri, _vec(c["arities"]), _u(c["degree_bits"]), _u(int(c["zk"]), 1),
        _vec(c["selector_indices"]), _u(len(c["groups"])),
        b"".join(_u(a) + _u(b) for a, b in c["groups"]),
        _u(c["quotient_degree_factor"]), _u(c["num_gate_constraints"]),
        _u(c["num_constants"]), _u(c["num_public_inputs"]),
        _u(len(c["k_is"])), _felt_bytes(c["k_is"]),
        _u(c["num_partial_products"]), _u(0), _u(0), _u(0),
        _u(len(c["gates"])), b"".join(_gate_bytes(k, p) for k, p in c["gates"]),
    ])


def _k_is(n):
    return np.array([pow(FORK_G0, j, P) for j in range(n)], dtype=np.uint64)


def _wormhole_common_fields() -> dict:
    """The wormhole layout's gates and selector groups in a common.bin of
    the reference's config (tests/test_compat.py's figures)."""
    layout = t_refcircuit.build_wormhole_layout(True)
    params = {"Constant": {"num_consts": 2}, "BaseSum": {"num_limbs": 63},
              "Arithmetic": {"num_ops": 20}}
    gates = [(f"{k}Gate", params.get(k, {})) for k in layout.gate_list]
    sel = [next(i for i, (s, e) in enumerate(layout.selector_groups) if s <= g < e)
           for g in range(len(gates))]
    return dict(num_wires=135, num_routed_wires=80, config_num_constants=2, num_challenges=2,
                zk=True, fri=(3, 4, 28, 16, ("const_arity", 4, 5)), arities=[4, 4, 4],
                degree_bits=layout.degree_bits, selector_indices=sel,
                groups=layout.selector_groups, quotient_degree_factor=8,
                num_gate_constraints=123, num_constants=2 + len(layout.selector_groups),
                num_public_inputs=16, k_is=_k_is(80), num_partial_products=9, gates=gates)


def _small_common_fields(pow_bits=0) -> dict:
    """A common.bin small enough for a seeded proof stream: 8 wires (two
    arithmetic ops), 4 routed, 2 challenges, degree 2^4, two arity-2 folds."""
    return dict(num_wires=8, num_routed_wires=4, config_num_constants=2, num_challenges=2,
                zk=True, fri=(1, 1, 2, pow_bits, ("fixed", [1, 1])), arities=[1, 1],
                degree_bits=4, selector_indices=[0, 0, 0], groups=[(0, 3)],
                quotient_degree_factor=2, num_gate_constraints=2, num_constants=3,
                num_public_inputs=3, k_is=_k_is(4), num_partial_products=1,
                gates=[("NoopGate", {}), ("ConstantGate", {"num_consts": 2}),
                       ("ArithmeticGate", {"num_ops": 2})])


@pytest.fixture(scope="module")
def wormhole_common():
    blob = _common_bytes(_wormhole_common_fields())
    return t_serde.read_common_data(blob), j_serde.read_common_data(blob)


def _proof_bytes(common, rng) -> bytes:
    """A seeded proof stream of the shape ``common`` asks for."""
    cap = 1 << common.fri_config.cap_height
    nc = common.num_challenges

    def path(k):
        return _u(k, 1) + _felt_bytes(_felts(rng, k, 4))

    out = [_felt_bytes(_felts(rng, 3 * cap, 4))]
    n_ext = (common.num_constants + common.num_routed_wires + common.num_wires + 2 * nc
             + nc * common.num_partial_products + common.num_quotient_polys)
    out.append(_felt_bytes(_felts(rng, n_ext, 2)))
    out.append(_felt_bytes(_felts(rng, len(common.reduction_arity_bits) * cap, 4)))
    depth = common.lde_bits - common.fri_config.cap_height
    for _ in range(common.fri_config.num_query_rounds):
        for w in common.oracle_widths:
            out.append(_felt_bytes(_felts(rng, w)) + path(depth))
        d = depth
        for ab in common.reduction_arity_bits:
            d -= ab
            out.append(_felt_bytes(_felts(rng, 1 << ab, 2)) + path(d))
    final = 1 << (common.degree_bits - sum(common.reduction_arity_bits))
    out.append(_felt_bytes(_felts(rng, final, 2)))
    out.append(_u(rng.integers(0, 1 << 63)))
    out.append(_u(common.num_public_inputs) + _felt_bytes(_felts(rng, common.num_public_inputs)))
    return b"".join(out)


def _verifier_bytes(cap_height, common_blob, rng) -> bytes:
    return (_u(cap_height) + _felt_bytes(_felts(rng, 1 << cap_height, 4))
            + _felt_bytes(_felts(rng, 4)) + common_blob)


def _mutants(blob: bytes, rng, count: int = 48):
    """Truncated copies at every 8-byte boundary's neighbourhood (a sample)
    and copies with one seeded byte changed."""
    cuts = sorted(set(rng.integers(0, len(blob), size=count).tolist()) | {0, len(blob) - 1})
    yield from (blob[:c] for c in cuts)
    for pos, val in zip(rng.integers(0, len(blob), size=count).tolist(),
                        rng.integers(0, 256, size=count).tolist()):
        b = bytearray(blob)
        b[pos] = val if val != b[pos] else (val + 1) % 256
        yield bytes(b)
    yield blob + b"\0"


def test_reader_primitives_match_jax():
    rng = _rng(30)
    blob = bytes(rng.integers(0, 256, size=300, dtype=np.uint8))
    blob = blob[:40] + _u(3) + _u(7) + _u(8) + _u(9) + _u(2) + _u(0, 1) + _u(1, 1) + blob[40:]
    calls = [("u", ()), ("u", (4,)), ("u32", ()), ("u", (1,)), ("felts", (3,)),
             ("hashes", (1,)), ("u", (8,)), ("vec_usize", ()), ("vec_usize", (1,)),
             ("boolean", ()), ("boolean", ()), ("boolean", ()), ("felts", (40,)),
             ("u", (8,)), ("done", ())]
    for start in (0, 3, 40, 41, 290, 300, 340):
        t_r, j_r = t_serde.Reader(blob), j_serde.Reader(blob)
        t_r.pos = j_r.pos = start
        for name, args in calls:
            got = _outcome(getattr(t_r, name), *args)
            assert got == _outcome(getattr(j_r, name), *args), (start, name)
            assert t_r.pos == j_r.pos


@pytest.mark.parametrize("strategy", [("const_arity", 4, 5), ("fixed", [4, 4, 4]),
                                      ("min_size", None), ("min_size", 3)])
def test_read_common_data_matches_jax(strategy):
    fields = _wormhole_common_fields()
    fields["fri"] = fields["fri"][:4] + (strategy,)
    blob = _common_bytes(fields)
    common = t_serde.read_common_data(blob)
    assert _plain(common) == _plain(j_serde.read_common_data(blob))
    assert [g.kind for g in common.gates] == [
        "NoopGate", "ConstantGate", "PublicInputGate", "BaseSumGate", "ArithmeticGate",
        "PoseidonGate"]
    assert common.oracle_widths == [84, 139, 24, 20]
    assert common.fri_config.reduction_strategy == strategy
    for bad in _mutants(blob, _rng(31)):
        assert _outcome(t_serde.read_common_data, bad) == \
            _outcome(j_serde.read_common_data, bad)


def test_read_common_data_every_gate_kind():
    fields = _small_common_fields()
    fields["gates"] = [
        ("ArithmeticExtensionGate", {"num_ops": 10}), ("MulExtensionGate", {"num_ops": 13}),
        ("ExponentiationGate", {"num_power_bits": 66}),
        ("RandomAccessGate", {"bits": 4, "num_copies": 4, "num_extra_constants": 2}),
        ("ReducingGate", {"num_coeffs": 43}), ("ReducingExtensionGate", {"num_coeffs": 32}),
        ("CosetInterpolationGate", {"subgroup_bits": 4, "degree": 6,
                                    "barycentric_weights": [5, 6, 7]}),
        ("PoseidonMdsGate", {}), ("PoseidonGate", {}), ("NoopGate", {})]
    fields["selector_indices"] = [0] * len(fields["gates"])
    blob = _common_bytes(fields)
    common = t_serde.read_common_data(blob)
    assert [g.kind for g in common.gates] == [k for k, _ in fields["gates"]]
    assert _plain(common) == _plain(j_serde.read_common_data(blob))
    # tags the reader refuses: lookup gates, an unknown tag, lookup tables
    for tag in (6, 7, 99):
        bad = blob[:-4] + _u(tag, 4)       # the last gate, a NoopGate, retagged
        got = _outcome(t_serde.read_common_data, bad)
        assert got[0] == "ValueError" and got == _outcome(j_serde.read_common_data, bad)
    lut_at = len(blob) - len(b"".join(_gate_bytes(k, p) for k, p in fields["gates"])) - 16
    bad = blob[:lut_at] + _u(1) + blob[lut_at + 8:]
    assert _outcome(t_serde.read_common_data, bad) == \
        ("ValueError", "lookup tables not supported") == \
        _outcome(j_serde.read_common_data, bad)


def test_read_common_data_refusals_match_jax():
    """The JAX reader's refusals, in its order and words."""
    fields = _small_common_fields()
    blob = _common_bytes(fields)
    other = dict(fields, fri=(1, 1, 3, 0, ("fixed", [1, 1])))
    fri_len = len(_fri_bytes(*fields["fri"]))
    start = 6 * 8 + 2
    cases = {
        "second fri config differs": blob[: start + fri_len]
        + _fri_bytes(*other["fri"]) + blob[start + 2 * fri_len:],
        "bad bool": blob[:48] + b"\x02" + blob[49:],
        "bad strategy tag": blob[: start + 28] + b"\x07" + blob[start + 29:],
        "trailing bytes": blob + b"\0\0\0",
        "truncated": blob[:-1],
        "selector count": _common_bytes(dict(fields, selector_indices=[0, 0])),
    }
    for name, bad in cases.items():
        got = _outcome(t_serde.read_common_data, bad)
        assert got[0] == "ValueError", name
        assert got == _outcome(j_serde.read_common_data, bad), name


def test_read_verifier_data_matches_jax():
    rng = _rng(32)
    blob = _verifier_bytes(4, _common_bytes(_wormhole_common_fields()), rng)
    vd = t_serde.read_verifier_data(blob)
    assert vd.constants_sigmas_cap.shape == (16, 4) and vd.common.degree_bits == 13
    assert _plain(vd) == _plain(j_serde.read_verifier_data(blob))
    alone = blob[: 8 + 16 * 32 + 32]
    assert t_serde.read_verifier_data(alone).common is None
    assert _plain(t_serde.read_verifier_data(alone)) == _plain(j_serde.read_verifier_data(alone))
    for bad in list(_mutants(blob, _rng(33))) + [_u(17) + blob[8:]]:
        assert _outcome(t_serde.read_verifier_data, bad) == \
            _outcome(j_serde.read_verifier_data, bad)


def test_read_proof_matches_jax():
    blob_c = _common_bytes(_small_common_fields())
    t_common, j_common = t_serde.read_common_data(blob_c), j_serde.read_common_data(blob_c)
    blob = _proof_bytes(t_common, _rng(34))
    proof = t_serde.read_proof(blob, t_common)
    assert len(proof.opening_proof.query_rounds) == 2
    assert proof.openings.fri_batch0().shape == (3 + 4 + 8 + 2 + 2 + 4, 2)
    assert _plain(proof) == _plain(j_serde.read_proof(blob, j_common))
    assert np.array_equal(proof.openings.fri_batch1(),
                          j_serde.read_proof(blob, j_common).openings.fri_batch1())
    for bad in _mutants(blob, _rng(35), count=64):
        assert _outcome(t_serde.read_proof, bad, t_common) == \
            _outcome(j_serde.read_proof, bad, j_common)


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def _merkle_tree(leaves, cap_height):
    """Every level's digests, leaves first, with the port's host sponge."""
    levels = [np.stack([t_hp.hash_or_noop(leaf) for leaf in leaves])]
    while levels[-1].shape[0] > 1 << cap_height:
        cur = levels[-1]
        levels.append(np.stack([t_hp.compress(cur[2 * i], cur[2 * i + 1])
                                for i in range(cur.shape[0] // 2)]))
    return levels


@pytest.mark.parametrize("width", [3, 7])
def test_merkle_paths_match_jax(width):
    leaves = _felts(_rng(40 + width), 16, width)
    levels = _merkle_tree(leaves, 1)
    cap = levels[-1]
    for index in range(16):
        siblings = np.stack([lvl[(index >> k) ^ 1] for k, lvl in enumerate(levels[:-1])])
        t_verifier._verify_merkle_proof(leaves[index], index, cap, siblings)
        j_verifier._verify_merkle_proof(leaves[index], index, cap, siblings)
        flipped = siblings.copy()
        flipped[index % 3, index % 4] ^= np.uint64(1)
        for mod in (t_verifier, j_verifier):
            with pytest.raises(mod.RefVerificationError, match="merkle proof failed"):
                mod._verify_merkle_proof(leaves[index], index, cap, flipped)
            with pytest.raises(mod.RefVerificationError, match="merkle proof failed"):
                mod._verify_merkle_proof(leaves[index], index ^ 1, cap, siblings)
    assert issubclass(t_verifier.RefVerificationError, ValueError)


def test_verifier_helpers_match_jax():
    rng = _rng(50)
    assert [t_verifier._bit_reverse(x, b) for b in range(12) for x in range(0, 4096, 37)] == \
        [j_verifier._bit_reverse(x, b) for b in range(12) for x in range(0, 4096, 37)]
    terms, alpha = list(_felts(rng, 21, 2)), _felts(rng, 2)
    assert np.array_equal(t_verifier._reduce_with_powers(terms, alpha),
                          j_verifier._reduce_with_powers(terms, alpha))
    for arity in (2, 4, 16):
        xs, ys, z = list(_felts(rng, arity, 2)), list(_felts(rng, arity, 2)), _felts(rng, 2)
        assert np.array_equal(t_verifier._interpolate_at(xs, ys, z),
                              j_verifier._interpolate_at(xs, ys, z))
    common = types.SimpleNamespace(k_is=_k_is(2))
    assert [t_verifier._fork_root_of_unity(common, b) for b in range(33)] == \
        [j_verifier._fork_root_of_unity(common, b) for b in range(33)]


@pytest.mark.parametrize("pow_bits,skip,message", [
    (0, False, "vanishing identity failed (0)"),
    (0, True, "merkle proof failed"),
    (60, False, "proof-of-work check failed")])
def test_verify_refuses_a_seeded_proof_as_jax_does(pow_bits, skip, message):
    """A seeded proof of the small common data runs the transcript, the
    vanishing identity (or not) and the FRI queries of both verifiers, and
    fails at the same check."""
    blob_c = _common_bytes(_small_common_fields(pow_bits))
    rng = _rng(60 + pow_bits)
    blob_v = _verifier_bytes(1, blob_c, rng)
    blob_p = _proof_bytes(t_serde.read_common_data(blob_c), rng)
    for serde, verifier in ((t_serde, t_verifier), (j_serde, j_verifier)):
        common = serde.read_common_data(blob_c)
        vd, proof = serde.read_verifier_data(blob_v), serde.read_proof(blob_p, common)
        with pytest.raises(verifier.RefVerificationError) as e:
            verifier.verify(common, vd, proof, _UNSOUND_skip_vanishing_for_tests=skip)
        assert str(e.value) == message
        bad = copy.deepcopy(proof)
        bad.public_inputs[0] = np.uint64(P)
        with pytest.raises(verifier.RefVerificationError, match="bad public inputs"):
            verifier.verify(common, vd, bad)


def test_package_exports_match_jax():
    import zk_circuits_torch.compat as t_compat
    import zk_circuits_tpu.compat as j_compat

    names = ["RefCommonData", "RefProof", "RefVerifierData", "read_common_data",
             "read_proof", "read_verifier_data"]
    for name in names:
        assert getattr(t_compat, name) is getattr(t_serde, name)
        assert hasattr(j_compat, name)


# ---------------------------------------------------------------------------
# The reference's own artifacts (tests/test_compat.py, on the port)
# ---------------------------------------------------------------------------

BENCH = ROOT / "bench-data"
bench = pytest.mark.skipif(
    not (BENCH / "proof.bin").exists(),
    reason="the reference's bench-data/{common,verifier,proof}.bin are not in the repository")


@pytest.fixture(scope="module")
def artifacts():
    common = t_serde.read_common_data((BENCH / "common.bin").read_bytes())
    vd = t_serde.read_verifier_data((BENCH / "verifier.bin").read_bytes())
    proof = t_serde.read_proof((BENCH / "proof.bin").read_bytes(), common)
    return common, vd, proof


@bench
def test_common_data_shape(artifacts):
    common, _, _ = artifacts
    assert common.num_wires == 135
    assert common.num_routed_wires == 80
    assert common.degree_bits == 14
    assert common.zero_knowledge and common.hiding
    assert common.fri_config.rate_bits == 3
    assert common.fri_config.cap_height == 4
    assert common.fri_config.num_query_rounds == 28
    assert common.fri_config.proof_of_work_bits == 16
    assert common.reduction_arity_bits == [4, 4, 4]
    assert common.num_public_inputs == 16
    assert [g.kind for g in common.gates] == [
        "NoopGate", "ConstantGate", "PublicInputGate", "BaseSumGate",
        "ArithmeticGate", "PoseidonGate",
    ]
    assert common.gates[3].params["num_limbs"] == 63
    assert common.gates[4].params["num_ops"] == 20
    assert common.num_gate_constraints == 123
    assert common.oracle_widths == [84, 139, 24, 20]


@bench
def test_verifier_data_embeds_common(artifacts):
    common, vd, _ = artifacts
    assert vd.constants_sigmas_cap.shape == (16, 4)
    assert vd.common is not None
    assert vd.common.degree_bits == common.degree_bits
    np.testing.assert_array_equal(vd.common.k_is, common.k_is)


@bench
def test_proof_parses_byte_exact(artifacts):
    common, _, proof = artifacts
    assert proof.public_inputs.shape == (16,)
    assert proof.opening_proof.final_poly.shape == (4, 2)
    assert len(proof.opening_proof.query_rounds) == 28
    for arr in (proof.openings.wires, proof.openings.constants,
                proof.opening_proof.final_poly):
        assert (arr < P).all()


def _transcript(common, vd, proof):
    op, fp = proof.openings, proof.opening_proof
    nc = common.num_challenges
    ch = t_Challenger()
    ch.observe_hash(vd.circuit_digest)
    ch.observe_hash(t_hp.hash_no_pad(proof.public_inputs))
    ch.observe_cap(proof.wires_cap)
    ch.get_n_challenges(nc)
    ch.get_n_challenges(nc)
    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_polys_cap)
    ch.get_extension_challenge()
    ch.observe_extension_elements(op.fri_batch0())
    ch.observe_extension_elements(op.fri_batch1())
    ch.get_extension_challenge()
    for cap in fp.commit_phase_caps:
        ch.observe_cap(cap)
        ch.get_extension_challenge()
    ch.observe_extension_elements(fp.final_poly)
    ch.observe_element(fp.pow_witness)
    pow_response = ch.get_challenge()
    indices = [ch.get_challenge() % (1 << common.lde_bits)
               for _ in range(common.fri_config.num_query_rounds)]
    return pow_response, indices


@bench
def test_fiat_shamir_transcript_parity_via_pow(artifacts):
    common, vd, proof = artifacts
    pow_response, _ = _transcript(common, vd, proof)
    assert 64 - int(pow_response).bit_length() >= common.fri_config.proof_of_work_bits


@bench
def test_all_merkle_paths_verify(artifacts):
    common, vd, proof = artifacts
    _, indices = _transcript(common, vd, proof)
    fp = proof.opening_proof
    oracle_caps = [vd.constants_sigmas_cap, proof.wires_cap,
                   proof.plonk_zs_partial_products_cap, proof.quotient_polys_cap]
    for qi, x_index in enumerate(indices):
        rnd = fp.query_rounds[qi]
        for oi in range(4):
            assert rnd.initial.evals[oi].shape[0] == common.oracle_widths[oi]
            t_verifier._verify_merkle_proof(rnd.initial.evals[oi], x_index, oracle_caps[oi],
                                            rnd.initial.proofs[oi].siblings)
        idx = x_index
        for si, ab in enumerate(common.reduction_arity_bits):
            idx >>= ab
            t_verifier._verify_merkle_proof(rnd.steps[si].evals.reshape(-1), idx,
                                            fp.commit_phase_caps[si],
                                            rnd.steps[si].proof.siblings)


@bench
def test_merkle_path_tamper_detected(artifacts):
    common, vd, proof = artifacts
    _, indices = _transcript(common, vd, proof)
    rnd = proof.opening_proof.query_rounds[0]
    bad = rnd.initial.evals[0].copy()
    bad[0] ^= np.uint64(1)
    with pytest.raises(t_verifier.RefVerificationError):
        t_verifier._verify_merkle_proof(bad, indices[0], vd.constants_sigmas_cap,
                                        rnd.initial.proofs[0].siblings)


@bench
def test_reference_proof_fri_verifies(artifacts):
    common, vd, proof = artifacts
    t_verifier.verify(common, vd, proof, _UNSOUND_skip_vanishing_for_tests=True)


@bench
def test_reference_proof_fri_rejects_tamper(artifacts):
    common, vd, proof = artifacts
    bad = copy.deepcopy(proof)
    bad.opening_proof.final_poly[0, 0] ^= np.uint64(1)
    with pytest.raises(t_verifier.RefVerificationError):
        t_verifier.verify(common, vd, bad, _UNSOUND_skip_vanishing_for_tests=True)


@bench
def test_full_reference_proof_verifies(artifacts):
    common, vd, proof = artifacts
    t_verifier.verify(common, vd, proof)


@bench
def test_full_reference_proof_rejects_tampered_pi(artifacts):
    common, vd, proof = artifacts
    bad = copy.deepcopy(proof)
    bad.public_inputs = list(bad.public_inputs)
    bad.public_inputs[0] = int(bad.public_inputs[0]) ^ 1
    with pytest.raises(t_verifier.RefVerificationError):
        t_verifier.verify(common, vd, bad)
