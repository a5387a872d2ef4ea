"""The port's circuit artifacts and API against the JAX package.

common.bin and verifier.bin from ``zk_circuits_torch.api.artifacts`` must
equal the JAX package's bytes for the same circuit, and each package must
read the other's.  prover.bin holds host arrays only: written and loaded
again on the CPU (``WormholeProver.new_from_files``), its circuit proves
the proof the original circuit proves; a prover.bin the JAX package wrote
is refused with a ValueError, and so is a pickle naming anything beyond
the classes the port defines, numpy's array names and plain builtins.  The digest chip_smoke.py
pins for ``api/example.py``'s proof (the non-zk wormhole) is derived here
from the JAX package.
"""

import hashlib
import io
import pickle
import types

import numpy as np
import pytest
import torch
from test_torch_recursion import JAX, TORCH, square

import chip_smoke
from zk_circuits_torch.api import artifacts as t_art
from zk_circuits_torch.api.prover import WormholeProver
from zk_circuits_torch.api.verifier import WormholeVerifier
from zk_circuits_torch.utils.serialization import proof_to_bytes as t_bytes
from zk_circuits_tpu.api import artifacts as j_art
from zk_circuits_tpu.utils.serialization import proof_to_bytes as j_bytes


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sq():
    t_data, t_wit = square(TORCH, device="cpu")
    j_data, j_wit = square(JAX)
    return types.SimpleNamespace(data=t_data, wit=t_wit, j_data=j_data, j_wit=j_wit)


def test_common_and_verifier_bins_equal_jax(sq):
    assert t_art.common_data_to_bytes(sq.data.common) == \
        j_art.common_data_to_bytes(sq.j_data.common)
    assert t_art.verifier_data_to_bytes(sq.data.verifier_only) == \
        j_art.verifier_data_to_bytes(sq.j_data.verifier_only)


def test_each_package_reads_the_others_bins(sq, tmp_path):
    j_art_dir, t_art_dir = tmp_path / "jax", tmp_path / "torch"
    for d in (j_art_dir, t_art_dir):
        d.mkdir()
    (j_art_dir / "common.bin").write_bytes(j_art.common_data_to_bytes(sq.j_data.common))
    (j_art_dir / "verifier.bin").write_bytes(
        j_art.verifier_data_to_bytes(sq.j_data.verifier_only))
    t_art.write_circuit_binaries(t_art_dir, sq.data)
    assert sorted(p.name for p in t_art_dir.iterdir()) == ["common.bin", "verifier.bin"]

    proof = sq.data.prove(sq.wit(4), device="cpu")
    verifier = WormholeVerifier.new_from_files(j_art_dir / "verifier.bin",
                                               j_art_dir / "common.bin")
    verifier.verify(proof)
    assert t_art.common_data_to_bytes(verifier.common) == \
        (j_art_dir / "common.bin").read_bytes()
    j_verifier = j_art.load_verifier(t_art_dir / "verifier.bin", t_art_dir / "common.bin")
    j_verifier.verify(sq.j_data.prove(sq.j_wit(4), use_device=False))
    bad = t_art.verifier_data_from_bytes((t_art_dir / "verifier.bin").read_bytes())
    bad.circuit_digest = bad.circuit_digest ^ np.uint64(1)
    with pytest.raises(ValueError):
        WormholeVerifier.from_parts(verifier.common, bad).verify(proof)


def test_prover_bin_round_trip(sq, tmp_path):
    """prover.bin keeps host arrays only; loaded on the CPU, its circuit
    proves byte for byte what the original proves."""
    targets = {"x": 0}
    t_art.write_circuit_binaries(tmp_path, sq.data, targets)
    blob = (tmp_path / "prover.bin").read_bytes()
    named = set()

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            named.add(module.split(".")[0])
            return super().find_class(module, name)

    Recording(io.BytesIO(blob)).load()
    assert named <= {"zk_circuits_torch", "numpy"}    # no tensor, no device state
    prover = WormholeProver.new_from_files(tmp_path / "prover.bin", tmp_path / "common.bin",
                                           device="cpu")
    assert prover.targets == targets
    cd = prover.circuit_data
    assert cd.prover_only.witness_tables == {} and cd.prover_only.seed_order is None
    assert cd.prover_only.constants_sigmas_commitment.values_dev.device.type == "cpu"
    assert np.array_equal(cd.verifier_only.constants_sigmas_cap,
                          sq.data.verifier_only.constants_sigmas_cap)
    got = cd.prove(sq.wit(9), device="cpu")
    assert t_bytes(got) == t_bytes(sq.data.prove(sq.wit(9), device="cpu"))
    assert t_bytes(got) == j_bytes(sq.j_data.prove(sq.j_wit(9), use_device=False))
    cd.verify(got)


def test_a_jax_prover_bin_is_refused(sq, tmp_path):
    """The JAX package's prover.bin names zk_circuits_tpu classes: the
    port's loader refuses it before importing anything of it."""
    (tmp_path / "common.bin").write_bytes(j_art.common_data_to_bytes(sq.j_data.common))
    (tmp_path / "prover.bin").write_bytes(j_art.prover_data_to_bytes(sq.j_data, None))
    with pytest.raises(ValueError, match="zk_circuits_tpu"):
        WormholeProver.new_from_files(tmp_path / "prover.bin", tmp_path / "common.bin",
                                      device="cpu")


def test_a_pickle_naming_other_callables_is_refused(sq, tmp_path):
    class Call:
        def __reduce__(self):
            return (print, ("unpickled",))

    (tmp_path / "common.bin").write_bytes(t_art.common_data_to_bytes(sq.data.common))
    for obj in (Call(), {"version": t_art.VERSION, "prover_only": Call(), "targets": None}):
        (tmp_path / "prover.bin").write_bytes(pickle.dumps(obj, protocol=4))
        with pytest.raises(ValueError, match="builtins.print"):
            WormholeProver.new_from_files(tmp_path / "prover.bin", tmp_path / "common.bin",
                                          device="cpu")


def _global_call(module: str, name: str) -> bytes:
    """A protocol-4 pickle that calls ``module``'s ``name`` (walked
    attribute by attribute where it is dotted) on a pickle of 1."""
    def text(x: str) -> bytes:
        return b"\x8c" + bytes([len(x)]) + x.encode()

    inner = pickle.dumps(1, protocol=4)
    return (b"\x80\x04" + text(module) + text(name) + b"\x93"
            + b"C" + bytes([len(inner)]) + inner + b"\x85R.")


@pytest.mark.parametrize("module, name", [
    ("zk_circuits_torch.api.artifacts", "pickle.loads"),      # a dotted walk
    ("zk_circuits_torch.api.artifacts", "prover_data_from_bytes"),   # not a class
    ("zk_circuits_torch.api.artifacts", "Path"),      # a class the port only imports
    ("numpy", "load"),
    ("numpy._core.multiarray", "_reconstruct.__globals__"),
], ids=["dotted", "function", "imported_class", "numpy_load", "numpy_dotted"])
def test_a_pickle_naming_a_port_module_non_class_is_refused(sq, tmp_path, module, name):
    blob = _global_call(module, name)
    assert pickle.loads(_global_call("pickle", "loads")) == 1   # the stream is well formed
    with pytest.raises(ValueError, match="is not a class of zk_circuits_torch"):
        t_art.prover_data_from_bytes(blob, device="cpu")


def test_pinned_example_digest_is_the_reference_proof():
    """api/example.py proves the golden inputs under
    standard_recursion_config; chip_smoke.py holds the card's proof to
    the JAX host path's digest."""
    from zk_circuits_tpu.api.prover import WormholeProver as JProver
    from zk_circuits_tpu.circuits.wormhole import golden_fixtures
    from zk_circuits_tpu.plonk.config import CircuitConfig

    prover = JProver(CircuitConfig.standard_recursion_config())
    proof = prover.commit(golden_fixtures.test_inputs()).prove(use_device=False)
    assert hashlib.sha256(j_bytes(proof)).hexdigest() == chip_smoke.GOLDEN_WORMHOLE_SHA256
