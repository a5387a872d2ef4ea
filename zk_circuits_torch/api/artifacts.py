"""Circuit-artifact (de)serialization: common.bin / verifier.bin / prover.bin.

The analog of the reference's three-artifact checkpoint flow
(wormhole/circuit-builder/src/lib.rs:11-66 writes the bins;
prover/verifier constructors reload them, prover/src/lib.rs:104-187).

common.bin and verifier.bin keep the JAX package's format byte for byte
(``MAGIC``, ``VERSION``, a json header, raw u64 arrays): the same circuit
gives equal files from both packages.

prover.bin is a versioned pickle of the prover-only data and the
wormhole fragment targets, as in the JAX package, but of host arrays
only: the constants/sigmas commitment keeps its coefficients and cap and
none of its device tensors, and the per-device witness tables and the
seed order are left out.  The loader commits the coefficients again on
the device it is given and holds the cap to the stored one.  It unpickles
the classes that ``zk_circuits_torch`` defines, the few names numpy
rebuilds an array with and a few builtin constructors only, and no dotted
name, so a prover.bin that the JAX package wrote (its classes live in
``zk_circuits_tpu``) is refused with a ValueError before anything of it
is imported.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pickle
import struct
from pathlib import Path

import numpy as np

from ..circuits.wormhole.circuit import WormholeCircuit
from ..iop.gates import gate_from_id
from ..plonk.circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from ..plonk.config import CircuitConfig, FriConfig

MAGIC = b"ZKTC"
VERSION = 1
# builtins a prover.bin may name (containers and scalars; nothing callable
# beyond a constructor)
_PICKLE_BUILTINS = frozenset({"set", "frozenset", "slice", "range", "complex", "bytearray",
                              "int", "float", "bool", "str", "bytes", "list", "tuple", "dict"})
# the numpy names an array, a dtype or a scalar rebuilds itself with
# (numpy.core before numpy 2, numpy._core since)
_PICKLE_NUMPY = frozenset({("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.multiarray", name) for core in ("core", "_core")
    for name in ("_reconstruct", "scalar")})


def _config_to_dict(cfg: CircuitConfig) -> dict:
    d = {k: getattr(cfg, k) for k in (
        "num_wires", "num_routed_wires", "num_constants", "use_base_arithmetic_gate",
        "security_bits", "num_challenges", "zero_knowledge", "max_quotient_degree_factor",
    )}
    f = cfg.fri_config
    d["fri"] = {k: getattr(f, k) for k in (
        "rate_bits", "cap_height", "proof_of_work_bits", "reduction_arity_bits",
        "final_poly_bits", "num_query_rounds",
    )}
    return d


def _config_from_dict(d: dict) -> CircuitConfig:
    fri = FriConfig(**d.pop("fri"))
    return CircuitConfig(fri_config=fri, **d)


def common_data_to_bytes(common: CommonCircuitData) -> bytes:
    header = {
        "config": _config_to_dict(common.config),
        "degree_bits": common.degree_bits,
        "gate_ids": [g.id for g in common.gate_types],
        "selector_groups": common.selector_groups,
        "num_gate_constraints": common.num_gate_constraints,
        "num_public_inputs": common.num_public_inputs,
    }
    hb = json.dumps(header).encode()
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<II", VERSION, len(hb)))
    buf.write(hb)
    buf.write(np.ascontiguousarray(common.k_is).tobytes())
    buf.write(np.ascontiguousarray(common.circuit_digest).tobytes())
    return buf.getvalue()


def common_data_from_bytes(data: bytes) -> CommonCircuitData:
    buf = io.BytesIO(data)
    assert buf.read(4) == MAGIC, "bad common.bin magic"
    version, hlen = struct.unpack("<II", buf.read(8))
    assert version == VERSION
    header = json.loads(buf.read(hlen))
    config = _config_from_dict(header["config"])
    gate_types = [gate_from_id(g) for g in header["gate_ids"]]
    gate_to_index = {g.id: i for i, g in enumerate(gate_types)}
    groups = [list(g) for g in header["selector_groups"]]
    gate_to_group = {}
    for gi, grp in enumerate(groups):
        for idx in grp:
            gate_to_group[gate_types[idx].id] = gi
    k_is = np.frombuffer(buf.read(8 * config.num_routed_wires), dtype="<u8").astype(np.uint64)
    digest = np.frombuffer(buf.read(32), dtype="<u8").astype(np.uint64)
    return CommonCircuitData(
        config=config,
        degree_bits=header["degree_bits"],
        gate_types=gate_types,
        selector_groups=groups,
        gate_to_group=gate_to_group,
        gate_to_index=gate_to_index,
        num_gate_constraints=header["num_gate_constraints"],
        num_public_inputs=header["num_public_inputs"],
        k_is=k_is,
        circuit_digest=digest,
    )


def verifier_data_to_bytes(vo: VerifierOnlyCircuitData) -> bytes:
    buf = io.BytesIO()
    buf.write(b"ZKTV")
    buf.write(struct.pack("<II", VERSION, vo.constants_sigmas_cap.shape[0]))
    buf.write(np.ascontiguousarray(vo.constants_sigmas_cap).tobytes())
    buf.write(np.ascontiguousarray(vo.circuit_digest).tobytes())
    return buf.getvalue()


def verifier_data_from_bytes(data: bytes) -> VerifierOnlyCircuitData:
    buf = io.BytesIO(data)
    assert buf.read(4) == b"ZKTV", "bad verifier.bin magic"
    version, cap_len = struct.unpack("<II", buf.read(8))
    assert version == VERSION
    cap = np.frombuffer(buf.read(32 * cap_len), dtype="<u8").astype(np.uint64).reshape(cap_len, 4)
    digest = np.frombuffer(buf.read(32), dtype="<u8").astype(np.uint64)
    return VerifierOnlyCircuitData(cap, digest)


def prover_data_to_bytes(circuit_data, targets) -> bytes:
    """Versioned pickle of the prover-only data, host arrays only, and the
    fragment targets (dataclasses of ints)."""
    from ..field import goldilocks as gfd
    from ..fri.oracle import PolynomialBatch

    po = circuit_data.prover_only
    cs = po.constants_sigmas_commitment
    coeffs = cs.coeffs if cs.coeffs is not None else gfd.to_u64(cs.coeffs_dev)
    host_cs = PolynomialBatch(np.asarray(coeffs, np.uint64), cs.rate_bits, cs.blinding,
                              cs.cap_height, _cap=cs.cap.copy())
    host_po = dataclasses.replace(po, constants_sigmas_commitment=host_cs,
                                  witness_tables={}, seed_order=None)
    return pickle.dumps({"version": VERSION, "prover_only": host_po, "targets": targets},
                        protocol=4)


def _port_class(obj) -> bool:
    return isinstance(obj, type) and obj.__module__.split(".")[0] == "zk_circuits_torch"


class _PortUnpickler(pickle.Unpickler):
    """Admits the classes that zk_circuits_torch defines, the names numpy
    rebuilds its arrays with, and a few builtins; a dotted name (which
    the unpickler would walk attribute by attribute) never."""

    def find_class(self, module, name):
        if "." not in name:
            if (module, name) in _PICKLE_NUMPY or (
                    module == "builtins" and name in _PICKLE_BUILTINS):
                return super().find_class(module, name)
            if module.split(".")[0] == "zk_circuits_torch":
                obj = super().find_class(module, name)
                if _port_class(obj):
                    return obj
        raise pickle.UnpicklingError(f"{module}.{name} is not a class of zk_circuits_torch")


def prover_data_from_bytes(data: bytes, device="cuda") -> dict:
    """The prover.bin blob, its constants/sigmas commitment made again on
    ``device``.  Refuses (ValueError) a blob that names anything but a
    class of zk_circuits_torch, numpy's array names and the admitted
    builtins (a JAX package prover.bin among them), and a commitment
    whose cap differs from the stored one."""
    from .. import resolve_device
    from ..fri.oracle import PolynomialBatch

    device = resolve_device(device)
    try:
        blob = _PortUnpickler(io.BytesIO(data)).load()
    except pickle.UnpicklingError as e:
        raise ValueError(f"not a prover.bin of zk_circuits_torch: {e}") from None
    if not isinstance(blob, dict) or blob.get("version") != VERSION:
        raise ValueError("not a prover.bin of zk_circuits_torch (version "
                         f"{blob.get('version') if isinstance(blob, dict) else None})")
    po = blob["prover_only"]
    cs = po.constants_sigmas_commitment
    commit = PolynomialBatch.from_coeffs(cs.coeffs, cs.rate_bits, cs.cap_height,
                                         blinding=False, device=device)
    if not np.array_equal(commit.cap, cs.cap):
        raise ValueError("prover.bin: the constants/sigmas commitment does not match its cap")
    po.constants_sigmas_commitment = commit
    return blob


def generate_circuit_binaries(out_dir, include_prover: bool = True,
                              config: CircuitConfig | None = None, device="cuda"):
    """Build the wormhole circuit on ``device`` and write common.bin /
    verifier.bin / prover.bin (circuit-builder/src/lib.rs:11-66)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    config = config or CircuitConfig.standard_recursion_config()
    circuit = WormholeCircuit(config)
    targets = circuit.targets()
    data = circuit.build_circuit(device)
    write_circuit_binaries(out, data, targets if include_prover else None)
    return data


def write_circuit_binaries(out_dir, data, targets=None) -> None:
    """Write ``data``'s common.bin and verifier.bin into ``out_dir``, and
    its prover.bin with ``targets`` unless they are None."""
    out = Path(out_dir)
    (out / "common.bin").write_bytes(common_data_to_bytes(data.common))
    (out / "verifier.bin").write_bytes(verifier_data_to_bytes(data.verifier_only))
    if targets is not None:
        (out / "prover.bin").write_bytes(prover_data_to_bytes(data, targets))


def load_verifier(verifier_path, common_path):
    from .verifier import WormholeVerifier

    common = common_data_from_bytes(Path(common_path).read_bytes())
    vo = verifier_data_from_bytes(Path(verifier_path).read_bytes())
    return WormholeVerifier.from_parts(common, vo)


def load_prover(prover_path, common_path, device="cuda"):
    """The WormholeProver of these artifacts, its device state on ``device``."""
    from ..plonk.circuit_data import CircuitData
    from .prover import WormholeProver

    common = common_data_from_bytes(Path(common_path).read_bytes())
    blob = prover_data_from_bytes(Path(prover_path).read_bytes(), device)
    po = blob["prover_only"]
    vo = VerifierOnlyCircuitData(
        po.constants_sigmas_commitment.cap.copy(), common.circuit_digest
    )
    data = CircuitData(common, po, vo)
    return WormholeProver(circuit_data=data, targets=blob["targets"])


def _main() -> None:
    """CLI analog of the reference's circuit-builder binary
    (circuit-builder/src/main.rs): python -m zk_circuits_torch.api.artifacts
    [out_dir] [--no-prover]; the circuit is built on the card."""
    import sys

    args = list(sys.argv[1:])
    include_prover = "--no-prover" not in args
    args = [a for a in args if not a.startswith("--")]
    out_dir = args[0] if args else "zk_circuits_torch/_generated-bins"
    print(f"building wormhole circuit -> {out_dir}/", flush=True)
    generate_circuit_binaries(out_dir, include_prover=include_prover)
    print("wrote common.bin, verifier.bin"
          + (", prover.bin" if include_prover else ""))


if __name__ == "__main__":
    _main()
