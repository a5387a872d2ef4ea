"""Byte <-> field-element codecs.

Bit-exact port of the reference's codec semantics
(common/src/utils.rs):

- *injective* packing: 4-byte little-endian chunks -> one felt each
  (utils.rs:162-187); always < 2^32 so trivially canonical.
- *digest* packing: 8-byte little-endian chunks -> one felt each with
  field-order validation (utils.rs:20-55, 189-215).
- u128/u64 <-> 32-bit-limb felts, big-limb-first (utils.rs:104-141).
- 8-byte salt strings -> 2 felts (utils.rs:145-159).
"""

from __future__ import annotations

import numpy as np

from ..host.gl import P_INT

INJECTIVE_BYTES_PER_ELEMENT = 4
DIGEST_BYTES_PER_ELEMENT = 8
FELTS_PER_U128 = 4
FELTS_PER_U64 = 2
DIGEST_NUM_FIELD_ELEMENTS = 4
BIT_32_LIMB_MASK = 0xFFFFFFFF


class FeltWidthError(ValueError):
    def __init__(self, index: int, value: int):
        super().__init__(f"felt at index {index} is not a 32-bit limb: {value}")
        self.index = index
        self.value = value


class DigestError(ValueError):
    pass


def validate_bytes_digest(data: bytes) -> bytes:
    """BytesDigest::try_from: every 8-byte LE chunk must be < p
    (utils.rs:41-55)."""
    if len(data) != 32:
        raise DigestError(f"expected 32 bytes, got {len(data)}")
    for i in range(4):
        v = int.from_bytes(data[8 * i : 8 * i + 8], "little")
        if v >= P_INT:
            raise DigestError(f"chunk {i} out of field range: {v}")
    return data


def _as_32_bit_limb(felt: int, index: int) -> int:
    v = int(felt) % P_INT
    if v > BIT_32_LIMB_MASK:
        raise FeltWidthError(index, v)
    return v


def u128_to_felts(num: int) -> np.ndarray:
    """Four 32-bit limbs, most-significant limb first (utils.rs:104-115)."""
    assert 0 <= num < 2**128
    limbs = [(num >> (96 - 32 * i)) & BIT_32_LIMB_MASK for i in range(4)]
    return np.array(limbs, dtype=np.uint64)


def felts_to_u128(felts) -> int:
    out = 0
    for i, f in enumerate(felts):
        out |= _as_32_bit_limb(f, i) << (96 - 32 * i)
    return out


def u64_to_felts(num: int) -> np.ndarray:
    """[high 32 bits, low 32 bits] (utils.rs:126-131)."""
    assert 0 <= num < 2**64
    return np.array([(num >> 32) & BIT_32_LIMB_MASK, num & BIT_32_LIMB_MASK], dtype=np.uint64)


def felts_to_u64(felts) -> int:
    out = 0
    for i, f in enumerate(felts):
        out |= _as_32_bit_limb(f, i) << (32 - 32 * i)
    return out


def injective_string_to_felts(s: str) -> np.ndarray:
    """8-byte ASCII salt -> two 32-bit LE felts (utils.rs:145-159)."""
    b = s.encode()
    assert len(b) == 8, "String must be exactly 8 bytes long"
    return np.array(
        [int.from_bytes(b[0:4], "little"), int.from_bytes(b[4:8], "little")],
        dtype=np.uint64,
    )


def injective_bytes_to_felts(data: bytes) -> np.ndarray:
    """4-byte LE chunks -> felts; final chunk zero-padded (utils.rs:162-174)."""
    out = []
    for i in range(0, len(data), INJECTIVE_BYTES_PER_ELEMENT):
        chunk = data[i : i + INJECTIVE_BYTES_PER_ELEMENT]
        chunk = chunk + b"\x00" * (INJECTIVE_BYTES_PER_ELEMENT - len(chunk))
        out.append(int.from_bytes(chunk, "little"))
    return np.array(out, dtype=np.uint64)


def injective_felts_to_bytes(felts) -> bytes:
    out = b""
    for i, f in enumerate(felts):
        v = _as_32_bit_limb(f, i)
        out += v.to_bytes(8, "little")[:INJECTIVE_BYTES_PER_ELEMENT]
    return out


def digest_bytes_to_felts(data: bytes) -> np.ndarray:
    """8-byte LE chunks -> 4 felts (utils.rs:189-201); caller validates."""
    assert len(data) == 32
    return np.array(
        [int.from_bytes(data[8 * i : 8 * i + 8], "little") for i in range(4)],
        dtype=np.uint64,
    )


def digest_felts_to_bytes(felts) -> bytes:
    assert len(felts) == 4
    return b"".join(int(f).to_bytes(8, "little") for f in felts)
