"""ChaCha8 CSPRNG — provenance of the Poseidon round constants.

The Plonky2-class proving system of the reference (``qp-plonky2``) derives
its Poseidon round constants for the Goldilocks field by sampling 360
uniform field elements from ``ChaCha8Rng::seed_from_u64(0)`` with rand's
``gen_range(0..ORDER)``.  This module reimplements that sampling pipeline
(rand_chacha's word order) so that the table in ``hash/constants.py`` can
be re-derived and audited at any time (tests/test_torch_native.py).

The port's own copy of the JAX package's ``utils/chacha.py``: pure Python,
no framework.
"""

from __future__ import annotations

import struct

GOLDILOCKS_ORDER = 2**64 - 2**32 + 1
_M64 = (1 << 64) - 1


def pcg32_seed_expand(seed: int) -> bytes:
    """rand_core ``SeedableRng::seed_from_u64``: expand a u64 seed to 32
    bytes using the PCG32 output function."""
    mul = 6364136223846793005
    inc = 11634580027462260723
    state = seed & _M64
    out = b""
    for _ in range(8):
        state = (state * mul + inc) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF
        out += struct.pack("<I", x)
    return out


def _chacha_block(key32: bytes, counter: int, rounds: int) -> list[int]:
    def rotl(x: int, n: int) -> int:
        return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF

    state = (
        list(struct.unpack("<4I", b"expand 32-byte k"))
        + list(struct.unpack("<8I", key32))
        + [counter & 0xFFFFFFFF, (counter >> 32) & 0xFFFFFFFF, 0, 0]
    )
    ws = state[:]

    def qr(a: int, b: int, c: int, d: int) -> None:
        ws[a] = (ws[a] + ws[b]) & 0xFFFFFFFF
        ws[d] = rotl(ws[d] ^ ws[a], 16)
        ws[c] = (ws[c] + ws[d]) & 0xFFFFFFFF
        ws[b] = rotl(ws[b] ^ ws[c], 12)
        ws[a] = (ws[a] + ws[b]) & 0xFFFFFFFF
        ws[d] = rotl(ws[d] ^ ws[a], 8)
        ws[c] = (ws[c] + ws[d]) & 0xFFFFFFFF
        ws[b] = rotl(ws[b] ^ ws[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(w + s) & 0xFFFFFFFF for w, s in zip(ws, state)]


class ChaCha8Rng:
    """Minimal ChaCha8 stream RNG matching rand_chacha's word order."""

    def __init__(self, seed_u64: int):
        self._key = pcg32_seed_expand(seed_u64)
        self._counter = 0
        self._buf: list[int] = []

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = _chacha_block(self._key, self._counter, rounds=8)
            self._counter += 1
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def gen_range_u64(self, upper: int) -> int:
        """rand 0.8 ``UniformInt::<u64>::sample_single(0, upper)``:
        widening-multiply with zone rejection."""
        zone = ((upper << _leading_zeros64(upper)) - 1) & _M64
        while True:
            v = self.next_u64()
            m = v * upper
            if (m & _M64) <= zone:
                return m >> 64


def _leading_zeros64(x: int) -> int:
    return 64 - x.bit_length()


def generate_poseidon_round_constants(n: int = 360) -> list[int]:
    """Regenerate the 360 Goldilocks Poseidon round constants used by the
    reference proving stack (width 12 × 30 rounds)."""
    rng = ChaCha8Rng(0)
    return [rng.gen_range_u64(GOLDILOCKS_ORDER) for _ in range(n)]
