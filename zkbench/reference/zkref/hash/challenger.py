"""Fiat–Shamir challenger: duplex Poseidon sponge over Goldilocks.

Matches the reference engine's Challenger semantics: observe elements into
an input buffer; on demand (or when the buffer reaches the rate) overwrite
the first ``len(buffer)`` state elements, permute, and refill the output
buffer with state[0..8]; challenges pop from the end of the output buffer.

Host-side (numpy) — the transcript handles only caps/evals, never bulk data.
"""

from __future__ import annotations

import numpy as np

from ..host import poseidon as hposeidon
from .constants import RATE, WIDTH


class Challenger:
    def __init__(self):
        self.state = np.zeros(WIDTH, dtype=np.uint64)
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observing -----------------------------------------------------

    def observe_element(self, x):
        self.output_buffer.clear()
        self.input_buffer.append(int(x))
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_elements(self, xs):
        for x in np.ravel(np.asarray(xs, dtype=np.uint64)):
            self.observe_element(x)

    def observe_hash(self, h):
        self.observe_elements(h)

    def observe_cap(self, cap: np.ndarray):
        for digest in np.asarray(cap, dtype=np.uint64).reshape(-1, 4):
            self.observe_elements(digest)

    def observe_extension_element(self, e):
        self.observe_elements(np.asarray(e, dtype=np.uint64).reshape(2))

    def observe_extension_elements(self, es):
        for e in np.asarray(es, dtype=np.uint64).reshape(-1, 2):
            self.observe_extension_element(e)

    # -- squeezing -----------------------------------------------------

    def _duplex(self):
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer.clear()
        self.state = hposeidon.permute(self.state)
        self.output_buffer = [int(v) for v in self.state[:RATE]]

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> np.ndarray:
        c = self.get_n_challenges(2)
        return np.array(c, dtype=np.uint64)

    def get_hash(self) -> np.ndarray:
        return np.array(self.get_n_challenges(4), dtype=np.uint64)
