"""Target (wire-graph node) representation.

Mirrors the reference engine's ``Target`` enum (Wire{row, column} |
VirtualTarget{index}) used throughout the circuit fragments, e.g.
wormhole/circuit/src/nullifier.rs:193-208.

Encoding: targets are plain ints.
  - wire target at (row, col):  row * MAX_WIRES + col   (>= 0)
  - virtual target k:           -(k + 1)                (< 0)
"""

from __future__ import annotations

from typing import NamedTuple

MAX_WIRES = 160  # fixed stride for wire-target encoding (> any config's wires)


def wire(row: int, col: int) -> int:
    return row * MAX_WIRES + col


def virtual(index: int) -> int:
    return -(index + 1)


def is_wire(t: int) -> bool:
    return t >= 0


def wire_row_col(t: int) -> tuple[int, int]:
    return divmod(t, MAX_WIRES)


def virtual_index(t: int) -> int:
    return -t - 1


class BoolTarget(NamedTuple):
    """A target known (or constrained) to hold 0/1."""

    target: int


class HashOutTarget(NamedTuple):
    """Four felts forming a digest (matches plonky2 HashOutTarget)."""

    elements: tuple  # tuple of 4 ints

    @staticmethod
    def from_list(elts) -> "HashOutTarget":
        elts = tuple(elts)
        assert len(elts) == 4
        return HashOutTarget(elts)
