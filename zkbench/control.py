#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken, its
zero knowledge (no salt polynomials), and run as the benchmark runs the
program.  Its proofs are valid but not the configuration's, so the
comparison has to read them as not correct.

    python3 zkbench/control.py --workload <cell> --seed <n> --seconds <s>

Prints run.py's result line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from zkbench import run  # noqa: E402
from zkbench.harness import spec  # noqa: E402


def control_program(circuit):
    class Control:
        """``circuit``'s reference without zero knowledge, in the program's place."""

        def __init__(self, config: dict, cache_dir, device):
            broken = copy.deepcopy(config)
            broken["config"]["zero_knowledge"] = False
            self.reference = circuit.Reference(broken, device)
            self.built = True
            self.degree_bits = self.reference.circuit_data.common.degree_bits

        def witness(self, w: dict) -> dict:
            return w

        def prove(self, ws: list) -> list:
            return self.reference.prove(ws)

        def aggregate(self, leaves: list, b: int, d: int) -> tuple:
            return self.reference.aggregate(leaves, b, d)

    return Control


def main(argv=None) -> int:
    args = run.parse(argv)
    cell = spec.find_cell(spec.load_spec(), args.workload)
    circuit = spec.load_module("circuits", cell.config["circuit"])
    return run.main(argv, program_cls=control_program(circuit))


if __name__ == "__main__":
    sys.exit(main())
