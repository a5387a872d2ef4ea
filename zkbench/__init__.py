"""zkbench -- the benchmark of the PyTorch/CUDA prover (zk_circuits_torch).

``python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of BENCHMARK.json.  Everything a cell needs is found by
name: its configuration (configs/<name>.json), its traffic mix
(workloads/<name>.json, which names its driver under traffic/), and each
per-layer metric (a reader metrics/<name>.py).  The plain reference that
judges the program's proofs is reference/zkref, which imports nothing of
the program.
"""
