"""The benchmark of the PyTorch and CUDA port (orb_slam2_commit_tpu_torch):
`python3 slambench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on the card and prints
one JSON line. Configurations, traffic mixes, limits and per-layer metrics
are files of their own, found by name (registry.py)."""
