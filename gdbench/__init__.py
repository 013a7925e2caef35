"""The benchmark of the PyTorch and CUDA renderer
(gradientdomain_mitsuba_tpu_torch): one command runs one cell once
(`python3 -m gdbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`).  Cells, configurations, traffic mixes and per-layer
metrics are files under this folder, found by the names that
BENCHMARK.json gives them.
"""
