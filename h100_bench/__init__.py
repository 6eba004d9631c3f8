"""The benchmark of deepdenoiser_tpu_torch on one NVIDIA H100.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once (run.py); registry.py says how the
folder is laid out and found by name. The yardstick lives here and
imports nothing of the program: the traffic generator (traffic.py), the
counts and peaks (counts.py), the plain references (reference/) and the
comparisons that decide `correct` (drivers/). calibrate.py takes the
readings the limits of `correct` are set from; tests/ runs on the CPU
(`python -m pytest h100_bench/tests`), its `gpu` tests on the card.
"""
