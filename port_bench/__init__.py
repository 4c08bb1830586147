"""The benchmark of ``object_detection_destr_tpu_torch`` on NVIDIA GPUs:
``python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line."""
