"""The benchmark of the PyTorch and CUDA port (``gpu_matrix_inversion_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Configurations, input generators, traffic mixes, the program's
entries, correctness limits and metric readers are files found by the
names in ``BENCHMARK.json`` (``core/spec.py``).
"""
