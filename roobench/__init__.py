"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 -m roobench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
it starts on and prints one JSON result line."""
