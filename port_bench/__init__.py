"""The benchmark of the PyTorch and CUDA port (``vqa_attention_networks_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the cards of the
machine it starts on and prints one JSON line. Everything that belongs to
one configuration, traffic mix, cell or per-layer metric sits in a file of
its own under this folder, found by the name ``BENCHMARK.json`` gives it
(``harness.load_cell``).
"""
