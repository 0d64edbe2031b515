"""The benchmark of mapfree_tpu_torch: ``python3 perfbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once on the card."""
