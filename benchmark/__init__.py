"""The benchmark of maskrcnn_tpu_torch: see run.py and BENCHMARK.json."""
