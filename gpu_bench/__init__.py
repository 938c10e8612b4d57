"""The benchmark of ``alaz_tpu_torch`` on the H100: cells named in
``BENCHMARK.json``, run one at a time by ``python3 -m gpu_bench.run``."""
