"""The benchmark of ``firewheel_tpu_torch`` on an NVIDIA H100: see
``BENCHMARK.json`` at the root and ``PERF.md``."""
