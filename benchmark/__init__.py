"""The benchmark of stark_tpu_torch (see BENCHMARK.json and PERF.md)."""
