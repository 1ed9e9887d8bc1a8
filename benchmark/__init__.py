"""The benchmark of rts_tpu_torch: one harness, driven by BENCHMARK.json and
the data files beside it (see ``benchmark.run``)."""
