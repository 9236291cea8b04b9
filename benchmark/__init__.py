"""The benchmark of imageencoder_tpu_torch: a data-driven harness (run.py,
harness.py), what every traffic mix shares (workload.py, content.py), a
file an entry point (entries/), a loop (loops/) and a metric (metrics/),
each found by the name its data file or BENCHMARK.json gives, the
reference (reference/), the roofline's counts (roofline.py) and the
trace's reading (tracing.py)."""
