"""Per-layer metric readers, one file each, named as in BENCHMARK.json.
Each defines ``read(ctx) -> float | None`` over the traced run's context
(``drivers/train_gnn.py::_trace_context``): ``None`` when there is
nothing to read, and the harness then leaves the metric out."""
