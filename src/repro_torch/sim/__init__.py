"""Packet-level network simulator: torch port of `repro.sim`.

`engine.run` is the single-run entry point and `sweep.run_grid` /
`sweep.run_batch` run a grid of cases as batched simulations (the lanes
laid side by side as one larger fabric); `topology`, `workload` and
`config` build their inputs; `metrics.summarize` turns a run into the
paper's FCT-slowdown metrics."""
