"""Packet-level network simulator: torch port of `repro.sim`.

`engine.run` is the single-run entry point; `topology`, `workload` and
`config` build its inputs; `metrics.summarize` turns a run into the
paper's FCT-slowdown metrics."""
