"""Opt-in per-tick trace capture (torch port of `repro.sim.trace`).

* `spec`    — `TraceSpec` and the `layout`/`TraceLayout` column map.
* `capture` — the row builder `phases/stats.py` appends to the emit row.
"""
from .capture import capture_row  # noqa: F401
from .spec import (Channel, EMIT_BASE, TraceLayout, TraceSpec,  # noqa: F401
                   layout, split_emits)

__all__ = ["Channel", "EMIT_BASE", "TraceLayout", "TraceSpec",
           "capture_row", "layout", "split_emits"]
