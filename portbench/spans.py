"""The port's host spans, as the per-layer metrics read them: the totals
that the loaded port's ``utils.timing.span_totals()`` gives, by span name.

The spans are on only while a profiler collects, which in a run is its
traced window alone, so the totals of a run's process are its window's.
A port without spans, or the control, gives nothing to read.
"""

from __future__ import annotations

import sys

MODULE = "smolscale_tpu_torch.utils.timing"
OUTERMOST = ("smolscale.scale", "smolscale.scale_rows", "smolscale.pyramid")
DISPATCH = ("smolscale.dispatch", "smolscale.tables")
LAUNCH = ("smolscale.alloc", "smolscale.launch")


def totals() -> dict | None:
    """The loaded port's span totals; None if it has none."""
    read = getattr(sys.modules.get(MODULE), "span_totals", None)
    return read() if callable(read) else None


def ms_per_request(record, names) -> float | None:
    """The spans ``names``' summed time, in ms, over the requests completed
    in the window; None where none of them was closed."""
    held = [t for name, t in (totals() or {}).items() if name in names and t["count"]]
    if not held or not record.spans:
        return None
    return sum(t["total_ns"] for t in held) / 1e6 / len(record.spans)
