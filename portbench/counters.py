"""The port's byte counters and the device time of one kernel, as the
per-kernel rooflines read them.

Each kernel wrapper of the port counts, under its module's name
(``bilinear``, ``bilinear128``, ...), the bytes of the images it is handed
and of those it returns, from their shapes; the port's
``utils.timing.counter_totals()`` gives the totals.  The counters are on only while a
profiler collects, which in a run is its traced window alone, so the totals
of a run's process are its window's.  A port without counters, or the
control, gives nothing to read.
"""

from __future__ import annotations

import sys

MODULE = "smolscale_tpu_torch.utils.timing"


def bytes_of(name: str) -> int | None:
    """The loaded port's count ``name``; None if it has no counters or
    counted nothing there."""
    read = getattr(sys.modules.get(MODULE), "counter_totals", None)
    return (read() if callable(read) else {}).get(name) or None


def device_s(record, kernel: str) -> float:
    """The window's summed device time of every instance of ``kernel``
    (``bilinear_kernel`` holds ``bilinear_kernel<2, 2, true, 0>``), from the
    trace's operations by name; 0 without a trace."""
    t = record.trace
    if t is None:
        return 0.0
    return sum(s for name, s in t.device_ops if name == kernel or name.startswith(kernel + "<"))
