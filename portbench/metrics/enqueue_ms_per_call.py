"""The host's time to enqueue one call of the entry point: the benchmark's
own host-clock span around the call, which holds no synchronise, averaged
over the calls, in ms (``chip_smoke.py`` phase 6's pattern).  Taken with
the profiler off: in a traced run, over its untraced stretch of whole
passes of the traffic after the window, so the profiler's own cost per
host event is not in it."""

LAYER = ("public API, dispatch and host tables: __init__.scale, backends/torch_ops, "
         "host side of ops/*")
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "request_p95_ms"


def read(record):
    spans = record.plain_spans
    if not spans:
        return None
    return 1e3 * sum(called - start for start, called, _ in spans) / len(spans)
