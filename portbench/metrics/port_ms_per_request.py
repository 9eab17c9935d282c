"""The port's host time inside its public calls, per request completed in
the window, in ms: the totals of the port's outermost spans
(``smolscale.scale``, ``smolscale.scale_rows``, ``smolscale.pyramid``), as
its ``utils.timing.span_totals()`` gives them.  The in-program counterpart
of ``enqueue_ms_per_call``, taken with the profiler on: the spans are on
only while a profiler collects, which in a run is its traced window alone.
None where the port has no such spans (the control, or a port without
them)."""

from portbench import spans

LAYER = ("public API, dispatch and host tables: __init__.scale, backends/torch_ops, "
         "host side of ops/*")
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "request_p95_ms"


def read(record):
    return spans.ms_per_request(record, spans.OUTERMOST)
