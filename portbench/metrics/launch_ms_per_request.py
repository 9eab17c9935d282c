"""The port's host time allocating the outputs and launching its kernels,
per request completed in the window, in ms: the totals of the spans
``smolscale.alloc`` and ``smolscale.launch`` in each kernel wrapper's
``_launch`` (``ops/*.py``), from the port's ``utils.timing.span_totals()``.
None where the port has no such spans, or launched nothing (the plain
versions on the CPU)."""

from portbench import spans

LAYER = "kernel wrappers: ops/*.py"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "request_p95_ms"


def read(record):
    return spans.ms_per_request(record, spans.LAUNCH)
