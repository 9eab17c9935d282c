"""The port's host time choosing a kernel and making its per-plan tables
and parameter block, per request completed in the window, in ms: the
totals of the spans ``smolscale.dispatch`` (``backends/torch_ops``) and
``smolscale.tables`` (each kernel wrapper's ``_launch``, from the device's
entry through its parameter block), from the port's
``utils.timing.span_totals()``.  None where the port has no such spans."""

from portbench import spans

LAYER = ("public API, dispatch and host tables: __init__.scale, backends/torch_ops, "
         "host side of ops/*")
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "request_p95_ms"


def read(record):
    return spans.ms_per_request(record, spans.DISPATCH)
