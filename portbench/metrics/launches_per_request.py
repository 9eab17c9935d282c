"""Kernel launches per request: the change of the port's wrappers' own
``launches`` counters (``ops.box.launches`` ... ``ops.pyramid.launches``)
over the window, over the requests completed in it.  An exact count."""

LAYER = "kernel wrappers: ops/*.py"
UNIT = "launches"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "mpix_per_s"


def read(record):
    if not record.launches or not record.spans:
        return None
    return record.launches / len(record.spans)
