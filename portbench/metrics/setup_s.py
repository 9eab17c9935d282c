"""Seconds from the process's start to the first timed request: imports,
the kernel library's load (and build, in a checkout's first run), the
inputs on the card, the warm-up of the cell's own plans."""

LAYER = "end to end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(record):
    return record.setup_s
