"""The 95th percentile, over every request completed in the window, of the
time from the request's start to its outputs being ready for the caller
(a synchronise on the card, or the numpy levels in hand), in ms."""

from portbench.stats import percentile

LAYER = "end to end"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(record):
    return percentile([(ready - start) * 1e3 for start, _, ready in record.spans], 95)
