"""The share of the measured window in which no kernel, copy or set ran on
the card, from the profiler's trace: 100 * (1 - busy / window), the busy
time being the union of the device's events inside the window."""

LAYER = "device: H100 HBM3"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "mpix_per_s"


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0 or t.n_device_events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
