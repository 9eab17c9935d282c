"""Input plus output pixels of every request completed in the window, over
the window's seconds (the reference's pps, test.c:219-224), in millions.
Real images only: a sub-batch's padding is not counted."""

LAYER = "end to end"
UNIT = "Mpix/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(record):
    if not record.work or record.window_s <= 0:
        return None
    return sum(px for px, _ in record.work) / 1e6 / record.window_s
