"""The requests' least time over the device time of the kernels they ran,
in the traced window: each completed request's input bytes read once and
output bytes written once, at the HBM peak (3.35 TB/s, H100 SXM data
sheet, at 700 W), summed, over the summed duration of every kernel in the
window.  Counted per request, from its shapes, so it reads the same work
whatever kernels implement it."""

LAYER = "kernels: csrc/*.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "mpix_per_s"


def read(record):
    t = record.trace
    if t is None or t.kernel_s <= 0 or not record.work:
        return None
    least_s = sum(nbytes for _, nbytes in record.work) / record.peak_bytes_per_s
    return 100.0 * least_s / t.kernel_s
