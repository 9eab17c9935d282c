"""``csrc/deep.cu``'s share of its roofline in the traced window: the bytes
the port's ``deep`` wrapper was handed and returned (its ``deep`` counter:
each image read once and written once, from the shapes), at the HBM peak
(3.35 TB/s, H100 SXM data sheet, at 700 W), over the summed device time of
every ``deep_kernel`` instance.  None where the kernel did not run or the
port has no counters."""

from portbench import counters

LAYER = "kernels: csrc/*.cu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "mpix_per_s"


def read(record):
    nbytes = counters.bytes_of("deep")
    kernel_s = counters.device_s(record, "deep_kernel")
    if not nbytes or kernel_s <= 0:
        return None
    return 100.0 * nbytes / record.peak_bytes_per_s / kernel_s
