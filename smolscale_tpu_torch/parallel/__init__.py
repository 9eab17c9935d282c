"""Splitting work over a device list: batches and output rows
(counterpart of ``smolscale_tpu.parallel``)."""

from .sharding import (  # noqa: F401
    DeviceMesh,
    default_mesh,
    dryrun_multichip,
    make_batched_scale,
    make_row_sharded_scale,
    make_sharded_batch_step,
)
