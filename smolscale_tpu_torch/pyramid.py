"""Thumbnail-farm API: batched multi-resolution pyramids.

Counterpart of ``smolscale_tpu.pyramid`` (``make_pyramid_fn``,
``scale_pyramid_mixed``).  A plan set in the class of ``ops.pyramid`` (two
or more power-of-two levels of one source, 64bpp PREMUL8) runs as one launch
of the pyramid kernel, which reads each image once; any other set runs level
by level through ``backends.torch_ops.scale_fn``, as the JAX package's
``_pyramid_jit`` does.  Each level is scaled from the source, as repeated
smol_scale_simple calls would be: cascading levels would change the bytes.

Mixed fleets are grouped by (shape, pixel type) and streamed through
sub-batches that a pinned host ring of two buffers feeds to the card.  With
a ``mesh`` (``parallel.DeviceMesh``), each batch is split over the devices
of ``axis``, as ``parallel.make_batched_scale`` splits one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .backends import torch_ops
from .formats import PixelType
from .ops import pyramid as pyramid_op
from .parallel.sharding import split_batch
from .plan import ScalePlan
from .utils.timing import span

_PYRAMID = span("smolscale.pyramid")
# the farm's host feed
_GROUP, _STACK = span("smolscale.farm.group"), span("smolscale.farm.stack")
_UPLOAD, _DOWNLOAD = span("smolscale.farm.upload"), span("smolscale.farm.download")


def make_pyramid_fn(
    width_in: int,
    height_in: int,
    pixel_type_in: PixelType,
    sizes: Sequence[int] = (64, 128, 256),
    pixel_type_out: PixelType | None = None,
    with_srgb: bool = False,
    device=None,
    mesh=None,
    axis: str = "dp",
):
    """A function ``(B, H, W, nb) uint8 -> tuple of (B, s, s, nb_out) uint8``
    tensors, one per size (an unbatched ``(H, W, nb)`` image gives unbatched
    levels).  A tensor runs where it lies; a numpy batch runs on ``device``,
    by default the card.  With ``mesh``, the batch (B divisible by the size
    of ``axis``) is split over the devices of ``axis``, each slice runs on
    its device, and the levels are gathered on the mesh's first device."""
    if pixel_type_out is None:
        pixel_type_out = pixel_type_in
    plans = tuple(
        ScalePlan(width_in, height_in, s, s, pixel_type_in, pixel_type_out, with_srgb)
        for s in sizes
    )
    fused = pyramid_op.applicable(plans)

    def levels(imgs) -> tuple[torch.Tensor, ...]:
        x = torch_ops.as_tensor(imgs, device)
        if fused:
            return pyramid_op.pyramid_fn(plans, x.contiguous())
        return tuple(torch_ops.scale_fn(p, x) for p in plans)

    run = levels if mesh is None else split_batch(levels, mesh, axis)

    def fn(imgs) -> tuple[torch.Tensor, ...]:
        with _PYRAMID:
            return run(imgs)

    return fn


class _PinnedRing:
    """Two pinned host buffers that feed sub-batches to the card: sub-batch k
    is stacked into buffer k % 2 once the copy that last read that buffer
    has finished, then copied on the current stream without waiting."""

    def __init__(self, nbytes: int, device: torch.device):
        self.device = device
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.copied = [None, None]
        self.k = 0

    def upload(self, images: list) -> torch.Tensor:
        with _STACK:
            slot = self.k % 2
            self.k += 1
            if self.copied[slot] is not None:
                self.copied[slot].synchronize()
            shape = (len(images), *images[0].shape)
            host = self.bufs[slot][: int(np.prod(shape))].view(shape)
            stage = host.numpy()
            for i, img in enumerate(images):
                stage[i] = img
        with _UPLOAD:
            dev = torch.empty(shape, dtype=torch.uint8, device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.copied[slot] = event
        return dev


def scale_pyramid_mixed(images, pixel_types, sizes=(64, 128, 256), max_batch_bytes=None,
                        device=None, pixel_type_out: PixelType | None = None,
                        with_srgb: bool = False, mesh=None, axis: str = "dp"):
    """Pyramids of a mixed-format, mixed-shape fleet of ``(H, W, nb)`` uint8
    numpy images: grouped by (shape, pixel type), one batched call per
    sub-batch, per-image tuples of numpy levels in input order.
    ``pixel_type_out`` (by default each group's own type) and ``with_srgb``
    go to :func:`make_pyramid_fn` for every group.

    ``max_batch_bytes`` bounds each sub-batch's input.  A group's remainder
    sub-batch is padded to the group's sub-batch size by repeating its last
    image, so every sub-batch of a group has one shape.  Every sub-batch is
    dispatched before any result is fetched, so the copies and kernels of
    different sub-batches queue back to back.  The fleet runs on ``device``,
    by default the card.

    With ``mesh``, every sub-batch is split over the devices of ``axis``
    (:func:`make_pyramid_fn`'s ``mesh``): it is padded in the same way to a
    multiple of the axis's size (so it may pass ``max_batch_bytes`` by fewer
    images than that size), uploaded to the mesh's first device and copied
    from there to the others (a pinned ring per device was no faster on
    four H100s, PERF.md §6).
    """
    dev = torch_ops.numpy_device(device) if mesh is None else mesh.first
    n_dev = 1 if mesh is None else mesh.shape[axis]
    with _GROUP:  # grouping, the pinned ring
        groups: dict = {}
        for i, (img, pt) in enumerate(zip(images, pixel_types)):
            groups.setdefault((img.shape, int(pt)), []).append(i)
        subs = []
        for (shape, pt), idxs in groups.items():
            cap = len(idxs)
            if max_batch_bytes is not None:
                cap = max(1, min(cap, int(max_batch_bytes) // int(np.prod(shape))))
            cap = -(-cap // n_dev) * n_dev
            fn = make_pyramid_fn(shape[1], shape[0], PixelType(pt), sizes=sizes,
                                 pixel_type_out=pixel_type_out, with_srgb=with_srgb,
                                 device=None if mesh is not None else dev, mesh=mesh, axis=axis)
            for c0 in range(0, len(idxs), cap):
                sub = idxs[c0 : c0 + cap]
                stack = [images[i] for i in sub]
                # pad the remainder sub-batch, and any sub-batch to split evenly
                size = cap if c0 > 0 else -(-len(sub) // n_dev) * n_dev
                stack += [stack[-1]] * (size - len(sub))
                subs.append((fn, sub, stack))
        ring = None
        if dev.type == "cuda" and subs:
            ring = _PinnedRing(max(len(s) * s[0].nbytes for _, _, s in subs), dev)
    pending = []
    for fn, sub, stack in subs:
        if ring is not None:
            x = ring.upload(stack)
        else:
            with _STACK:
                x = torch.from_numpy(np.stack(stack))
        pending.append((sub, fn(x)))
    results = [None] * len(images)
    with _DOWNLOAD:
        for sub, outs in pending:
            outs = [o.cpu().numpy() for o in outs]
            for k, i in enumerate(sub):
                results[i] = tuple(o[k] for o in outs)
    return results
