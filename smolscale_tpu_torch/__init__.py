"""smolscale-tpu on PyTorch and CUDA: the port of ``smolscale_tpu`` to an
NVIDIA Hopper GPU.

Same planner, formats and lookup tables as ``smolscale_tpu`` (whose JAX
package stays the reference), with hand-written CUDA kernels in place of the
Pallas TPU kernels.  Every plan the planner makes runs on one of them:
the integer-ratio box class (the headline batched 4096^2 -> 256^2
thumbnail workload) on a kernel of its own; every other plan at 8-bit
premultiplied working precision (64bpp storage, compressed gamma) -- per
axis a bilinear halving ladder, a box of any ratio up to 255:1, COPY or ONE
-- on the general kernel; box x box plans with at least two output pixels
per axis, at 64 or 128bpp, internal PREMUL8 or PREMUL16 (unassociated in
and out), compressed gamma or sRGB linear light, on the deep box kernel
(4096^2 -> 16^2 and other ratios past 64:1); every other 128bpp plan, each
axis bilinear, box, COPY or ONE, at either internal alpha and gamma, on the
128bpp kernel (PREMUL16 and linear-light ladders, 1:1 format conversions);
the row API over the last three classes; and the thumbnail-pyramid farm
(``make_pyramid_fn``, ``scale_pyramid_mixed``), whose power-of-two level
sets read each image once on a kernel of their own.

    plan = ScalePlan(4096, 4096, 256, 256, PixelType.RGBA8_PREMULTIPLIED,
                     PixelType.RGBA8_PREMULTIPLIED)
    thumbs = scale(plan, imgs)        # imgs: (B, 4096, 4096, 4) uint8 on cuda
    for first, rows in scale_streamed(plan, imgs, n_chunks=16):
        ...                           # output rows [first, first + len) as they finish
    levels = make_pyramid_fn(512, 512, PixelType.RGBA8_PREMULTIPLIED)(imgs512)

Tensors are computed on the device where they lie: a CUDA tensor runs the
CUDA kernel, a CPU tensor the kernel's plain PyTorch version.  A numpy input
runs on the card unless ``device`` says otherwise; with no card it raises
rather than run on the CPU, which only ``device="cpu"`` selects.
"""

from __future__ import annotations

import torch

from .backends import torch_ops
from .formats import AlphaType, GammaType, PixelType, StorageType, get_meta
from .plan import FilterType, ScalePlan, plan_from_reference
from .pyramid import make_pyramid_fn, scale_pyramid_mixed
from .utils.timing import span as _span

_SCALE, _SCALE_ROWS = _span("smolscale.scale"), _span("smolscale.scale_rows")

__all__ = [
    "AlphaType",
    "FilterType",
    "GammaType",
    "PixelType",
    "ScalePlan",
    "StorageType",
    "get_meta",
    "make_pyramid_fn",
    "plan_from_reference",
    "scale",
    "scale_pyramid_mixed",
    "scale_rows",
    "scale_simple",
    "scale_streamed",
]


def scale(plan: ScalePlan, img, post_fn=None, out=None, device=None) -> torch.Tensor:
    """Scale one image ``(H, W, nb_in)`` or a batch ``(B, H, W, nb_in)`` of
    uint8 pixels according to ``plan``; returns a uint8 tensor on the same
    device.

    ``post_fn`` is the analogue of the reference's per-output-row callback
    (SmolPostRowFunc, smolscale.h:37-39): it receives the whole output
    tensor (rows on its third axis from the end) and its result is
    returned.  ``out``, if given, is a uint8 tensor that the result is
    copied into and that is returned.
    """
    with _SCALE:
        x = torch_ops.as_tensor(img, device)
        res = torch_ops.scale_fn(plan, x, post_fn=post_fn)
        if out is not None:
            out.copy_(res)
            return out
        return res


def scale_rows(plan: ScalePlan, img, first_out_row: int, n_out_rows: int, out=None,
               device=None) -> torch.Tensor:
    """Output rows [first, first+n) of :func:`scale`, computing only those
    rows: the row-batch API (smol_scale_batch_full analogue,
    smolscale.c:998-1008).  ``out``, if given, is a uint8 tensor that the
    rows are copied into and that is returned."""
    with _SCALE_ROWS:
        x = torch_ops.as_tensor(img, device)
        res = torch_ops.scale_rows_fn(plan, x, int(first_out_row), int(n_out_rows))
        if out is not None:
            out.copy_(res)
            return out
        return res


def scale_streamed(plan: ScalePlan, img, n_chunks: int = 8, post_fn=None, device=None):
    """Generator yielding ``(first_row, rows)`` chunks top to bottom, each
    ``ceil(height_out / n_chunks)`` rows (the last may be shorter): the
    incremental-consumption pattern of smol_scale_batch + SmolPostRowFunc
    (smolscale.h:37-39, 74-76).  ``post_fn``, if given, is applied to each
    chunk.  Each chunk is one launch on the card; they queue on the
    current stream."""
    x = torch_ops.as_tensor(img, device)
    h = plan.height_out
    n_chunks = max(1, min(n_chunks, h))
    step = -(-h // n_chunks)
    for first in range(0, h, step):
        rows = scale_rows(plan, x, first, min(step, h - first))
        yield first, post_fn(rows) if post_fn is not None else rows


def scale_simple(
    img,
    pixel_type_in: PixelType,
    width_out: int,
    height_out: int,
    pixel_type_out: PixelType | None = None,
    with_srgb: bool = False,
    device=None,
) -> torch.Tensor:
    """One-shot scale (smol_scale_simple analogue, smolscale.c:957-985)."""
    if pixel_type_out is None:
        pixel_type_out = pixel_type_in
    h_in, w_in = img.shape[-3], img.shape[-2]
    plan = ScalePlan(
        w_in, h_in, width_out, height_out, pixel_type_in, pixel_type_out, with_srgb
    )
    return scale(plan, img, device=device)
