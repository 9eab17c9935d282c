"""Dispatch from a plan to the kernel that computes it.

Counterpart of ``smolscale_tpu.backends.xla`` (``scale_fn``,
``_scale_fn_impl``, ``scale_rows``).  Whole images try the integer-ratio box
kernel (``ops.box``) first, then the general 64bpp kernel
(``ops.bilinear``), then the deep box kernel (``ops.deep``), in the order of
``xla._scale_fn_impl``; row ranges go to the general kernel's row form for
every plan of its class, integer box included, as ``xla._pallas_rows_ok``
does, and to the deep box kernel's for its class.  Any other plan raises
``NotImplementedError`` naming the ROADMAP item that ports it.  There is no
op-graph fallback yet (ROADMAP A3): a plan runs on a kernel or not at all.
"""

from __future__ import annotations

import torch

from ..formats import GammaType, StorageType
from ..ops import bilinear, box, deep
from ..plan import FilterType, ScalePlan


def _roadmap_item(plan: ScalePlan) -> str:
    """The ROADMAP item that ports a plan outside the ported classes.  At
    128bpp with a bilinear axis and no COPY or ONE axis, the TPU's sRGB
    linear-light kernel (B6) or its 128bpp compressed kernel (B5), by the
    plan's gamma.  Any other plan (a COPY or ONE axis at 128bpp, a box axis
    with one output, a 64bpp box past 64:1 beside a bilinear axis) waits
    for the op-graph fallback (A3)."""
    axes = (plan.x.filter, plan.y.filter)
    if plan.storage == StorageType.S128 and all(
        f.is_bilinear or f == FilterType.BOX for f in axes
    ) and any(f.is_bilinear for f in axes):
        return "B6 (pallas_srgb)" if plan.gamma == GammaType.SRGB_LINEAR else "B5 (pallas_128)"
    return "A3 (op-graph fallback)"


def _not_ported(plan: ScalePlan) -> NotImplementedError:
    return NotImplementedError(
        f"plan {plan.key} is outside the ported classes (integer-ratio box, "
        f"the general 64bpp pipeline and box x box); ROADMAP item "
        f"{_roadmap_item(plan)} ports it"
    )


def _scale_fn_impl(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    for kernel in (box, bilinear, deep):
        if kernel.applicable(plan):
            return kernel.scale_fn(plan, img.contiguous())
    raise _not_ported(plan)


def scale_fn(plan: ScalePlan, img: torch.Tensor, post_fn=None) -> torch.Tensor:
    """(..., H, W, nb_in) uint8 -> (..., h, w, nb_out) uint8 on the device
    where ``img`` lies; ``post_fn`` is applied to the output tensor."""
    out = _scale_fn_impl(plan, img)
    return post_fn(out) if post_fn is not None else out


def scale_rows_fn(plan: ScalePlan, img: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Output rows [first, first+n) of ``scale_fn``; only those rows are
    computed."""
    for kernel in (bilinear, deep):
        if kernel.applicable(plan):
            return kernel.scale_rows_fn(plan, img.contiguous(), first, n)
    raise _not_ported(plan)
