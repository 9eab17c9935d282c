"""Dispatch from a plan to the kernel that computes it.

Counterpart of ``smolscale_tpu.backends.xla`` (``scale_fn``,
``_scale_fn_impl``, ``scale_rows``).  Whole images try the integer-ratio box
kernel (``ops.box``) first, then the general 64bpp kernel
(``ops.bilinear``), in the order of ``xla._scale_fn_impl``; row ranges go to
the general kernel's row form for every plan of its class, integer box
included, as ``xla._pallas_rows_ok`` does.  Any other plan raises
``NotImplementedError`` naming the ROADMAP item that ports its kernel.
There is no op-graph fallback yet (ROADMAP A3): a plan runs on a kernel or
not at all.
"""

from __future__ import annotations

import torch

from ..formats import AlphaType, GammaType
from ..ops import bilinear, box
from ..plan import ScalePlan


def _roadmap_item(plan: ScalePlan) -> str:
    """The ROADMAP item that ports the kernel for a plan outside the ported
    classes: sRGB linear light (B6), internal PREMUL16 (B5), else a box
    axis past 64:1, or past 255:1 at 128bpp (B3).  The TPU kernels' tiling
    limits play no part."""
    if plan.gamma == GammaType.SRGB_LINEAR:
        return "B6 (pallas_srgb)"
    if plan.internal_alpha == AlphaType.PREMUL16:
        return "B5 (pallas_128)"
    return "B3 (pallas_deep)"


def _not_ported(plan: ScalePlan) -> NotImplementedError:
    return NotImplementedError(
        f"plan {plan.key} is outside the ported classes (integer-ratio box "
        f"and the general 64bpp pipeline); ROADMAP item {_roadmap_item(plan)} "
        "ports its kernel"
    )


def _scale_fn_impl(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    if box.applicable(plan):
        return box.scale_fn(plan, img.contiguous())
    if bilinear.applicable(plan):
        return bilinear.scale_fn(plan, img.contiguous())
    raise _not_ported(plan)


def scale_fn(plan: ScalePlan, img: torch.Tensor, post_fn=None) -> torch.Tensor:
    """(..., H, W, nb_in) uint8 -> (..., h, w, nb_out) uint8 on the device
    where ``img`` lies; ``post_fn`` is applied to the output tensor."""
    out = _scale_fn_impl(plan, img)
    return post_fn(out) if post_fn is not None else out


def scale_rows_fn(plan: ScalePlan, img: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Output rows [first, first+n) of ``scale_fn``; only those rows are
    computed."""
    if not bilinear.applicable(plan):
        raise _not_ported(plan)
    return bilinear.scale_rows_fn(plan, img.contiguous(), first, n)
