"""Dispatch from a plan to the kernel that computes it.

Counterpart of ``smolscale_tpu.backends.xla`` (``scale_fn``,
``_scale_fn_impl``, ``scale_rows``).  Whole images try the integer-ratio box
kernel (``ops.box``) first, then the general 64bpp kernel
(``ops.bilinear``), then the deep box kernel (``ops.deep``), then the 128bpp
kernel (``ops.bilinear128``), in the order of ``xla._scale_fn_impl``, but
for box x box past 64:1 with 4-byte input pixels and an x axis past 64:1,
which goes to the deep box kernel first (:func:`deep_first`); row
ranges go to the general kernel's row form for every plan of its class,
integer box included, as ``xla._pallas_rows_ok`` does, then to the deep box
kernel's and the 128bpp kernel's for theirs.  Together the classes hold
every plan the planner makes: 64bpp plans go to the general kernel, or to
the deep box kernel when both axes are boxes with two or more outputs and
one is past 64:1; 128bpp plans go to the deep box kernel or the 128bpp
kernel.  A plan that reaches no kernel raises ``NotImplementedError``: it
would be a bug, and no plain version stands in for a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _plan_cache, bilinear, bilinear128, box, deep
from ..plan import ScalePlan
from ..utils.timing import span

WHOLE_KERNELS = (box, bilinear, deep, bilinear128)
ROW_KERNELS = (bilinear, deep, bilinear128)
_DISPATCH = span("smolscale.dispatch")


def transient_plans():
    """A scope whose plans the kernels forget when it closes: what each
    kernel caches for a plan first seen inside it (index tables on a
    device, launch-shape sums) is dropped on exit, and what was cached
    before stays.  For a caller that runs many plans once each."""
    return _plan_cache.transient()


def numpy_device(device=None) -> torch.device:
    """Where a numpy input runs: ``device``, by default the card.  With no
    CUDA device the default raises: the CPU runs only when ``device="cpu"``
    says so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a numpy input runs on the card by default, and no CUDA device is "
                "available; pass device='cpu' to run the plain versions"
            )
        device = "cuda"
    return torch.device(device)


def as_tensor(img, device=None) -> torch.Tensor:
    """The input of a public entry point as a tensor on the device it runs
    on.  A tensor runs where it lies (``device``, if given, must name that
    device); a numpy array goes to :func:`numpy_device`."""
    if isinstance(img, torch.Tensor):
        want = torch.device(device) if device is not None else img.device
        if img.device.type != want.type or want.index not in (None, img.device.index):
            raise ValueError(
                f"input lies on {img.device} but device={device!r} was given; "
                "move it explicitly"
            )
        return img
    return torch.from_numpy(np.ascontiguousarray(img)).to(numpy_device(device))


def _not_ported(plan: ScalePlan) -> NotImplementedError:
    return NotImplementedError(
        f"plan {plan.key} reached no kernel; every plan the planner makes "
        f"should reach one, so this is a bug"
    )


def deep_first(plan: ScalePlan) -> bool:
    """Whether the deep box kernel takes ``plan`` before the box kernel: box
    x box past 64:1 (``bilinear.deep_box``) with 4-byte input pixels and an
    x axis past 64:1, whose spans of 256 bytes and more its 16-byte covers
    read faster than the box kernel's split warps.  RGB24 input and a
    narrow x box beside a deep y box stay on the box kernel, which takes
    them faster (PERF.md §6: 4096^2 -> 32^2 and -> 32 x 256 faster on the
    deep box kernel; RGB24 -> 32^2, -> 256 x 32 and 3840 x 4096 -> 384 x 32
    faster on the box kernel)."""
    return (
        bilinear.deep_box(plan)
        and deep.applicable(plan)
        and plan.meta_in.n_bytes == 4
        and plan.x.dim_in > bilinear.DEEP_BOX_RATIO * plan.x.dim_out
    )


def whole_kernel(plan: ScalePlan):
    """The kernel module that computes ``plan`` whole: the deep box kernel
    where :func:`deep_first` holds, else the first of ``WHOLE_KERNELS``
    whose class holds it."""
    if deep_first(plan):
        return deep
    for kernel in WHOLE_KERNELS:
        if kernel.applicable(plan):
            return kernel
    raise _not_ported(plan)


def row_kernel(plan: ScalePlan):
    """The kernel module that computes row ranges of ``plan``: the first
    of ``ROW_KERNELS`` whose class holds it."""
    for kernel in ROW_KERNELS:
        if kernel.applicable(plan):
            return kernel
    raise _not_ported(plan)


def _scale_fn_impl(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    with _DISPATCH:
        kernel = whole_kernel(plan)
    return kernel.scale_fn(plan, img.contiguous())


def scale_fn(plan: ScalePlan, img: torch.Tensor, post_fn=None) -> torch.Tensor:
    """(..., H, W, nb_in) uint8 -> (..., h, w, nb_out) uint8 on the device
    where ``img`` lies; ``post_fn`` is applied to the output tensor."""
    out = _scale_fn_impl(plan, img)
    return post_fn(out) if post_fn is not None else out


def scale_rows_fn(plan: ScalePlan, img: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Output rows [first, first+n) of ``scale_fn``; only those rows are
    computed."""
    with _DISPATCH:
        kernel = row_kernel(plan)
    return kernel.scale_rows_fn(plan, img.contiguous(), first, n)
