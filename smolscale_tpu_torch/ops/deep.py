"""The deep box class: box x box plans at any storage, internal alpha and
gamma, as a CUDA kernel (``csrc/deep.cu``) and its plain PyTorch version.

Counterpart of ``smolscale_tpu.ops.pallas_deep`` (``scale_fn`` and
``scale_fn_planes``, whose three kernels -- uniform, span-centric and
chunk-centric -- are three TPU tilings of one computation).  The class is
``pallas_deep``'s minus the TPU's VMEM and chunk-shape limits: both axes
BOX, ``width_out >= 2`` and ``height_out >= 2``, 3- or 4-byte pixels in and
out, at 64 or 128bpp storage, internal PREMUL8 or PREMUL16, compressed or
linear gamma.  Dispatch reaches it after the box and bilinear kernels, so
it computes the box axes past 64:1 at 64bpp, every 128bpp box plan (past
255:1), and box x box plans at PREMUL16 or in linear light at any ratio.
The numbers are those of ``backends/numpy_ref`` (the box walk of
``_box_axis``, the unpack and pack of every (alpha, gamma) pair); see the
note at the top of ``csrc/deep.cu``.

``scale_fn`` and ``scale_rows_fn`` take ``(B, H, W, nb_in)`` or
``(H, W, nb_in)`` uint8 tensors.  A tensor on the CPU goes to
:func:`deep_scale_ref`; a tensor on a CUDA device launches the kernel, or
raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..formats import AlphaType, GammaType, StorageType
from ..plan import FilterType, ScalePlan
from . import pixels
from .bilinear import axis_table, filter_scale

launches = 0

# (internal alpha, gamma) modes, as enum Mode in csrc/deep.cu
P8_COMPRESSED, P8_LINEAR, P16_COMPRESSED, P16_LINEAR = range(4)
MAX_WARPS = 16


def mode(plan: ScalePlan) -> int:
    return (2 * int(plan.internal_alpha == AlphaType.PREMUL16)
            + int(plan.gamma == GammaType.SRGB_LINEAR))


def applicable(plan: ScalePlan) -> bool:
    return (
        plan.x.filter == FilterType.BOX
        and plan.y.filter == FilterType.BOX
        and plan.meta_in.n_bytes in (3, 4)
        and plan.meta_out.n_bytes in (3, 4)
        and plan.width_out >= 2
        and plan.height_out >= 2
    )


def masks(plan: ScalePlan) -> tuple[int, int]:
    """(working mask, normalised mask): 0xff and 0xff at 64bpp, 0xffffff and
    0xffff at 128bpp (numpy_ref._scale_span, generic.c:1231-1261)."""
    return plan.working_mask, 0xFF if plan.storage == StorageType.S64 else 0xFFFF


def _check(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> None:
    if not applicable(plan):
        raise ValueError(f"plan {plan.key} is outside the deep box kernel's class")
    pixels.check_input(plan, imgs)
    if first < 0 or n < 1 or first + n > plan.height_out:
        raise ValueError(
            f"row range [{first}, {first + n}) outside [0, {plan.height_out})"
        )


def tables(plan: ScalePlan) -> tuple[np.ndarray, np.ndarray]:
    """The int32 tables the kernel reads: per axis six rows of ``dim_out``
    (first index, first weight, mid start, mid length, last index, last
    weight), the V last weight at the plan's storage."""
    return (axis_table(plan.x, vertical=False),
            axis_table(plan.y, vertical=True, storage=plan.storage))


@functools.cache
def _tables(plan: ScalePlan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(t, device=device) for t in tables(plan))


# ----------------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------------

def deep_scale_ref(plan: ScalePlan, imgs: torch.Tensor, first: int = 0,
                   n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: output rows
    [first, first+n) (all by default)."""
    n = plan.height_out - first if n is None else n
    _check(plan, imgs, first, n)
    return filter_scale(plan, imgs, first, n, _tables(plan, imgs.device), *masks(plan))


# ----------------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------------

class _DeepParams(ctypes.Structure):
    # mirrors struct DeepParams in csrc/deep.cu
    _fields_ = [
        (name, ctypes.c_int64)
        for name in (
            "batch", "h_in", "w_in", "h_out", "w_out", "row0", "n_rows",
            "span_mul_x", "span_mul_y", "work_mask", "out_mask", "mode", "warps",
            "nb_in", "nb_out", "alpha_ch", "unassoc_in", "unassoc_out",
            "pack24_direct",
        )
    ] + [("src", ctypes.c_int64 * 4)]


@functools.cache
def warps(plan: ScalePlan) -> int:
    """Warps per block: one input row each at a time, up to ``MAX_WARPS``,
    no more than the tallest span has rows."""
    first_idx, _, mid_start, mid_len, last_idx, _ = tables(plan)[1].reshape(6, -1)
    rows = np.maximum(last_idx, mid_start + mid_len - 1) - first_idx + 1
    return int(min(MAX_WARPS, max(1, rows.max())))


def _params(plan: ScalePlan, batch: int, first: int, n: int) -> _DeepParams:
    f = pixels.kernel_fields(plan)
    f["src"] = (ctypes.c_int64 * 4)(*f["src"])
    mask, out_mask = masks(plan)
    return _DeepParams(
        batch=batch, h_in=plan.height_in, w_in=plan.width_in,
        h_out=plan.height_out, w_out=plan.width_out, row0=first, n_rows=n,
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        work_mask=mask, out_mask=out_mask, mode=mode(plan), warps=warps(plan),
        pack24_direct=int(plan.pack24_linear_direct), **f,
    )


@functools.cache
def _entry():
    from ._build import library

    fn = library().smolscale_deep_scale
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(_DeepParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> torch.Tensor:
    global launches
    if not imgs.is_contiguous():
        raise ValueError("the deep box kernel takes contiguous input")
    batch = imgs if imgs.dim() == 4 else imgs[None]
    out = torch.empty(
        (batch.shape[0], n, plan.width_out, plan.meta_out.n_bytes),
        dtype=torch.uint8, device=imgs.device,
    )
    with torch.cuda.device(imgs.device):
        lut = pixels.lut_table(imgs.device)
        tx, ty = _tables(plan, imgs.device)
        params = _params(plan, batch.shape[0], first, n)
        err = _entry()(
            batch.data_ptr(), out.data_ptr(), lut.data_ptr(), tx.data_ptr(), ty.data_ptr(),
            ctypes.byref(params), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"deep box kernel launch failed: CUDA error {err}")
    launches += 1
    return out if imgs.dim() == 4 else out[0]


def scale_rows_fn(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Output rows [first, first+n): (B, H, W, nb_in) or (H, W, nb_in) uint8
    -> (B, n, w, nb_out) or (n, w, nb_out) uint8, on the device where
    ``imgs`` lies.  Only those rows are computed, from the input rows their
    spans cover."""
    first, n = int(first), int(n)
    _check(plan, imgs, first, n)
    if imgs.device.type == "cpu":
        return deep_scale_ref(plan, imgs, first, n)
    if imgs.device.type == "cuda":
        return _launch(plan, imgs, first, n)
    raise ValueError(f"no deep box kernel for device {imgs.device}")


def scale_fn(plan: ScalePlan, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    return scale_rows_fn(plan, imgs, 0, plan.height_out)
