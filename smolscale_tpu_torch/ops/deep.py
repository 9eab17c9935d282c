"""The deep box class: box x box plans at any storage, internal alpha and
gamma, as a CUDA kernel (``csrc/deep.cu``) and its plain PyTorch version.

Counterpart of ``smolscale_tpu.ops.pallas_deep`` (``scale_fn`` and
``scale_fn_planes``, whose three kernels -- uniform, span-centric and
chunk-centric -- are three TPU tilings of one computation).  The class is
``pallas_deep``'s minus the TPU's VMEM and chunk-shape limits: both axes
BOX, ``width_out >= 2`` and ``height_out >= 2``, 3- or 4-byte pixels in and
out, at 64 or 128bpp storage, internal PREMUL8 or PREMUL16, compressed or
linear gamma.  Dispatch gives it box x box past 64:1 with 4-byte input
pixels and an x axis past 64:1 first (integer ratios too, which the box
kernel also takes, slower: ``torch_ops.deep_first``), then the plans the
box and bilinear kernels leave: every 128bpp box plan (past 255:1) and box
x box plans at PREMUL16 or in linear light at any ratio.
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

import numpy as np
import torch

from ..formats import AlphaType, GammaType, StorageType
from ..plan import FilterType, ScalePlan
from . import pixels
from ._kernel import Kernel
from ._plan_cache import plan_cache
from .bilinear import axis_table, filter_scale
from .pixels import GRID_LIMIT, MAX_WARPS, WAVE_WARPS, pow2_ceil

launches = 0

# (internal alpha, gamma) modes, as enum Mode in csrc/pixels.cuh
P8_COMPRESSED, P8_LINEAR, P16_COMPRESSED, P16_LINEAR = range(4)


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


def tables(plan: ScalePlan) -> tuple[np.ndarray, np.ndarray]:
    """The int32 tables the kernel reads: per axis six rows of ``dim_out``
    (first index, first weight, mid start, mid length, last index, last
    weight), the V last weight at the plan's storage."""
    return (axis_table(plan.x, vertical=False),
            axis_table(plan.y, vertical=True, storage=plan.storage))


@plan_cache
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
    KERNEL.check(plan, imgs, first, n)
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
            "span_mul_x", "span_mul_y", "work_mask", "out_mask", "mode",
            "nb_in", "nb_out", "alpha_ch", "unassoc_in", "unassoc_out",
            "pack24_direct",
        )
    ] + [("src", ctypes.c_int64 * 4)] + [
        (name, ctypes.c_int64)
        for name in ("form", "units", "lanes", "cw", "chunks", "wc", "splits",
                     "rows_per_split", "grid_x", "grid_y", "grid_z")
    ]


# the kernel's pixel readers (enum Form in csrc/deep.cu)
PACKED, SHIFTED, RGB = 0, 1, 2
FORMS = {PACKED: "packed", SHIFTED: "shifted", RGB: "rgb"}
MAX_UNITS = 4          # 16-byte words per lane per span row and chunk (template W)


def form(plan: ScalePlan, address: int = 0) -> int:
    """The pixel reader for an input at byte ``address``: PACKED (4-byte
    pixels, 4-byte aligned: each word a pixel), SHIFTED (4-byte pixels off
    word boundaries) or RGB (3-byte pixels)."""
    if plan.meta_in.n_bytes == 3:
        return RGB
    return PACKED if address % 4 == 0 else SHIFTED


def row_skews(plan: ScalePlan, address: int = 0) -> tuple[int, ...]:
    """The offsets from their 16-byte aligned bases that the input rows of an
    input at byte ``address`` take (rows repeat them every 16 rows)."""
    row_bytes = plan.width_in * plan.meta_in.n_bytes
    return tuple(sorted({(address + r * row_bytes) % 16 for r in range(16)}))


@plan_cache
def span_words(plan: ScalePlan, skews: tuple[int, ...]) -> int:
    """The most aligned 16-byte words that cover a span's mid range in an
    input row whose offset from its aligned base is one of ``skews``."""
    _, _, mid, mid_len, _, _ = tables(plan)[0].reshape(6, -1).astype(np.int64)
    nb = plan.meta_in.n_bytes
    lo = np.asarray(skews)[:, None] + mid[None] * nb
    hi = lo + mid_len[None] * nb
    return int(((hi + 15) // 16 - lo // 16).max())


@plan_cache
def span_rows(plan: ScalePlan) -> int:
    """The most input rows a V span reads: first row to max(last, mid end)."""
    first, _, mid, mid_len, last, _ = tables(plan)[1].reshape(6, -1)
    return int((np.maximum(last + 1, mid + mid_len) - first).max())


def launch_shape(plan: ScalePlan, batch: int, n_rows: int | None = None, address: int = 0,
                 sms: int = pixels.H100_SMS) -> dict:
    """The kernel's work mapping for output rows [r, r + ``n_rows``) of
    ``batch`` images (all rows by default).

    ``lanes`` lanes (4-32) share a span: lane g copies the aligned 16-byte
    words g, g + lanes, ... of the span's cover in each input row, ``units``
    of them per chunk, ``chunks`` chunks; ``lanes`` is the least power of
    two that needs at most MAX_UNITS words per lane for the widest cover at
    the input's row skews (``address``).  A warp covers ``cw = 32 //
    lanes`` consecutive output columns of one output row; a block holds
    ``wc * splits`` warps (warp w: column group w % wc, split w // wc); split
    s takes the span's input rows [s * rows_per_split, (s + 1) *
    rows_per_split).  Block x covers column tile x (``wc * cw`` columns);
    grid y loops over the output rows, grid z over the images.  ``splits``
    doubles (to MAX_WARPS, keeping at least 4 rows per split) until the grid
    holds WAVE_WARPS warps per SM: plans with few outputs still fill the
    card."""
    n_rows = plan.height_out if n_rows is None else n_rows
    q = span_words(plan, row_skews(plan, address))
    lanes = min(32, max(4, pow2_ceil(-(-q // MAX_UNITS))))
    per_lane = -(-q // lanes)
    units = min(per_lane, MAX_UNITS)
    cw = 32 // lanes
    chunks = -(-per_lane // units)
    rows = span_rows(plan)
    col_warps = -(-plan.width_out // cw)
    warps = col_warps * n_rows * batch
    target = WAVE_WARPS * sms
    splits = 1
    while splits < MAX_WARPS and rows >= 8 * splits and warps * splits < target:
        splits *= 2
    wc = min(MAX_WARPS // splits, pow2_ceil(col_warps))
    return dict(
        units=units, lanes=lanes, cw=cw, chunks=chunks, wc=wc, splits=splits,
        rows_per_split=-(-rows // splits), grid_x=-(-plan.width_out // (wc * cw)),
        grid_y=min(n_rows, GRID_LIMIT), grid_z=min(batch, GRID_LIMIT),
    )


def _params(plan: ScalePlan, batch: int, first: int, n: int, address: int = 0,
            sms: int = pixels.H100_SMS) -> _DeepParams:
    mask, out_mask = masks(plan)
    return _DeepParams(
        batch=batch, h_in=plan.height_in, w_in=plan.width_in,
        h_out=plan.height_out, w_out=plan.width_out, row0=first, n_rows=n,
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        work_mask=mask, out_mask=out_mask, mode=mode(plan),
        pack24_direct=int(plan.pack24_linear_direct), **pixels.kernel_fields(plan),
        form=form(plan, address), **launch_shape(plan, batch, n, address, sms),
    )


def _step(plan: ScalePlan, batch: torch.Tensor, outs: list, device: torch.device,
          first: int, n: int):
    tx, ty = _tables(plan, device)
    params = _params(plan, batch.shape[0], first, n, batch.data_ptr(), pixels.sm_count(device))
    return (batch, outs[0], pixels.lut_table(device), tx, ty), params


KERNEL = Kernel(__name__, "deep box", "smolscale_deep_scale", 5, _DeepParams,
                plain=deep_scale_ref, step=_step, applicable=applicable)


def scale_rows_fn(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Output rows [first, first+n): (B, H, W, nb_in) or (H, W, nb_in) uint8
    -> (B, n, w, nb_out) or (n, w, nb_out) uint8, on the device where
    ``imgs`` lies.  Only those rows are computed, from the input rows their
    spans cover."""
    first, n = int(first), int(n)
    KERNEL.check(plan, imgs, first, n)
    return KERNEL(plan, imgs, ((n, plan.width_out, plan.meta_out.n_bytes),), first, n)[0]


def scale_fn(plan: ScalePlan, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    return scale_rows_fn(plan, imgs, 0, plan.height_out)
