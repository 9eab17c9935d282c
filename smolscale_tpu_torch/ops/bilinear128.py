"""The 128bpp path with a bilinear, box, COPY or ONE filter per axis, at
either internal alpha and gamma, as a CUDA kernel (``csrc/bilinear128.cu``)
and its plain PyTorch version.

Counterpart of ``smolscale_tpu.ops.pallas_128`` (``scale_fn``: 128bpp
compressed gamma, internal PREMUL16 for unassociated input and output, or
PREMUL8 past 255:1) and ``smolscale_tpu.ops.pallas_srgb`` (``scale_fn`` and
the 24bpp ``scale_fn_planes``: sRGB linear light, PREMUL16-linear or
PREMUL8-linear), three TPU tilings of one pipeline that differ only in the
unpack and pack.  The class is the union of their ``applicable`` without the
TPU's geometry and VMEM gates, and with the axis kinds those kernels leave
to the op graph: S128 storage, any internal alpha and gamma, 3- or 4-byte
pixels in and out, each axis bilinear (0h-6h), box at any ratio the planner
allows, COPY (an unchanged dimension) or ONE (a dimension of 1).  Box x box
plans with two or more outputs per axis are in the class too, but dispatch
gives them to the deep box kernel (``ops.deep``) first; a box x box plan
with one output column or row runs here.  The numbers are those of
``backends/numpy_ref`` at 128bpp masks (see the note at the top of
``csrc/bilinear128.cu``).

The kernel has three forms (see ``csrc/bilinear128.cu``), which
:func:`form` picks per plan by class: LOOP (every plan: each thread
H-filters its own tap rows from global memory); for 3-byte input, H_TILE
(each tap row of a row group H-filtered once per tile into shared memory,
``bilinear.row_windows``) where each output row reads three tap rows or
more; and ROLL (:func:`rolls`: 4-byte pixels at internal PREMUL16
compressed or P8-linear with a 0-halving bilinear V axis beside a bilinear,
COPY or ONE X axis), where each thread walks a strip of output rows for 4
columns with both tap rows' H values in registers (``bilinear.roll_shape``).

``scale_fn`` and ``scale_rows_fn`` take ``(B, H, W, nb_in)`` or
``(H, W, nb_in)`` uint8 tensors.  A tensor on the CPU goes to
:func:`bilinear128_scale_ref`; a tensor on a CUDA device launches the
kernel, or raises.  ``launches`` counts the kernel launches,
``form_launches`` those of each form.
"""

from __future__ import annotations

import ctypes

import torch

from ..formats import GammaType, StorageType
from ..plan import ScalePlan
from . import bilinear, pixels
from ._kernel import Kernel
from ._plan_cache import plan_cache
from .bilinear import (_windows, axis_kind, axis_table, deep_v, filter_scale, launch_shape,
                       roll_shape, row_windows, table_len, tile_width)
from .deep import P8_LINEAR, P16_COMPRESSED, masks, mode

launches = 0


def applicable(plan: ScalePlan) -> bool:
    return (
        plan.storage == StorageType.S128
        and plan.meta_in.n_bytes in (3, 4)
        and plan.meta_out.n_bytes in (3, 4)
    )


def tables(plan: ScalePlan):
    """The int32 tables the kernel reads, per axis ``bilinear.axis_table``;
    a V box weights its last row at 128bpp (max(frac - 1, 0))."""
    return (axis_table(plan.x, vertical=False),
            axis_table(plan.y, vertical=True, storage=StorageType.S128))


@plan_cache
def _tables(plan: ScalePlan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(t, device=device) for t in tables(plan))


def bilinear128_scale_ref(plan: ScalePlan, imgs: torch.Tensor, first: int = 0,
                          n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: output rows
    [first, first+n) (all by default), at the 128bpp masks (0xffffff, and
    0xffff after a box normalisation)."""
    n = plan.height_out - first if n is None else n
    KERNEL.check(plan, imgs, first, n)
    return filter_scale(plan, imgs, first, n, _tables(plan, imgs.device), *masks(plan))


# ----------------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------------

class _Bilinear128Params(ctypes.Structure):
    # mirrors struct Bilinear128Params in csrc/bilinear128.cu
    _fields_ = [
        (name, ctypes.c_int64)
        for name in (
            "batch", "h_in", "w_in", "h_out", "w_out", "row0", "n_rows",
            "kind_x", "kind_y", "halvings_x", "halvings_y", "len_x", "len_y",
            "span_mul_x", "span_mul_y", "mode", "tile_w", "grid_y", "grid_z",
            "nb_in", "nb_out", "alpha_ch", "unassoc_in", "unassoc_out",
            "pack24_direct",
        )
    ] + [("src", ctypes.c_int64 * 4)] + [
        (name, ctypes.c_int64) for name in ("form", "h_cells", "strip_rows")
    ]


# the forms (enum Form in csrc/bilinear128.cu); H_TILE keeps at most
# H_CELLS cells of two words (kHCells there: 32 KB)
LOOP, H_TILE, ROLL = range(3)
FORMS = {LOOP: "loop", H_TILE: "h tile", ROLL: "roll"}
H_CELLS = 4096
# the launches by form
form_launches = dict.fromkeys(FORMS, 0)


def rgb24(plan: ScalePlan) -> bool:
    """3-byte input (RGB8, BGR8: premultiplied, so planned at internal
    PREMUL8 only), the plans whose pixels the kernel unpacks through
    ``pixels.unpack24_table`` and that H_TILE takes."""
    return plan.meta_in.n_bytes == 3


def h_cells(plan: ScalePlan) -> int:
    """H_TILE's cells: the widest row group's tap rows at the tile's
    width."""
    rows = row_windows(plan)
    return int((rows[1] - rows[0]).max()) * tile_width(plan.width_out)


def rolls(plan: ScalePlan) -> bool:
    """ROLL's class: ``bilinear.rolls`` (a 0-halving bilinear V axis, whose
    tap rows only slide down, beside an X axis of kind BILINEAR, COPY or
    ONE) with 4-byte pixels in and out, at internal PREMUL16 compressed
    (unassociated pixels in and out) or P8-linear (sRGB linear light, a
    premultiplied side)."""
    return (mode(plan) in (P16_COMPRESSED, P8_LINEAR) and plan.meta_in.n_bytes == 4
            and plan.meta_out.n_bytes == 4 and bilinear.rolls(plan))


@plan_cache
def _forms(plan: ScalePlan) -> tuple:
    if rolls(plan):
        return (LOOP, ROLL)
    return (LOOP, H_TILE) if rgb24(plan) and h_cells(plan) <= H_CELLS else (LOOP,)


def forms(plan: ScalePlan) -> list[int]:
    """The forms that can run the plan: LOOP always, H_TILE for
    :func:`rgb24` plans whose tap rows fit the h tile, ROLL in its class."""
    return list(_forms(plan))


def form(plan: ScalePlan) -> int:
    """The plan's form by class: ROLL in its class (:func:`rolls`);
    H_TILE where it fits and each output row reads three tap rows or more
    (``bilinear.deep_v``: a V ladder of 1 or more halvings, a V box); else
    LOOP (COPY V, other 0h V axes, the other 4-byte plans).
    ``bilinear.cu``'s rule also sends upscales to its h tile; here LOOP was
    the faster on 6b-up.  On each timed row this is the fastest form that
    fits (PERF.md §6)."""
    if rolls(plan):
        return ROLL
    return H_TILE if H_TILE in _forms(plan) and deep_v(plan) else LOOP


@plan_cache
def _plan_params(plan: ScalePlan) -> _Bilinear128Params:
    """The parameters that follow from the plan alone (its routed form and
    h tile among them); :func:`_params` copies them per call."""
    return _Bilinear128Params(
        h_in=plan.height_in, w_in=plan.width_in, h_out=plan.height_out, w_out=plan.width_out,
        kind_x=axis_kind(plan.x), kind_y=axis_kind(plan.y),
        halvings_x=plan.x.halvings, halvings_y=plan.y.halvings,
        len_x=table_len(plan.x), len_y=table_len(plan.y),
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        mode=mode(plan), pack24_direct=int(plan.pack24_linear_direct), form=form(plan),
        h_cells=h_cells(plan) if rgb24(plan) else 0, **pixels.kernel_fields(plan),
    )


def _params(plan: ScalePlan, batch: int, first: int, n: int, sms: int = pixels.H100_SMS,
            form: int | None = None) -> _Bilinear128Params:
    """The kernel's parameters for output rows [first, first + n) of
    ``batch`` images; ``form`` is :func:`form`'s by default, else one of
    :func:`forms` (raises for one that does not fit).  LOOP and H_TILE take
    ``bilinear.launch_shape``'s grid: LOOP's row groups start at ``first``,
    H_TILE's at output row 0, as ``bilinear.row_windows`` counts them; ROLL
    takes ``bilinear.roll_shape``'s tiles, strips and grid."""
    p = _Bilinear128Params.from_buffer_copy(_plan_params(plan))
    p.batch, p.row0, p.n_rows = batch, first, n
    if form is not None:
        if form not in _forms(plan):
            raise ValueError(f"plan {plan.key}: the 128bpp kernel's {FORMS.get(form, form)} "
                             f"form does not fit (forms {[FORMS[k] for k in _forms(plan)]})")
        p.form = form
    if p.form == ROLL:
        p.tile_w, _, p.strip_rows, p.grid_y, p.grid_z = roll_shape(
            plan.width_out, first, n, batch, sms)
    else:
        p.tile_w, _, p.grid_y, p.grid_z = launch_shape(
            plan.width_out, 0 if p.form == LOOP else first, n, batch, sms)
    return p


def _step(plan: ScalePlan, batch: torch.Tensor, outs: list, device: torch.device,
          first: int, n: int, form: int | None):
    tx, ty = _tables(plan, device)
    params = _params(plan, batch.shape[0], first, n, pixels.sm_count(device), form)
    windows = _windows(plan, device) if params.form == H_TILE else None
    fold = pixels.unpack24_lut(device, plan.gamma == GammaType.SRGB_LINEAR)
    return (batch, outs[0], pixels.lut_table(device), fold, tx, ty, windows), params


def _plain(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int, form: int | None):
    return filter_scale(plan, imgs, first, n, _tables(plan, imgs.device), *masks(plan))


def _count_form(params: _Bilinear128Params) -> None:
    form_launches[params.form] += 1


KERNEL = Kernel(__name__, "128bpp", "smolscale_bilinear128_scale", 7, _Bilinear128Params,
                plain=_plain, step=_step, applicable=applicable, launched=_count_form)


def scale_rows_fn(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int,
                  form: int | None = None) -> torch.Tensor:
    """Output rows [first, first+n): (B, H, W, nb_in) or (H, W, nb_in) uint8
    -> (B, n, w, nb_out) or (n, w, nb_out) uint8, on the device where
    ``imgs`` lies.  Only those rows are computed.  ``form`` runs the kernel
    in that form (one of :func:`forms`) instead of the one :func:`form`
    picks; the bytes are the same."""
    first, n = int(first), int(n)
    KERNEL.check(plan, imgs, first, n)
    return KERNEL(plan, imgs, ((n, plan.width_out, plan.meta_out.n_bytes),), first, n, form)[0]


def scale_fn(plan: ScalePlan, imgs: torch.Tensor, form: int | None = None) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    return scale_rows_fn(plan, imgs, 0, plan.height_out, form)
