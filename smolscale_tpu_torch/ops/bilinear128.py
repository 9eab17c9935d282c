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

The kernel has two forms (see ``csrc/bilinear128.cu``), which
:func:`form` picks per plan: LOOP (every plan: each thread H-filters its own
tap rows from global memory) and, for 3-byte input, H_TILE (each tap row of
a row group H-filtered once per tile into shared memory,
``bilinear.row_windows``) where each output row reads three tap rows or
more.

``scale_fn`` and ``scale_rows_fn`` take ``(B, H, W, nb_in)`` or
``(H, W, nb_in)`` uint8 tensors.  A tensor on the CPU goes to
:func:`bilinear128_scale_ref`; a tensor on a CUDA device launches the
kernel, or raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..formats import GammaType, StorageType
from ..plan import ScalePlan
from ..utils.timing import counter
from . import pixels
from ._plan_cache import plan_cache
from .bilinear import (_windows, axis_kind, axis_table, deep_v, filter_scale, row_windows,
                       table_len, tile_width)
from .bilinear import launch_shape as tile_launch_shape
from .deep import masks, mode

launches = 0
BYTES = counter("bilinear128")  # bytes handed in and returned, while tracing


def applicable(plan: ScalePlan) -> bool:
    return (
        plan.storage == StorageType.S128
        and plan.meta_in.n_bytes in (3, 4)
        and plan.meta_out.n_bytes in (3, 4)
    )


def _check(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> None:
    if not applicable(plan):
        raise ValueError(f"plan {plan.key} is outside the 128bpp kernel's class")
    pixels.check_input(plan, imgs)
    if first < 0 or n < 1 or first + n > plan.height_out:
        raise ValueError(
            f"row range [{first}, {first + n}) outside [0, {plan.height_out})"
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
    _check(plan, imgs, first, n)
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
        (name, ctypes.c_int64) for name in ("form", "h_cells")
    ]


# the kernel's blocks (kThreads in csrc/bilinear128.cu) and the blocks per
# SM the grid aims at
THREADS = 256
BLOCKS_PER_SM = 16


def launch_shape(w_out: int, n_rows: int, batch: int,
                 sms: int = pixels.H100_SMS) -> tuple[int, int, int, int]:
    """The kernel's grid for ``n_rows`` output rows of ``batch`` images:
    ``(tile_w, col_tiles, grid_y, grid_z)``.  A block of THREADS threads
    covers ``tile_w`` consecutive output columns (a power of two up to 32)
    of ``THREADS // tile_w`` consecutive rows; block (x, y, z) takes column
    tile x, row groups y, y + grid_y, ... of images z, z + grid_z, ....
    ``grid_y`` is cut so that the grid holds about BLOCKS_PER_SM blocks per
    SM, each then covering several row groups with one copy of the LUTs;
    ``grid_y`` and ``grid_z`` stay below 2^16."""
    tile_w = min(32, 1 << (w_out - 1).bit_length())
    col_tiles = -(-w_out // tile_w)
    row_groups = -(-n_rows // (THREADS // tile_w))
    grid_z = min(batch, 65535)
    grid_y = max(1, min(row_groups, BLOCKS_PER_SM * sms // (col_tiles * grid_z)))
    return tile_w, col_tiles, grid_y, grid_z


# the forms (enum Form in csrc/bilinear128.cu); H_TILE keeps at most
# H_CELLS cells of two words (kHCells there: 32 KB)
LOOP, H_TILE = range(2)
FORMS = {LOOP: "loop", H_TILE: "h tile"}
H_CELLS = 4096


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


@plan_cache
def _forms(plan: ScalePlan) -> tuple:
    return (LOOP, H_TILE) if rgb24(plan) and h_cells(plan) <= H_CELLS else (LOOP,)


def forms(plan: ScalePlan) -> list[int]:
    """The forms that can run the plan: LOOP always, H_TILE for
    :func:`rgb24` plans whose tap rows fit the h tile."""
    return list(_forms(plan))


def form(plan: ScalePlan) -> int:
    """The plan's form: H_TILE where it fits and each output row reads
    three tap rows or more (``bilinear.deep_v``: a V ladder of 1 or more
    halvings, a V box), else LOOP (COPY V, 0h V axes, 4-byte input).
    ``bilinear.cu``'s rule also sends upscales to its h tile; here LOOP was
    the faster on 6b-up.  On each timed 3-byte row this is the faster of
    the two (PERF.md §6)."""
    return H_TILE if H_TILE in _forms(plan) and deep_v(plan) else LOOP


@plan_cache
def _plan_params(plan: ScalePlan) -> _Bilinear128Params:
    """The parameters that follow from the plan alone (its routed form and
    h tile among them); :func:`_params` copies them per call."""
    f = pixels.kernel_fields(plan)
    f["src"] = (ctypes.c_int64 * 4)(*f["src"])
    return _Bilinear128Params(
        h_in=plan.height_in, w_in=plan.width_in, h_out=plan.height_out, w_out=plan.width_out,
        kind_x=axis_kind(plan.x), kind_y=axis_kind(plan.y),
        halvings_x=plan.x.halvings, halvings_y=plan.y.halvings,
        len_x=table_len(plan.x), len_y=table_len(plan.y),
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        mode=mode(plan), pack24_direct=int(plan.pack24_linear_direct), form=form(plan),
        h_cells=h_cells(plan) if rgb24(plan) else 0, **f,
    )


def _params(plan: ScalePlan, batch: int, first: int, n: int, sms: int = pixels.H100_SMS,
            form: int | None = None) -> _Bilinear128Params:
    """The kernel's parameters for output rows [first, first + n) of
    ``batch`` images; ``form`` is :func:`form`'s by default, else one of
    :func:`forms` (raises for one that does not fit)."""
    p = _Bilinear128Params.from_buffer_copy(_plan_params(plan))
    p.batch, p.row0, p.n_rows = batch, first, n
    if form is not None:
        if form not in _forms(plan):
            raise ValueError(f"plan {plan.key}: the 128bpp kernel's {FORMS.get(form, form)} "
                             f"form does not fit (forms {[FORMS[k] for k in _forms(plan)]})")
        p.form = form
    shape = launch_shape if p.form == LOOP else tile_launch_shape
    args = (n,) if p.form == LOOP else (first, n)
    p.tile_w, _, p.grid_y, p.grid_z = shape(plan.width_out, *args, batch, sms)
    return p


@functools.cache
def _entry():
    from ._build import library

    fn = library().smolscale_bilinear128_scale
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.POINTER(_Bilinear128Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int,
            form: int | None) -> torch.Tensor:
    global launches
    if not imgs.is_contiguous():
        raise ValueError("the 128bpp kernel takes contiguous input")
    batch = imgs if imgs.dim() == 4 else imgs[None]
    with pixels.ALLOC_SPAN:
        out = torch.empty(
            (batch.shape[0], n, plan.width_out, plan.meta_out.n_bytes),
            dtype=torch.uint8, device=imgs.device,
        )
    with pixels.TABLES_SPAN, torch.cuda.device(imgs.device):
        lut = pixels.lut_table(imgs.device)
        fold = pixels.unpack24_lut(imgs.device, plan.gamma == GammaType.SRGB_LINEAR)
        tx, ty = _tables(plan, imgs.device)
        params = _params(plan, batch.shape[0], first, n, pixels.sm_count(imgs.device), form)
        windows = None if params.form == LOOP else _windows(plan, imgs.device).data_ptr()
        pixels.TABLES_SPAN.end()
        with pixels.LAUNCH_SPAN:
            err = _entry()(
                batch.data_ptr(), out.data_ptr(), lut.data_ptr(), fold.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), windows,
                ctypes.byref(params), torch.cuda.current_stream().cuda_stream,
            )
    if err != 0:
        raise RuntimeError(f"128bpp kernel launch failed: CUDA error {err}")
    launches += 1
    return out if imgs.dim() == 4 else out[0]


def scale_rows_fn(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int,
                  form: int | None = None) -> torch.Tensor:
    """Output rows [first, first+n): (B, H, W, nb_in) or (H, W, nb_in) uint8
    -> (B, n, w, nb_out) or (n, w, nb_out) uint8, on the device where
    ``imgs`` lies.  Only those rows are computed.  ``form`` runs the kernel
    in that form (one of :func:`forms`) instead of the one :func:`form`
    picks; the bytes are the same."""
    first, n = int(first), int(n)
    _check(plan, imgs, first, n)
    if imgs.device.type == "cpu":
        out = bilinear128_scale_ref(plan, imgs, first, n)
    elif imgs.device.type == "cuda":
        out = _launch(plan, imgs, first, n, form)
    else:
        raise ValueError(f"no 128bpp kernel for device {imgs.device}")
    BYTES.add(imgs, out)
    return out


def scale_fn(plan: ScalePlan, imgs: torch.Tensor, form: int | None = None) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    return scale_rows_fn(plan, imgs, 0, plan.height_out, form)
