"""The general 64bpp PREMUL8 pipeline: per axis a bilinear halving ladder
(the planner makes 0h-2h; a box past 8:1), a box with fractional edge
weights, COPY or ONE, as a CUDA kernel (``csrc/bilinear.cu``) and its plain
PyTorch version.

Counterpart of ``smolscale_tpu.ops.pallas_bilinear`` (``scale_fn``, the row
form ``scale_rows_fn`` and the 24bpp ``scale_fn_planes``).  The class: S64
storage with internal PREMUL8 and compressed gamma, 3- or 4-byte pixels in
and out, any axis kind, box axes of any ratio the planner keeps at 64bpp
(up to 255:1), whole and by rows.  Box x box plans with two or more outputs
per axis and a box axis past 64:1 are left to the deep box kernel
(``ops.deep``, which reads the box tables built here): one block per output
pixel sums their spans faster than this kernel's serial span loop.  The
TPU kernel's geometry and VMEM limits play no part.  The numbers are those
of ``backends/numpy_ref`` for the class (see the note at the top of
``csrc/bilinear.cu``).

The kernel has two paths.  A box X axis of about 15:1 and past is staged
in shared memory tile by tile of output columns: :func:`stage_table` gives
each tile's stretch of an input row and the threads per output column.
Every other plan takes the direct path, in one of three forms that
:func:`direct_form` picks by class: LOOP (each thread H-filters its own tap
rows from global memory) and H_TILE (each tap row of a row group H-filtered
once per tile into shared memory, :func:`row_windows`), both on blocks over
tiles of output columns by row groups (:func:`launch_shape`), and ROLL for
0-halving bilinear V axes, up and down (each thread walks a strip of output
rows with its two tap rows in registers, :func:`roll_shape`).

``scale_fn`` and ``scale_rows_fn`` take ``(B, H, W, nb_in)`` or
``(H, W, nb_in)`` uint8 tensors.  A tensor on the CPU goes to
:func:`bilinear_scale_ref`; a tensor on a CUDA device launches the kernel,
or raises.  ``launches`` counts the kernel launches, ``form_launches`` the
direct path's by form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..formats import AlphaType, GammaType, StorageType
from ..plan import AxisPlan, FilterType, ScalePlan
from ..utils.timing import counter
from . import pixels
from ._plan_cache import plan_cache

launches = 0
BYTES = counter("bilinear")  # bytes handed in and returned, while tracing

# box x box plans past this ratio on either axis go to the deep box kernel
DEEP_BOX_RATIO = 64

# axis kinds, as enum AxisKind in csrc/bilinear.cu
COPY, ONE, BILINEAR, BOX = range(4)


def axis_kind(ax: AxisPlan) -> int:
    if ax.filter.is_bilinear:
        return BILINEAR
    return {FilterType.COPY: COPY, FilterType.ONE: ONE, FilterType.BOX: BOX}[ax.filter]


def deep_box(plan: ScalePlan) -> bool:
    """Box x box with two or more outputs per axis and an axis past
    DEEP_BOX_RATIO: the plans the deep box kernel takes first (``ops.deep``
    imports this module, so the test is stated here)."""
    return (
        plan.x.filter == FilterType.BOX
        and plan.y.filter == FilterType.BOX
        and plan.width_out >= 2
        and plan.height_out >= 2
        and any(ax.dim_in > DEEP_BOX_RATIO * ax.dim_out for ax in (plan.x, plan.y))
    )


def applicable(plan: ScalePlan) -> bool:
    return (
        plan.storage == StorageType.S64
        and plan.internal_alpha == AlphaType.PREMUL8
        and plan.gamma == GammaType.SRGB_COMPRESSED
        and plan.meta_in.n_bytes in (3, 4)
        and plan.meta_out.n_bytes in (3, 4)
        and not deep_box(plan)
    )


def _check(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> None:
    if not applicable(plan):
        raise ValueError(f"plan {plan.key} is outside the bilinear kernel's class")
    pixels.check_input(plan, imgs)
    if first < 0 or n < 1 or first + n > plan.height_out:
        raise ValueError(
            f"row range [{first}, {first + n}) outside [0, {plan.height_out})"
        )


# ----------------------------------------------------------------------------
# Host tables, built once per plan and device
# ----------------------------------------------------------------------------

def box_h_arrays(ax: AxisPlan) -> dict:
    """The reference's H box pointer walk (interp_horizontal_boxes,
    generic.c:1443-1478) as per-output tables:
      out_j = (in[left_idx]*left_w >> 8) + sum(in[mid_start : mid_start+mid_len])
              + (in[right_idx]*fracs >> 8)
    The walk follows ``strides``, not ``offsets``: after an early break
    precalc_boxes leaves zero strides while the offsets repeat.  The final
    span reads its right pixel only when its fraction is > 0
    (generic.c:1472-1475), so its index is clamped.  Same tables as
    ``smolscale_tpu.backends.xla._box_h_arrays``."""
    n_out = ax.dim_out
    left_idx = np.zeros(n_out, dtype=np.int32)
    left_w = np.zeros(n_out, dtype=np.int32)
    right_idx = np.zeros(n_out, dtype=np.int32)
    mid_start = np.zeros(n_out, dtype=np.int32)
    pos = 1
    left_w[0] = 256
    for j in range(n_out):
        mid_start[j] = pos
        pos += int(ax.strides[j])
        if j < n_out - 1:
            right_idx[j] = pos
            pos += 1
            left_idx[j + 1] = right_idx[j]
            left_w[j + 1] = 255 - int(ax.factors[j])
        else:
            right_idx[j] = min(pos, ax.dim_in - 1)
    return dict(
        left_idx=left_idx, left_w=left_w, right_idx=right_idx,
        mid_start=mid_start, mid_len=ax.strides.astype(np.int32),
        fracs=ax.factors.astype(np.int32),
    )


def box_v_arrays(ax: AxisPlan, storage: StorageType = StorageType.S64) -> dict:
    """The reference's V box edges (scale_outrow_box_64bpp,
    generic.c:2112-2161): span i weights row offsets[i] by w1 (256 for span
    0, else 255 - frac[i-1]), sums the rows strictly between, and weights
    row offsets[i+1] by w2 = frac[i], its index clamped to the last row
    (w2 is 0 where the clamp acts).  Same tables as
    ``smolscale_tpu.backends.xla._box_v_arrays``.  At 128bpp the last row
    is weighted by w2 - 1, and not at all where w2 is 0
    (scale_outrow_box_128bpp, generic.c:2198-2260): w2 is then
    max(frac[i] - 1, 0), the TPU's ``w2p``."""
    n_out = ax.dim_out
    ofs = ax.offsets
    w2 = ax.factors if storage == StorageType.S64 else np.maximum(ax.factors - 1, 0)
    return dict(
        first_idx=ofs[:n_out].astype(np.int32),
        last_idx=np.minimum(ofs[1 : n_out + 1], ax.dim_in - 1).astype(np.int32),
        w1=np.concatenate([[256], 255 - ax.factors[:-1]]).astype(np.int32),
        w2=w2.astype(np.int32),
        mid_start=(ofs[:n_out] + 1).astype(np.int32),
        mid_len=np.maximum(ofs[1 : n_out + 1] - ofs[:n_out] - 1, 0).astype(np.int32),
    )


def axis_table(ax: AxisPlan, vertical: bool,
               storage: StorageType = StorageType.S64) -> np.ndarray:
    """The int32 table the kernel reads for one axis.  BILINEAR: offsets
    then factors, each ``dim_bilin`` long (sample k of output j is entry
    j*2^n + k).  BOX: six rows of ``dim_out`` -- first index, first weight,
    mid start, mid length, last index, last weight (the V last weight at
    ``storage``).  COPY, ONE: empty."""
    kind = axis_kind(ax)
    if kind == BILINEAR:
        return np.concatenate([ax.offsets, ax.factors]).astype(np.int32)
    if kind == BOX:
        if vertical:
            t = box_v_arrays(ax, storage)
            rows = ("first_idx", "w1", "mid_start", "mid_len", "last_idx", "w2")
        else:
            t = box_h_arrays(ax)
            rows = ("left_idx", "left_w", "mid_start", "mid_len", "right_idx", "fracs")
        return np.stack([t[r] for r in rows]).reshape(-1)
    return np.zeros(0, dtype=np.int32)


@plan_cache
def _tables(plan: ScalePlan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(
        torch.as_tensor(axis_table(ax, vertical), device=device)
        for ax, vertical in ((plan.x, False), (plan.y, True))
    )


# the kernel's staging of a BOX X axis (csrc/bilinear.cu): 256 threads per
# block, ``lanes`` of them per output column, at most STAGE_BYTES of an
# input row in shared memory at once (kThreads and kStageBytes there); a box
# whose columns read fewer than STAGE_MIN_READS pixels, and every other
# kind, loads directly
THREADS = 256
STAGE_BYTES = 24576
STAGE_MIN_READS = 16
# pixels between a column's edges per lane, below which it keeps one lane
LANE_READS = 16


def _span_reads(first, last, mid_start, mid_len) -> tuple[np.ndarray, np.ndarray]:
    """The inputs [lo, hi) of box spans: both edges and those between."""
    has_mid = mid_len > 0
    mid_lo = np.where(has_mid, mid_start, first)
    mid_hi = np.where(has_mid, mid_start + mid_len, first + 1)
    lo = np.minimum(np.minimum(first, last), mid_lo)
    hi = np.maximum(np.maximum(first, last) + 1, mid_hi)
    return lo, hi


def box_reads(ax: AxisPlan) -> tuple[np.ndarray, np.ndarray]:
    """For each output column of a BOX axis, the input columns [lo, hi)
    that its H filter reads: both edges and the pixels between them."""
    t = box_h_arrays(ax)
    return _span_reads(t["left_idx"], t["right_idx"], t["mid_start"], t["mid_len"])


def stage_table(ax: AxisPlan, nb: int) -> tuple[int, np.ndarray]:
    """The kernel's staging of an X axis of ``nb``-byte pixels: lanes per
    output column and, for each tile of ``THREADS // lanes`` output
    columns, the input columns [lo, hi) that its spans read, as int32 (2,
    tiles): lo row, then hi row.  A BOX axis whose columns read
    STAGE_MIN_READS pixels or more is staged: lanes (a power of two up to
    32) start where the pixels between a column's edges split into at most
    LANE_READS per lane, and double until every tile's stretch fits
    STAGE_BYTES.  Any other axis loads directly: (0, empty)."""
    direct = 0, np.zeros((2, 0), dtype=np.int32)
    if axis_kind(ax) != BOX:
        return direct
    lo, hi = box_reads(ax)
    if int((hi - lo).max()) < STAGE_MIN_READS:
        return direct
    lanes = 1
    while lanes < 32 and int(ax.strides.max()) > LANE_READS * lanes:
        lanes *= 2
    while True:
        starts = np.arange(0, ax.dim_out, THREADS // lanes)
        t_lo, t_hi = np.minimum.reduceat(lo, starts), np.maximum.reduceat(hi, starts)
        if int((t_hi - t_lo).max()) * nb <= STAGE_BYTES:
            return lanes, np.stack([t_lo, t_hi]).astype(np.int32)
        if lanes == 32:
            raise ValueError(f"axis {ax.dim_in} -> {ax.dim_out}: a tile of 8 columns "
                             f"reads more than {STAGE_BYTES} bytes of a row")
        lanes *= 2


@plan_cache
def _stage_tables(plan: ScalePlan, device: torch.device) -> tuple[int, torch.Tensor]:
    lanes, table = stage_table(plan.x, plan.meta_in.n_bytes)
    return lanes, torch.as_tensor(table.reshape(-1), device=device)


# the direct path (csrc/bilinear.cu): blocks of THREADS threads over tiles of
# tile_w output columns (a power of two up to 32) by THREADS // tile_w output
# rows, a row group, counted from output row 0; the grid aims at
# BLOCKS_PER_SM blocks per SM.  H_TILE keeps at most H_WORDS words of
# H-filtered values per tile (kHWords there)
BLOCKS_PER_SM = 16
H_WORDS = 4096
LOOP, H_TILE, ROLL = range(3)
FORMS = {LOOP: "loop", H_TILE: "h tile", ROLL: "roll"}
# the direct path's launches by form
form_launches = dict.fromkeys(FORMS, 0)
# ROLL's output columns per thread (csrc/bilinear.cu's direct_roll: one
# 16-byte store of 4-byte pixels), and its longest strip of output rows
ROLL_COLS = 4
ROLL_STRIP_ROWS = 64


def tile_width(w_out: int) -> int:
    """The direct path's output columns per block: w_out rounded up to a
    power of two, at most 32."""
    return min(32, 1 << (w_out - 1).bit_length())


def launch_shape(w_out: int, first: int, n: int, batch: int,
                 sms: int = pixels.H100_SMS) -> tuple[int, int, int, int]:
    """The direct path's grid for output rows [first, first + n) of
    ``batch`` images: ``(tile_w, col_tiles, grid_y, grid_z)``.  Row groups
    of ``THREADS // tile_w`` rows are counted from output row 0, so the
    range spans those from ``first``'s to ``first + n - 1``'s; block (x, y,
    z) takes column tile x, the range's row groups y, y + grid_y, ... and
    images z, z + grid_z, ....  ``grid_y`` is cut so that the grid holds
    about BLOCKS_PER_SM blocks per SM; ``grid_y`` and ``grid_z`` stay below
    2^16."""
    tile_w = tile_width(w_out)
    tile_h = THREADS // tile_w
    col_tiles = -(-w_out // tile_w)
    groups = (first + n - 1) // tile_h - first // tile_h + 1
    grid_z = min(batch, 65535)
    grid_y = max(1, min(groups, BLOCKS_PER_SM * sms // (col_tiles * grid_z)))
    return tile_w, col_tiles, grid_y, grid_z


def roll_shape(w_out: int, first: int, n: int, batch: int,
               sms: int = pixels.H100_SMS) -> tuple[int, int, int, int, int]:
    """ROLL's grid for output rows [first, first + n) of ``batch`` images:
    ``(tile_w, col_tiles, strip_rows, grid_y, grid_z)``.  A tile row of
    ``tile_w // ROLL_COLS`` threads (a power of two up to 32) covers
    ``tile_w`` output columns, and each walks a strip of ``strip_rows`` rows
    of the range; a block holds ``THREADS * ROLL_COLS // tile_w`` strips.
    Block (x, y, z) takes column tile x, the strips of blocks y, y + grid_y,
    ... and images z, z + grid_z, ....  The strips are as long as they must
    be for the grid to hold about BLOCKS_PER_SM blocks per SM, and at most
    ROLL_STRIP_ROWS: where a batch's column tiles alone fill the grid (64
    4K frames), more and shorter strips make the last wave of blocks a
    smaller share of the launch; much shorter ones cost more than they
    balance, as a strip's first row H-filters both tap rows (PERF.md §6).
    Every block holds at least one strip; ``grid_y`` and ``grid_z`` stay
    below 2^16."""
    quads = -(-w_out // ROLL_COLS)
    lanes = min(32, 1 << (quads - 1).bit_length())
    tile_w = ROLL_COLS * lanes
    col_tiles = -(-w_out // tile_w)
    per_block = THREADS // lanes
    grid_z = min(batch, 65535)
    target_y = max(1, BLOCKS_PER_SM * sms // (col_tiles * grid_z),
                   -(-n // (per_block * ROLL_STRIP_ROWS)))
    strip_rows = -(-n // (target_y * per_block))
    grid_y = -(-n // (strip_rows * per_block))
    return tile_w, col_tiles, strip_rows, grid_y, grid_z


def tap_rows(ay: AxisPlan) -> tuple[np.ndarray, np.ndarray]:
    """For each output row, the input rows [lo, hi) that the V filter of
    axis ``ay`` reads."""
    kind, n = axis_kind(ay), ay.dim_out
    if kind == COPY:
        return np.arange(n), np.arange(1, n + 1)
    if kind == ONE:
        return np.zeros(n, dtype=np.int64), np.ones(n, dtype=np.int64)
    if kind == BILINEAR:
        ofs = ay.offsets.reshape(n, -1).astype(np.int64)
        return ofs.min(1), ofs.max(1) + 2
    t = box_v_arrays(ay)
    return _span_reads(t["first_idx"], t["last_idx"], t["mid_start"], t["mid_len"])


def row_windows(plan: ScalePlan) -> np.ndarray:
    """The input rows [r_lo, r_hi) that each row group of the direct path
    reads, as int32 (2, groups): r_lo row, then r_hi row."""
    lo, hi = tap_rows(plan.y)
    starts = np.arange(0, plan.height_out, THREADS // tile_width(plan.width_out))
    return np.stack([np.minimum.reduceat(lo, starts),
                     np.maximum.reduceat(hi, starts)]).astype(np.int32)


def h_words(plan: ScalePlan) -> int:
    """The h tile's words: the widest row group's tap rows at the tile's
    width, rounded up to a multiple of 4."""
    rows = row_windows(plan)
    return -(-int((rows[1] - rows[0]).max()) * tile_width(plan.width_out) // 4) * 4


def h_tile_fits(plan: ScalePlan) -> bool:
    """Whether a row group's tap rows at the tile's width fit the h tile."""
    return h_words(plan) <= H_WORDS


def rolls(plan: ScalePlan) -> bool:
    """ROLL's class: a 0-halving bilinear V axis, whose tap rows only slide
    down (an upscale by 0 or 1 a row, a downscale to 0.5x by 1 or 2), beside
    an X axis of kind BILINEAR, COPY or ONE."""
    y = plan.y
    return axis_kind(y) == BILINEAR and y.halvings == 0 and axis_kind(plan.x) != BOX


def direct_forms(plan: ScalePlan) -> list[int]:
    """The direct path's forms that can run the plan: LOOP always, H_TILE
    where the tap rows fit the h tile, ROLL in its class."""
    forms = [LOOP, H_TILE] if h_tile_fits(plan) else [LOOP]
    return forms + [ROLL] if rolls(plan) else forms


def h_reuse(plan: ScalePlan) -> float:
    """The H filters LOOP computes per tile column over those of the h
    tile: the tap rows of every output row, over the rows of every row
    group's window (1: no tap row is shared)."""
    kind, n = axis_kind(plan.y), plan.height_out
    if kind == BILINEAR:
        taps = n << (plan.y.halvings + 1)
    elif kind == BOX:
        taps = 2 * n + int(box_v_arrays(plan.y)["mid_len"].sum())
    else:
        taps = n
    rows = row_windows(plan)
    return taps / int((rows[1] - rows[0]).sum())


def deep_v(plan: ScalePlan) -> bool:
    """Whether each output row's V filter reads three tap rows or more: a V
    ladder of 1 or more halvings, or a V box (``ops.bilinear128`` routes its
    3-byte plans to its h tile by this alone)."""
    y = plan.y
    return axis_kind(y) == BOX or (axis_kind(y) == BILINEAR and y.halvings >= 1)


def h_tile_pays(plan: ScalePlan) -> bool:
    """Whether the h tile pays by class: :func:`deep_v`, or the tap rows are
    shared two-fold or more (upscales, ONE); not for a COPY V axis or a 0h
    downscale."""
    return deep_v(plan) or h_reuse(plan) >= 2


def direct_form(plan: ScalePlan) -> int:
    """The direct path's form by class: ROLL in its class (:func:`rolls`),
    else H_TILE where the h tile fits and :func:`h_tile_pays`, else LOOP.
    On each timed row this is the fastest form (PERF.md §6)."""
    if rolls(plan):
        return ROLL
    return H_TILE if h_tile_fits(plan) and h_tile_pays(plan) else LOOP


@plan_cache
def _windows(plan: ScalePlan, device: torch.device) -> torch.Tensor:
    """The direct path's windows as the kernel reads them: every row
    group's r_lo, then every row group's r_hi."""
    return torch.as_tensor(row_windows(plan).reshape(-1), device=device)


# ----------------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------------

def box_axis(x: torch.Tensor, table: torch.Tensor, dim: int, first: int, n: int,
             span_mul: int, mask: int = 0xFF, out_mask: int = 0xFF) -> torch.Tensor:
    """Outputs [first, first+n) of a box axis along ``dim`` of int64 ``x``,
    from its six-row ``axis_table``: each edge element weighted and masked
    with ``mask`` on its own, the elements between summed by cumsum
    differences, then (acc * span_mul + 2^23) >> 24 and ``out_mask``
    (numpy_ref._box_axis; both masks are 0xFF at 64bpp)."""
    bcast = [1] * x.dim()
    bcast[dim] = -1
    first_idx, first_w, mid_start, mid_len, last_idx, last_w = (
        table.long().view(6, -1)[:, first : first + n]
    )
    sums = torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)), x.cumsum(dim)], dim)
    acc = ((x.index_select(dim, first_idx) * first_w.view(bcast)) >> 8) & mask
    acc += sums.index_select(dim, mid_start + mid_len) - sums.index_select(dim, mid_start)
    acc += ((x.index_select(dim, last_idx) * last_w.view(bcast)) >> 8) & mask
    return ((acc * span_mul + (1 << 23)) >> 24) & out_mask


def _filter_axis(x: torch.Tensor, ax: AxisPlan, table: torch.Tensor, dim: int,
                 first: int, n: int, mask: int, out_mask: int) -> torch.Tensor:
    """Outputs [first, first+n) of axis ``ax`` along ``dim`` of int64 ``x``
    (numpy_ref.hfilter / vfilter: gathers for the lerp, a reshape-sum for
    the halvings, cumsum differences for the box spans), with the working
    mask ``mask`` and the box's normalised mask ``out_mask`` (0xff and 0xff
    at 64bpp, 0xffffff and 0xffff at 128bpp)."""
    kind = axis_kind(ax)
    if kind == COPY:
        return x.narrow(dim, first, n)
    if kind == ONE:
        shape = list(x.shape)
        shape[dim] = n
        return x.narrow(dim, 0, 1).expand(shape)
    if kind == BOX:
        return box_axis(x, table, dim, first, n, int(ax.span_mul), mask, out_mask)
    bcast = [1] * x.dim()
    bcast[dim] = -1
    k = 1 << ax.halvings
    ofs, fac = table.long().view(2, -1)[:, first * k : (first + n) * k]
    p, q = x.index_select(dim, ofs), x.index_select(dim, ofs + 1)
    s = ((((p - q) * fac.view(bcast)) >> 8) + q) & mask
    if k == 1:
        return s
    return (s.unflatten(dim, (n, k)).sum(dim + 1) >> ax.halvings) & mask


def filter_scale(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int,
                 tables: tuple[torch.Tensor, torch.Tensor], mask: int = 0xFF,
                 out_mask: int = 0xFF) -> torch.Tensor:
    """Output rows [first, first+n) of ``imgs`` through ``pixels.unpack``,
    the H then the V filter of ``plan`` over the axes' ``tables`` and
    ``pixels.pack``, one image at a time in int64.  H is rounded per input
    row before V, as the reference does."""
    tx, ty = tables
    batch = imgs if imgs.dim() == 4 else imgs[None]
    out = torch.empty(
        (batch.shape[0], n, plan.width_out, plan.meta_out.n_bytes),
        dtype=torch.uint8, device=imgs.device,
    )
    for b in range(batch.shape[0]):
        x = pixels.unpack(plan, batch[b])
        x = _filter_axis(x, plan.x, tx, 1, 0, plan.width_out, mask, out_mask)
        x = _filter_axis(x, plan.y, ty, 0, first, n, mask, out_mask)
        out[b] = pixels.pack(plan, x)
    return out if imgs.dim() == 4 else out[0]


def bilinear_scale_ref(plan: ScalePlan, imgs: torch.Tensor, first: int = 0,
                       n: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: output rows
    [first, first+n) (all by default)."""
    n = plan.height_out - first if n is None else n
    _check(plan, imgs, first, n)
    return filter_scale(plan, imgs, first, n, _tables(plan, imgs.device))


# ----------------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------------

class _BilinearParams(ctypes.Structure):
    # mirrors struct BilinearParams in csrc/bilinear.cu
    _fields_ = [
        (name, ctypes.c_int64)
        for name in (
            "batch", "h_in", "w_in", "h_out", "w_out", "row0", "n_rows",
            "kind_x", "kind_y", "halvings_x", "halvings_y", "len_x", "len_y",
            "span_mul_x", "span_mul_y", "lanes_x",
            "nb_in", "nb_out", "alpha_ch", "unassoc_in", "unassoc_out",
        )
    ] + [("src", ctypes.c_int64 * 4)] + [
        (name, ctypes.c_int64)
        for name in ("tile_w", "grid_y", "grid_z", "form", "h_words", "strip_rows")
    ]


def table_len(ax: AxisPlan) -> int:
    kind = axis_kind(ax)
    return ax.dim_bilin if kind == BILINEAR else ax.dim_out if kind == BOX else 0


@plan_cache
def _plan_params(plan: ScalePlan) -> _BilinearParams:
    """The parameters that follow from the plan alone (the direct path's
    routed form and h tile among them); :func:`_params` copies them per
    call."""
    f = pixels.kernel_fields(plan)
    f["src"] = (ctypes.c_int64 * 4)(*f["src"])
    return _BilinearParams(
        h_in=plan.height_in, w_in=plan.width_in, h_out=plan.height_out, w_out=plan.width_out,
        kind_x=axis_kind(plan.x), kind_y=axis_kind(plan.y),
        halvings_x=plan.x.halvings, halvings_y=plan.y.halvings,
        len_x=table_len(plan.x), len_y=table_len(plan.y),
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        tile_w=tile_width(plan.width_out), form=direct_form(plan), h_words=h_words(plan), **f,
    )


def _params(plan: ScalePlan, batch: int, first: int, n: int, lanes: int,
            form: int | None = None, sms: int = pixels.H100_SMS) -> _BilinearParams:
    """The kernel's parameters for output rows [first, first + n) of
    ``batch`` images; ``form`` is the direct path's (by default
    :func:`direct_form`'s; unused when ``lanes`` stages a box X axis)."""
    p = _BilinearParams.from_buffer_copy(_plan_params(plan))
    p.batch, p.row0, p.n_rows, p.lanes_x = batch, first, n, lanes
    if form is not None:
        forms = ([LOOP, H_TILE] if p.h_words <= H_WORDS else [LOOP]) + [ROLL] * rolls(plan)
        if not lanes and form not in forms:
            raise ValueError(f"plan {plan.key}: the direct path's {FORMS.get(form, form)} "
                             f"form does not fit (forms {[FORMS[k] for k in forms]})")
        p.form = form
    if p.form == ROLL and not lanes:
        p.tile_w, _, p.strip_rows, p.grid_y, p.grid_z = roll_shape(
            plan.width_out, first, n, batch, sms)
    else:
        _, _, p.grid_y, p.grid_z = launch_shape(plan.width_out, first, n, batch, sms)
    return p


@functools.cache
def _entry():
    from ._build import library

    fn = library().smolscale_bilinear_scale
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(_BilinearParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int,
            form: int | None) -> torch.Tensor:
    global launches
    if not imgs.is_contiguous():
        raise ValueError("the bilinear kernel takes contiguous input")
    batch = imgs if imgs.dim() == 4 else imgs[None]
    with pixels.ALLOC_SPAN:
        out = torch.empty(
            (batch.shape[0], n, plan.width_out, plan.meta_out.n_bytes),
            dtype=torch.uint8, device=imgs.device,
        )
    with pixels.TABLES_SPAN, torch.cuda.device(imgs.device):
        inv_div = pixels.inv_div_table(imgs.device)
        tx, ty = _tables(plan, imgs.device)
        lanes, windows = _stage_tables(plan, imgs.device)
        if not lanes:
            windows = _windows(plan, imgs.device)
        params = _params(plan, batch.shape[0], first, n, lanes, form,
                         pixels.sm_count(imgs.device))
        pixels.TABLES_SPAN.end()
        with pixels.LAUNCH_SPAN:
            err = _entry()(
                batch.data_ptr(), out.data_ptr(), inv_div.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), windows.data_ptr(),
                ctypes.byref(params), torch.cuda.current_stream().cuda_stream,
            )
    if err != 0:
        raise RuntimeError(f"bilinear kernel launch failed: CUDA error {err}")
    launches += 1
    if not lanes:
        form_launches[params.form] += 1
    return out if imgs.dim() == 4 else out[0]


def scale_rows_fn(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int,
                  form: int | None = None) -> torch.Tensor:
    """Output rows [first, first+n): (B, H, W, nb_in) or (H, W, nb_in) uint8
    -> (B, n, w, nb_out) or (n, w, nb_out) uint8, on the device where
    ``imgs`` lies.  Only those rows are computed.  ``form`` runs the direct
    path in that form (one of :func:`direct_forms`) instead of the one
    :func:`direct_form` picks; the bytes are the same."""
    first, n = int(first), int(n)
    _check(plan, imgs, first, n)
    if imgs.device.type == "cpu":
        out = bilinear_scale_ref(plan, imgs, first, n)
    elif imgs.device.type == "cuda":
        out = _launch(plan, imgs, first, n, form)
    else:
        raise ValueError(f"no bilinear kernel for device {imgs.device}")
    BYTES.add(imgs, out)
    return out


def scale_fn(plan: ScalePlan, imgs: torch.Tensor, form: int | None = None) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    return scale_rows_fn(plan, imgs, 0, plan.height_out, form)
