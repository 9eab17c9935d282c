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

``scale_fn`` and ``scale_rows_fn`` take ``(B, H, W, nb_in)`` or
``(H, W, nb_in)`` uint8 tensors.  A tensor on the CPU goes to
:func:`bilinear128_scale_ref`; a tensor on a CUDA device launches the
kernel, or raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..formats import StorageType
from ..plan import ScalePlan
from . import pixels
from ._plan_cache import plan_cache
from .bilinear import axis_kind, axis_table, filter_scale, table_len
from .deep import masks, mode

launches = 0


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
    ] + [("src", ctypes.c_int64 * 4)]


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


def _params(plan: ScalePlan, batch: int, first: int, n: int,
            sms: int = pixels.H100_SMS) -> _Bilinear128Params:
    f = pixels.kernel_fields(plan)
    f["src"] = (ctypes.c_int64 * 4)(*f["src"])
    tile_w, _, grid_y, grid_z = launch_shape(plan.width_out, n, batch, sms)
    return _Bilinear128Params(
        batch=batch, h_in=plan.height_in, w_in=plan.width_in,
        h_out=plan.height_out, w_out=plan.width_out, row0=first, n_rows=n,
        kind_x=axis_kind(plan.x), kind_y=axis_kind(plan.y),
        halvings_x=plan.x.halvings, halvings_y=plan.y.halvings,
        len_x=table_len(plan.x), len_y=table_len(plan.y),
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        mode=mode(plan), tile_w=tile_w, grid_y=grid_y, grid_z=grid_z,
        pack24_direct=int(plan.pack24_linear_direct), **f,
    )


@functools.cache
def _entry():
    from ._build import library

    fn = library().smolscale_bilinear128_scale
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(_Bilinear128Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> torch.Tensor:
    global launches
    if not imgs.is_contiguous():
        raise ValueError("the 128bpp kernel takes contiguous input")
    batch = imgs if imgs.dim() == 4 else imgs[None]
    out = torch.empty(
        (batch.shape[0], n, plan.width_out, plan.meta_out.n_bytes),
        dtype=torch.uint8, device=imgs.device,
    )
    with torch.cuda.device(imgs.device):
        lut = pixels.lut_table(imgs.device)
        tx, ty = _tables(plan, imgs.device)
        params = _params(plan, batch.shape[0], first, n, pixels.sm_count(imgs.device))
        err = _entry()(
            batch.data_ptr(), out.data_ptr(), lut.data_ptr(), tx.data_ptr(), ty.data_ptr(),
            ctypes.byref(params), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"128bpp kernel launch failed: CUDA error {err}")
    launches += 1
    return out if imgs.dim() == 4 else out[0]


def scale_rows_fn(plan: ScalePlan, imgs: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Output rows [first, first+n): (B, H, W, nb_in) or (H, W, nb_in) uint8
    -> (B, n, w, nb_out) or (n, w, nb_out) uint8, on the device where
    ``imgs`` lies.  Only those rows are computed."""
    first, n = int(first), int(n)
    _check(plan, imgs, first, n)
    if imgs.device.type == "cpu":
        return bilinear128_scale_ref(plan, imgs, first, n)
    if imgs.device.type == "cuda":
        return _launch(plan, imgs, first, n)
    raise ValueError(f"no 128bpp kernel for device {imgs.device}")


def scale_fn(plan: ScalePlan, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    return scale_rows_fn(plan, imgs, 0, plan.height_out)
