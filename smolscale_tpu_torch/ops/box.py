"""Integer-ratio box downscale: the headline thumbnail path (e.g. RGBA
4096^2 -> 256^2), as a CUDA kernel (``csrc/box.cu``) and its plain PyTorch
version.

Counterpart of ``smolscale_tpu.ops.pallas_box`` (``scale_fn``,
``scale_fn_planes`` and ``_unpremul_epilogue``).  The plan class is the same
minus the TPU's tiling limits: each axis is an integer-ratio BOX or a COPY,
at least one axis is BOX, S64 storage with internal PREMUL8 and compressed
gamma, 3- or 4-byte pixels in and out.  The numbers are those of
``backends/numpy_ref`` for that class (see the note at the top of
``csrc/box.cu``).

``scale_fn`` takes ``(B, H, W, nb_in)`` or ``(H, W, nb_in)`` uint8 tensors.
A tensor on the CPU goes to :func:`box_scale_ref`; a tensor on a CUDA device
launches the kernel, or raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..formats import AlphaType, GammaType, StorageType
from ..plan import AxisPlan, FilterType, ScalePlan
from . import pixels
from ._kernel import Kernel
from .pixels import GRID_LIMIT, MAX_WARPS, WAVE_WARPS, pow2_ceil

launches = 0


def uniform_box(ax: AxisPlan) -> bool:
    """True for integer-ratio box axes: every span has the same whole-pixel
    stride (the final span may be one short, from the dim_in-1 clamp of
    precalc_boxes_array, generic.c:105-110) and all edge fractions are 0.
    Same test as ``smolscale_tpu.backends.xla._box_uniform_applicable``."""
    s = ax.strides
    if ax.filter != FilterType.BOX or ax.dim_out < 2 or (ax.factors != 0).any():
        return False
    if (s[:-1] != s[0]).any() or s[-1] not in (s[0], s[0] - 1):
        return False
    return ax.dim_out * (int(s[0]) + 1) == ax.dim_in


def applicable(plan: ScalePlan) -> bool:
    def axis_ok(ax):
        return ax.filter == FilterType.COPY or uniform_box(ax)

    return (
        plan.storage == StorageType.S64
        and plan.internal_alpha == AlphaType.PREMUL8
        and plan.gamma == GammaType.SRGB_COMPRESSED
        and plan.meta_in.n_bytes in (3, 4)
        and plan.meta_out.n_bytes in (3, 4)
        and axis_ok(plan.x)
        and axis_ok(plan.y)
        and FilterType.BOX in (plan.x.filter, plan.y.filter)
    )


def _span(ax: AxisPlan) -> tuple[int, bool]:
    """(span length, whether the last span drops the axis's final element);
    (1, False) on a COPY axis."""
    if ax.filter == FilterType.COPY:
        return 1, False
    r = int(ax.strides[0]) + 1
    return r, int(ax.strides[-1]) == r - 2


# ----------------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------------

def _box_axis(x: torch.Tensor, ax: AxisPlan, dim: int) -> torch.Tensor:
    """Integer-ratio box along ``dim`` of int64 ``x``: span j sums
    v[j*r : (j+1)*r] with its first element weighted 255/256 (span 0
    exempt) and, in a clamped last span, the axis's final element dropped;
    then (acc * span_mul + 2^23) >> 24 (numpy_ref._box_axis on this
    class)."""
    r, drop = _span(ax)
    n = ax.dim_out
    g = x.unflatten(dim, (n, r))
    first = g.select(dim + 1, 0)
    edge = (first > 0).to(first.dtype)
    edge.narrow(dim, 0, 1).zero_()
    acc = first - edge + g.narrow(dim + 1, 1, r - 1).sum(dim + 1)
    if drop:
        acc.narrow(dim, n - 1, 1).sub_(
            g.narrow(dim, n - 1, 1).select(dim + 1, r - 1)
        )
    return ((acc * int(ax.span_mul) + (1 << 23)) >> 24) & 0xFF


def _ref_one(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    x = pixels.unpack(plan, img)
    if plan.x.filter == FilterType.BOX:
        x = _box_axis(x, plan.x, 1)
    if plan.y.filter == FilterType.BOX:
        x = _box_axis(x, plan.y, 0)
    return pixels.pack(plan, x)


def box_scale_ref(plan: ScalePlan, imgs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: int64 channels,
    one image at a time to bound memory at the headline size."""
    KERNEL.check(plan, imgs)
    batch = imgs if imgs.dim() == 4 else imgs[None]
    out = torch.empty(
        (batch.shape[0], plan.height_out, plan.width_out, plan.meta_out.n_bytes),
        dtype=torch.uint8, device=imgs.device,
    )
    for b in range(batch.shape[0]):
        out[b] = _ref_one(plan, batch[b])
    return out if imgs.dim() == 4 else out[0]


# ----------------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------------

class _BoxParams(ctypes.Structure):
    # mirrors struct BoxParams in csrc/box.cu
    _fields_ = [
        (name, ctypes.c_int64)
        for name in (
            "batch", "h_in", "w_in", "h_out", "w_out", "rx", "ry",
            "box_x", "box_y", "drop_x", "drop_y", "span_mul_x", "span_mul_y",
            "nb_in", "nb_out", "alpha_ch", "unassoc_in", "unassoc_out",
        )
    ] + [("src", ctypes.c_int64 * 4)] + [
        (name, ctypes.c_int64)
        for name in ("form", "cw", "wc", "splits", "rows_per_split",
                     "grid_x", "grid_y", "grid_z")
    ]


# the kernel's forms (enum Form in csrc/box.cu)
DIRECT, COPY, STAGED = 0, 1, 2
FORMS = {DIRECT: "direct", COPY: "copy", STAGED: "staged"}
# a warp's input stretch per row in the staged form, at most (kSlotBytes in
# csrc/box.cu holds it with its skew)
STAGE_BYTES = 2048


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def form(plan: ScalePlan, address: int = 0) -> int:
    """Which form of the kernel takes ``plan`` for an input at byte
    ``address``: COPY (a COPY X axis) and DIRECT (a span of 4-byte pixels
    whose bytes are a multiple of 16) load 16-byte words straight into
    registers, so they need 4-byte pixels, rows of a multiple of 16 bytes and
    a 16-byte aligned input; everything else is STAGED through shared
    memory."""
    nb = plan.meta_in.n_bytes
    rx, _ = _span(plan.x)
    aligned = nb == 4 and address % 16 == 0 and plan.width_in * nb % 16 == 0
    if aligned and plan.x.filter == FilterType.COPY:
        return COPY
    if aligned and rx * nb % 16 == 0:
        return DIRECT
    return STAGED


def launch_shape(plan: ScalePlan, batch: int, kind: int,
                 sms: int = pixels.H100_SMS) -> dict:
    """The kernel's work mapping for ``batch`` images in form ``kind``.

    A warp covers ``cw`` consecutive output columns of one output row,
    ``32 // cw`` lanes per column (COPY: ``cw`` = 128, four columns per
    lane), and the input rows [s * rows_per_split, (s + 1) * rows_per_split)
    of their spans, s < ``splits``.  A block holds ``wc * splits`` warps:
    warp w covers column group w % wc and split w // wc.  Block (x, y, z)
    takes column tile x (``wc * cw`` columns), output rows y, y + grid_y, ...
    of images z, z + grid_z, ....  ``splits`` doubles (to 8, keeping at
    least 4 rows per split) until the grid holds WAVE_WARPS warps per SM:
    deep ratios with few output pixels then still fill the card."""
    rx, _ = _span(plan.x)
    ry, _ = _span(plan.y)
    nb = plan.meta_in.n_bytes
    w_out, h_out = plan.width_out, plan.height_out
    if kind == COPY:
        cw = 128
    elif kind == DIRECT:
        cw = 32 // min(32, _pow2_floor(rx * nb // 16))
    else:
        cw = min(32, _pow2_floor(max(1, STAGE_BYTES // (rx * nb))), pow2_ceil(w_out))
    col_warps = -(-w_out // cw)
    splits = 1
    while (splits < MAX_WARPS and ry >= 8 * splits
           and col_warps * h_out * batch * splits < WAVE_WARPS * sms):
        splits *= 2
    wc = min(MAX_WARPS // splits, pow2_ceil(col_warps))
    return dict(
        form=kind, cw=cw, wc=wc, splits=splits, rows_per_split=-(-ry // splits),
        grid_x=-(-w_out // (wc * cw)), grid_y=min(h_out, GRID_LIMIT),
        grid_z=min(batch, GRID_LIMIT),
    )


def _params(plan: ScalePlan, batch: int, address: int = 0,
            sms: int = pixels.H100_SMS) -> _BoxParams:
    rx, drop_x = _span(plan.x)
    ry, drop_y = _span(plan.y)
    return _BoxParams(
        batch=batch, h_in=plan.height_in, w_in=plan.width_in,
        h_out=plan.height_out, w_out=plan.width_out, rx=rx, ry=ry,
        box_x=int(plan.x.filter == FilterType.BOX),
        box_y=int(plan.y.filter == FilterType.BOX),
        drop_x=int(drop_x), drop_y=int(drop_y),
        span_mul_x=int(plan.x.span_mul), span_mul_y=int(plan.y.span_mul),
        **pixels.kernel_fields(plan),
        **launch_shape(plan, batch, form(plan, address), sms),
    )


def _step(plan: ScalePlan, batch: torch.Tensor, outs: list, device: torch.device):
    params = _params(plan, batch.shape[0], batch.data_ptr(), pixels.sm_count(device))
    return (batch, outs[0], pixels.inv_div_table(device)), params


KERNEL = Kernel(__name__, "box", "smolscale_box_scale", 3, _BoxParams,
                plain=box_scale_ref, step=_step, applicable=applicable)


def scale_fn(plan: ScalePlan, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, nb_in) or (H, W, nb_in) uint8 -> (B, h, w, nb_out) or
    (h, w, nb_out) uint8, on the device where ``imgs`` lies."""
    KERNEL.check(plan, imgs)
    return KERNEL(plan, imgs, ((plan.height_out, plan.width_out, plan.meta_out.n_bytes),))[0]
