"""Every level of a thumbnail pyramid from one read of each image, as a CUDA
kernel (``csrc/pyramid.cu``) and its plain PyTorch version.

Counterpart of ``smolscale_tpu.ops.pallas_pyramid`` (``applicable``,
``pyramid_fn`` and the 24bpp form of ``pyramid_dispatch``).  The class: two
or more levels of one source with distinct output shapes, S64 storage,
internal PREMUL8, compressed gamma, no sRGB; 4-byte pixels in and out
(premultiplied or unassociated on either side, but not both unassociated,
which is internal PREMUL16) or 3-byte pixels in and out; every axis of
every level a uniform bilinear ladder with f = 128.  The TPU's gates (width
a multiple of 128, height of 8, the per-image VMEM budget) play no part.

On such an axis the planner gives ``d = 2``, ``o0 = 0`` and ``dim_in ==
2 * (dim_out << n)`` (``applicable`` checks it for every axis; a plan set
that breaks it is outside the class and runs level by level): output
column j of a level with n halvings reads exactly input columns
``[j * 2^(n+1), (j+1) * 2^(n+1))``, and rows likewise.  The levels' windows
are nested and aligned, so a cell of ``2^(Nx+1) x 2^(Ny+1)`` input pixels
(Nx, Ny the largest halvings) yields whole output pixels of every level,
with no halo and no host tables.  The numbers are ``numpy_ref``'s for each
level on its own (generic.c:1290-1361): each level's H sum is shifted and
rounded per input row before its V ladder; computing a level from a coarser
level's bytes would give other bytes.

What the TPU kernel has that the port does not need: the int8 0/1 count
matmuls with a -128 bias (``_h_tables``, ``_v_tables``, ``_chunk_slices``),
the V chunk height ``_V_CM``, the VMEM estimate ``_vmem_bytes``, the
``_ABLATE`` timing knob, the u32 pixel views and the channel-major planes
feed.  They exist for the MXU and the 128-lane layout; the CUDA kernel sums
in integer registers and reads 3-byte pixels directly.

``pyramid_fn`` takes ``(B, H, W, nb)`` or ``(H, W, nb)`` uint8 tensors and
returns one tensor per level.  A tensor on the CPU goes to
:func:`pyramid_scale_ref`; a tensor on a CUDA device launches the kernel,
or raises.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats import AlphaType, GammaType, StorageType
from ..plan import ScalePlan
from . import bilinear, pixels
from ._kernel import Kernel
from ._plan_cache import plan_cache

launches = 0

# the kernel is instantiated for 0-2 halvings per axis: the planner takes a
# box past 8:1, so a bilinear axis has at most 2 (plan.pick_filter_params)
MAX_HALVINGS = 2
# levels are indexed by (halvings_y, halvings_x), as csrc/pyramid.cu
N_SLOTS = (MAX_HALVINGS + 1) ** 2


def nested_ladder(ax) -> bool:
    """True when the axis is a uniform f = 128 bilinear ladder whose sample i
    sits at input offset 2i and whose output j sums samples
    [j * 2^n, (j+1) * 2^n): ``d = 2``, ``o0 = 0``, ``dim_in == 2 * (dim_out << n)``."""
    if not ax.filter.is_bilinear or ax.halvings > MAX_HALVINGS:
        return False
    n = ax.dim_bilin
    return (
        ax.dim_in == 2 * n
        and ax.dim_out << ax.halvings == n
        and np.array_equal(ax.offsets, 2 * np.arange(n))
        and bool((np.asarray(ax.factors) == 128).all())
    )


def applicable(plans) -> bool:
    """True when one launch of the pyramid kernel computes every plan."""
    return _applicable(tuple(plans))


@plan_cache
def _applicable(plans: tuple) -> bool:
    # cached: a farm calls this for every batch, and the ladder checks
    # compare whole offset arrays
    if len(plans) < 2:
        return False
    p0 = plans[0]
    nb = p0.meta_in.n_bytes
    for p in plans:
        if (
            (p.width_in, p.height_in, p.pixel_type_in, p.pixel_type_out)
            != (p0.width_in, p0.height_in, p0.pixel_type_in, p0.pixel_type_out)
            or p.with_srgb
            or p.gamma != GammaType.SRGB_COMPRESSED
            or p.storage != StorageType.S64
            or p.internal_alpha != AlphaType.PREMUL8
            or p.meta_out.n_bytes != nb
            or nb not in (3, 4)
            or not (nested_ladder(p.x) and nested_ladder(p.y))
        ):
            return False
    # distinct output shapes: duplicates would alias one output slot
    return len({(p.width_out, p.height_out) for p in plans}) == len(plans)


def _check(plans: tuple, imgs: torch.Tensor) -> None:
    if not applicable(plans):
        raise ValueError("plan set is outside the pyramid kernel's class")
    pixels.check_input(plans[0], imgs)


def pyramid_scale_ref(plans, imgs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, on any device: each level on its
    own through ``bilinear.bilinear_scale_ref``."""
    plans = tuple(plans)
    _check(plans, imgs)
    return tuple(bilinear.bilinear_scale_ref(p, imgs) for p in plans)


# ----------------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------------

class _PyramidParams(ctypes.Structure):
    # mirrors struct PyramidParams in csrc/pyramid.cu
    _fields_ = [
        (name, ctypes.c_int64)
        for name in (
            "batch", "cells_x", "cells_y", "nx", "ny", "nb",
            "alpha_ch", "unassoc_in", "unassoc_out", "perm",
        )
    ] + [("out", ctypes.c_void_p * N_SLOTS)]


def slot(plan: ScalePlan) -> int:
    """The kernel's output slot of a level: 3 * halvings_y + halvings_x."""
    return (MAX_HALVINGS + 1) * plan.y.halvings + plan.x.halvings


def byte_perm(plan: ScalePlan) -> int:
    """``__byte_perm`` selector that takes output byte k from work channel
    ``src[k]`` (``pixels.out_sources``)."""
    return sum(c << (4 * k) for k, c in enumerate(pixels.out_sources(plan)))


def _params(plans: tuple, batch: int, outs: list[torch.Tensor]) -> _PyramidParams:
    p0 = plans[0]
    nx = max(p.x.halvings for p in plans)
    ny = max(p.y.halvings for p in plans)
    ptrs = (ctypes.c_void_p * N_SLOTS)()
    for p, o in zip(plans, outs):
        ptrs[slot(p)] = o.data_ptr()
    f = pixels.kernel_fields(p0)
    return _PyramidParams(
        batch=batch,
        cells_x=p0.width_in >> (nx + 1), cells_y=p0.height_in >> (ny + 1),
        nx=nx, ny=ny, nb=f["nb_in"], alpha_ch=f["alpha_ch"],
        unassoc_in=f["unassoc_in"], unassoc_out=f["unassoc_out"],
        perm=byte_perm(p0), out=ptrs,
    )


def _step(plans: tuple, batch: torch.Tensor, outs: list, device: torch.device):
    return (batch, pixels.inv_div_table(device)), _params(plans, batch.shape[0], outs)


KERNEL = Kernel(__name__, "pyramid", "smolscale_pyramid_scale", 2, _PyramidParams,
                plain=pyramid_scale_ref, step=_step)


def pyramid_fn(plans, imgs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(B, H, W, nb) or (H, W, nb) uint8 -> one (B, h, w, nb) or (h, w, nb)
    uint8 tensor per plan, on the device where ``imgs`` lies."""
    plans = tuple(plans)
    _check(plans, imgs)
    return tuple(KERNEL(plans, imgs,
                        [(p.height_out, p.width_out, p.meta_out.n_bytes) for p in plans]))
