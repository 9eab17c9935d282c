"""Pixel unpack and pack for every (internal alpha, gamma) pair, shared by the
kernels' wrappers and plain versions (``ops.box``, ``ops.bilinear``,
``ops.deep``), with the device tables and the launch-shape limits the
wrappers share.

The work channels are the input bytes in order; 24bpp input gets a constant
alpha of 255 as channel 3 (the reference unpacks 24bpp with alpha 0xff and
filters it like any channel, generic.c:353-358).  The colour channels are
converted as ``backends/numpy_ref.unpack`` / ``pack`` specify for the plan's
internal alpha and gamma:

  PREMUL8 compressed: unassociated input premultiplied, ((v+1)*(a+1)-1) >> 8;
  PREMUL8 linear: premultiplied input unpremultiplied first, then the 11-bit
    linear value of from_srgb re-premultiplied (premul_p8l);
  PREMUL16 compressed: v*a, alpha (a << 8) | 0x80;
  PREMUL16 linear: from_srgb(v)*a, alpha (a << 8) | 0x80;

and packed back with the matching unpremultiply (unpremul_p8, _p8l, _p16,
_p16l) and to_srgb, keeping the 24bpp asymmetry that
``plan.pack24_linear_direct`` selects.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import luts
from ..formats import AlphaType, GammaType
from ..plan import ScalePlan

# the tables of lut_table, in order; csrc/deep.cu reads them at these offsets
LUT_NAMES = ("FROM_SRGB", "TO_SRGB", "INV_DIV_P8", "INV_DIV_P8L", "INV_DIV_P16",
             "INV_DIV_P16L")


def alpha_channel(plan: ScalePlan) -> int:
    """Work channel of alpha: its input byte, or 3 (a constant 255 channel
    appended to 24bpp input)."""
    layout = plan.meta_in.layout
    return layout.index(3) if 3 in layout else 3


def out_sources(plan: ScalePlan) -> list[int]:
    """Work channel feeding each output byte."""
    in_layout = plan.meta_in.layout
    a = alpha_channel(plan)
    return [a if ch == 3 else in_layout.index(ch) for ch in plan.meta_out.layout]


def kernel_fields(plan: ScalePlan) -> dict:
    """The pixel-format fields of the kernels' parameter blocks (``src`` as
    their ``int64[4]``)."""
    src = (ctypes.c_int64 * 4)(*out_sources(plan))
    return dict(
        nb_in=plan.meta_in.n_bytes, nb_out=plan.meta_out.n_bytes,
        alpha_ch=alpha_channel(plan),
        unassoc_in=int(plan.meta_in.alpha == AlphaType.UNASSOCIATED),
        unassoc_out=int(plan.meta_out.alpha == AlphaType.UNASSOCIATED),
        src=src,
    )


def check_input(plan: ScalePlan, imgs: torch.Tensor) -> None:
    if imgs.dtype != torch.uint8:
        raise TypeError(f"expected uint8 pixels, got {imgs.dtype}")
    expect = (plan.height_in, plan.width_in, plan.meta_in.n_bytes)
    if imgs.dim() not in (3, 4) or tuple(imgs.shape[-3:]) != expect:
        raise ValueError(
            f"input shape {tuple(imgs.shape)} does not match plan "
            f"(..., H_in, W_in, n_bytes_in) = {expect}"
        )


def _colour(plan: ScalePlan, device) -> torch.Tensor:
    colour = torch.ones(4, dtype=torch.bool, device=device)
    colour[alpha_channel(plan)] = False
    return colour


@functools.cache
def _lut(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(getattr(luts, name), dtype=torch.int64, device=device)


def _premul_p8(v, a):
    return (((v + 1) * (a + 1) - 1) >> 8) & 0xFF


def _unpremul(v, a, name: str, shift: int, mask: int):
    return ((v * _lut(name, v.device)[a]) >> shift) & mask


def unpack(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    """(H, W, nb_in) uint8 -> (H, W, 4) int64 work channels at the plan's
    internal alpha and gamma."""
    x = img.to(torch.int64)
    if plan.meta_in.n_bytes == 3:
        x = torch.cat([x, torch.full_like(x[..., :1], 255)], dim=-1)
    a_ch = alpha_channel(plan)
    a = x[..., a_ch : a_ch + 1]
    colour = _colour(plan, x.device)
    in_premul = plan.meta_in.alpha == AlphaType.PREMUL8
    linear = plan.gamma == GammaType.SRGB_LINEAR
    if plan.internal_alpha == AlphaType.PREMUL8 and not linear:
        return x if in_premul else torch.where(colour, _premul_p8(x, a), x)
    if plan.internal_alpha == AlphaType.PREMUL8:
        c = x
        if in_premul:
            c = _unpremul(c, a, "INV_DIV_P8", luts.INVERTED_DIV_SHIFT_P8, 0xFF)
        lin = _lut("FROM_SRGB", x.device)[c]
        # premul_ul_to_p8l (generic.c:261-269)
        c = (((lin + 1) * ((a << 3) + 1) - 1) >> 11) & 0x7FF
        return torch.where(colour, c, x)
    c = _lut("FROM_SRGB", x.device)[x] if linear else x
    return torch.where(colour, c * a, (a << 8) | 0x80)


def pack(plan: ScalePlan, x: torch.Tensor) -> torch.Tensor:
    """(h, w, 4) int64 work channels -> (h, w, nb_out) uint8."""
    a_ch = alpha_channel(plan)
    alpha = x[..., a_ch : a_ch + 1]
    out_premul = plan.meta_out.alpha == AlphaType.PREMUL8
    linear = plan.gamma == GammaType.SRGB_LINEAR
    to_srgb = _lut("TO_SRGB", x.device)
    if plan.internal_alpha == AlphaType.PREMUL8:
        a = alpha & 0xFF
        if not linear:
            if out_premul:
                return x[..., out_sources(plan)].to(torch.uint8)
            c = _unpremul(x, a, "INV_DIV_P8", luts.INVERTED_DIV_SHIFT_P8, 0xFF)
        elif out_premul and plan.pack24_linear_direct:
            # to_srgb of the premultiplied linear value (generic.c:922-935)
            c = to_srgb[x & 0x7FF]
        else:
            c = to_srgb[_unpremul(x, a, "INV_DIV_P8L", luts.INVERTED_DIV_SHIFT_P8L, 0x7FF)]
            if out_premul and plan.meta_out.n_bytes == 4:
                c = _premul_p8(c, a)
    else:
        a = (alpha >> 8) & 0xFF
        if linear:
            c = to_srgb[_unpremul(x, a, "INV_DIV_P16L", luts.INVERTED_DIV_SHIFT_P16L, 0x7FF)]
        else:
            c = _unpremul(x, a, "INV_DIV_P16", luts.INVERTED_DIV_SHIFT_P16, 0xFF)
    x = torch.where(_colour(plan, x.device), c, a) & 0xFF
    return x[..., out_sources(plan)].to(torch.uint8)


@functools.cache
def inv_div_table(device: torch.device) -> torch.Tensor:
    """inv_div_p8 as int32 on ``device``, for the kernels' unpremultiply."""
    return torch.as_tensor(luts.INV_DIV_P8.astype(np.int32), device=device)


# the SMs of an H100 SXM, which the kernels' launch shapes assume when no
# card is asked (the wrappers read the card's own with sm_count)
H100_SMS = 132
# grid y and z stay at most GRID_LIMIT; box.cu and deep.cu hold at most
# MAX_WARPS warps a block (kMaxWarps there) and aim their grids at WAVE_WARPS
# warps per SM, two waves of 64
GRID_LIMIT = 65535
MAX_WARPS = 8
WAVE_WARPS = 128


def pow2_ceil(n: int) -> int:
    """The least power of two at least ``n`` (>= 1)."""
    return 1 << (n - 1).bit_length()


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def lut_table(device: torch.device) -> torch.Tensor:
    """The six tables of ``LUT_NAMES`` as one int32 tensor on ``device``,
    one after the other (256 entries each, TO_SRGB 2048)."""
    return torch.as_tensor(
        np.concatenate([getattr(luts, name) for name in LUT_NAMES]).astype(np.int32),
        device=device,
    )


def unpack24_table(linear: bool) -> np.ndarray:
    """The work value of each colour byte of a 3-byte pixel (RGB8 and BGR8,
    premultiplied) at internal PREMUL8, as int32 (256,).  Alpha is the
    constant 255, so :func:`unpack` of a colour channel is a fixed function
    of its byte: at compressed gamma the identity; in linear light
    unpremul_p8 at 255, from_srgb, then premul_ul_to_p8l at 255
    (generic.c:227-236, 261-269), all of it one table entry, at most 2040."""
    v = np.arange(256, dtype=np.int64)
    if not linear:
        return v.astype(np.int32)
    v = ((v * int(luts.INV_DIV_P8[255])) >> luts.INVERTED_DIV_SHIFT_P8) & 0xFF
    lin = np.asarray(luts.FROM_SRGB, dtype=np.int64)[v]
    return ((((lin + 1) * ((255 << 3) + 1) - 1) >> 11) & 0x7FF).astype(np.int32)


@functools.cache
def unpack24_lut(device: torch.device, linear: bool) -> torch.Tensor:
    """:func:`unpack24_table` on ``device``, for the 128bpp kernel's 3-byte
    pixels."""
    return torch.as_tensor(unpack24_table(linear), device=device)
