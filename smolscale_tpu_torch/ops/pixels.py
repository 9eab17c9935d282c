"""Pixel unpack and pack for the 64bpp PREMUL8 class, shared by the kernels'
wrappers and plain versions (``ops.box``, ``ops.bilinear``).

The work channels are the input bytes in order; 24bpp input gets a constant
alpha of 255 as channel 3 (the reference unpacks 24bpp with alpha 0xff and
filters it like any channel, generic.c:353-358).  Unassociated input is
premultiplied on unpack and unassociated output unpremultiplied on pack, as
``backends/numpy_ref.unpack`` / ``pack`` do for this class.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import luts
from ..formats import AlphaType
from ..plan import ScalePlan


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
    """The pixel-format fields of the kernels' parameter blocks."""
    src = out_sources(plan) + [0] * (4 - plan.meta_out.n_bytes)
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


def unpack(plan: ScalePlan, img: torch.Tensor) -> torch.Tensor:
    """(H, W, nb_in) uint8 -> (H, W, 4) int64 premultiplied work channels."""
    x = img.to(torch.int64)
    if plan.meta_in.n_bytes == 3:
        x = torch.cat([x, torch.full_like(x[..., :1], 255)], dim=-1)
    if plan.meta_in.alpha == AlphaType.UNASSOCIATED:
        a_ch = alpha_channel(plan)
        a = x[..., a_ch : a_ch + 1]
        x = torch.where(_colour(plan, x.device), (((x + 1) * (a + 1) - 1) >> 8) & 0xFF, x)
    return x


def pack(plan: ScalePlan, x: torch.Tensor) -> torch.Tensor:
    """(h, w, 4) int64 work channels -> (h, w, nb_out) uint8."""
    if plan.meta_out.alpha == AlphaType.UNASSOCIATED:
        a_ch = alpha_channel(plan)
        inv_div = torch.as_tensor(luts.INV_DIV_P8, dtype=torch.int64, device=x.device)
        inv = inv_div[x[..., a_ch : a_ch + 1]]
        x = torch.where(_colour(plan, x.device),
                        ((x * inv) >> luts.INVERTED_DIV_SHIFT_P8) & 0xFF, x)
    return x[..., out_sources(plan)].to(torch.uint8)


@functools.cache
def inv_div_table(device: torch.device) -> torch.Tensor:
    """inv_div_p8 as int32 on ``device``, for the kernels' unpremultiply."""
    return torch.as_tensor(luts.INV_DIV_P8.astype(np.int32), device=device)
