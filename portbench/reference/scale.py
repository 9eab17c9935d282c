"""The benchmark's plain reference: scale in plain PyTorch, on any device.

A translation of ``smolscale_tpu/backends/numpy_ref.py`` (the semantic
specification, itself held bit-for-bit to the C reference's generic
backend) from numpy to torch, so that it runs on the card as well as on the
CPU, over a batch: planes are ``(4, *batch, H, W)`` int64 tensors, one per
canonical channel [c0, c1, c2, alpha], and every operation keeps the
specification's order.  Plans and tables come from the frozen copies beside
this file (``plan``, ``formats``, ``luts``), never from the port.

``exact=False`` is the benchmark's control: the same pipeline with the
filters' fixed-point arithmetic (the bilinear lerp, the halving average and
the box normalisation) done in float32 and rounded to nearest, the step a
port might take to use float units.  It breaks the bit-exactness that every
configuration states, and the comparison has to catch it.
"""

from __future__ import annotations

import functools

import torch

from . import luts
from .formats import AlphaType, GammaType, StorageType
from .plan import FilterType, ScalePlan

_I64 = torch.int64


@functools.cache
def _tables(device: torch.device) -> dict:
    """The lookup tables of ``luts`` as int64 tensors on ``device``."""
    names = ("INV_DIV_P8", "INV_DIV_P8L", "INV_DIV_P16", "INV_DIV_P16L",
             "FROM_SRGB", "TO_SRGB")
    return {n: torch.as_tensor(getattr(luts, n), dtype=_I64, device=device) for n in names}


class _Ops:
    """The fixed-point primitives (smolscale-generic.c:185-318) on one
    device, exact or in float32 (the control)."""

    def __init__(self, device: torch.device, exact: bool):
        self.t = _tables(torch.device(device))
        self.exact = exact

    def premul_p8(self, v, a):
        return (((v + 1) * (a + 1) - 1) >> 8) & 0xFF

    def unpremul_p8(self, v, a):
        return (v * self.t["INV_DIV_P8"][a] >> luts.INVERTED_DIV_SHIFT_P8) & 0xFF

    def premul_p8l(self, v, a):
        return (((v + 1) * ((a << 3) + 1) - 1) >> 11) & 0x7FF

    def unpremul_p8l(self, v, a):
        return (v * self.t["INV_DIV_P8L"][a] >> luts.INVERTED_DIV_SHIFT_P8L) & 0x7FF

    def unpremul_p16(self, v, a):
        return (v * self.t["INV_DIV_P16"][a] >> luts.INVERTED_DIV_SHIFT_P16) & 0xFF

    def unpremul_p16l(self, v, a):
        return (v * self.t["INV_DIV_P16L"][a] >> luts.INVERTED_DIV_SHIFT_P16L) & 0x7FF

    def from_srgb(self, v):
        return self.t["FROM_SRGB"][v]

    def to_srgb(self, v):
        return self.t["TO_SRGB"][v]

    def lerp(self, p, q, f, mask):
        """((p - q) * F >> 8) + q (generic.c:1317, 1704)."""
        if self.exact:
            return ((((p - q) * f) >> 8) + q) & mask
        return torch.round(q.float() + (p - q).float() * (f.float() / 256)).to(_I64) & mask

    def halve(self, s, n, dim, mask):
        """The mean of 2**n samples along ``dim`` (the halvings' sum >> n)."""
        if self.exact:
            return (s.sum(dim=dim) >> n) & mask
        return torch.round(s.float().mean(dim=dim)).to(_I64) & mask

    def scale_span(self, acc, span_mul, storage):
        """Box normalisation: (acc * span_mul + 2**23) >> 24, then the lane
        mask (scale_64bpp / scale_128bpp_half, generic.c:1231-1261)."""
        out_mask = 0xFF if storage == StorageType.S64 else 0xFFFF
        if self.exact:
            return ((acc * span_mul + (1 << 23)) >> 24) & out_mask
        return torch.round(acc.float() * (span_mul / float(1 << 24))).to(_I64) & out_mask


def unpack(plan: ScalePlan, img: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """(..., H, W, n_bytes) uint8 -> (4, ..., H, W) int64 internal planes
    (the unpack half of the repack matrix, generic.c:349-752)."""
    meta = plan.meta_in
    chans = [None, None, None, None]
    for byte_pos, ch in enumerate(meta.layout):
        chans[ch] = img[..., byte_pos].to(_I64)
    a = chans[3] if meta.has_alpha else torch.full(img.shape[:-1], 255, dtype=_I64,
                                                   device=img.device)
    color = chans[:3]
    ia, g = plan.internal_alpha, plan.gamma
    in_premul = meta.alpha == AlphaType.PREMUL8
    if ia == AlphaType.PREMUL8 and g == GammaType.SRGB_COMPRESSED:
        out_c = color if in_premul else [ops.premul_p8(c, a) for c in color]
        out_a = a
    elif ia == AlphaType.PREMUL8 and g == GammaType.SRGB_LINEAR:
        if in_premul:
            out_c = [ops.premul_p8l(ops.from_srgb(ops.unpremul_p8(c, a)), a) for c in color]
        else:
            out_c = [ops.premul_p8l(ops.from_srgb(c), a) for c in color]
        out_a = a
    elif ia == AlphaType.PREMUL16 and g == GammaType.SRGB_COMPRESSED:
        out_c = [c * a for c in color]
        out_a = (a << 8) | 0x80
    else:  # PREMUL16 LINEAR (generic.c:636-660, 728-752)
        out_c = [ops.from_srgb(c) * a for c in color]
        out_a = (a << 8) | 0x80
    return torch.stack(out_c + [out_a])


def pack(plan: ScalePlan, planes: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """(4, ..., h, w) int64 internal planes -> (..., h, w, n_bytes) uint8
    (the pack half, generic.c:754-1164, with the 24bpp linear asymmetry of
    generic.c:922-935)."""
    meta = plan.meta_out
    ia, g = plan.internal_alpha, plan.gamma
    out_premul = meta.alpha == AlphaType.PREMUL8
    color = [planes[i] for i in range(3)]
    alpha_plane = planes[3]
    if ia == AlphaType.PREMUL8:
        a = alpha_plane & 0xFF
        if g == GammaType.SRGB_COMPRESSED:
            out_c = color if out_premul else [ops.unpremul_p8(c, a) for c in color]
        elif out_premul:
            if meta.n_bytes == 3:
                if plan.pack24_linear_direct:
                    out_c = [ops.to_srgb(c & 0x7FF) for c in color]
                else:
                    out_c = [ops.to_srgb(ops.unpremul_p8l(c, a)) for c in color]
            else:
                out_c = [ops.premul_p8(ops.to_srgb(ops.unpremul_p8l(c, a)), a) for c in color]
        else:
            out_c = [ops.to_srgb(ops.unpremul_p8l(c, a)) for c in color]
    else:  # PREMUL16 (output is always unassociated here)
        a = (alpha_plane >> 8) & 0xFF
        if g == GammaType.SRGB_COMPRESSED:
            out_c = [ops.unpremul_p16(c, a) for c in color]
        else:
            out_c = [ops.to_srgb(ops.unpremul_p16l(c, a)) for c in color]
    chans = out_c + [a]
    return torch.stack([chans[ch] & 0xFF for ch in meta.layout], dim=-1).to(torch.uint8)


def _bilinear(planes, ax, mask, ops, vertical):
    dev = planes.device
    off = torch.as_tensor(ax.offsets, dtype=_I64, device=dev)
    f = torch.as_tensor(ax.factors, dtype=_I64, device=dev)
    if vertical:
        p, q, f = planes[..., off, :], planes[..., off + 1, :], f[:, None]
    else:
        p, q = planes[..., off], planes[..., off + 1]
    samples = ops.lerp(p, q, f, mask)
    n = ax.halvings
    if n == 0:
        return samples
    if vertical:
        s = samples.reshape(*samples.shape[:-2], ax.dim_out, 1 << n, samples.shape[-1])
        return ops.halve(s, n, -2, mask)
    s = samples.reshape(*samples.shape[:-1], ax.dim_out, 1 << n)
    return ops.halve(s, n, -1, mask)


def hfilter(plan: ScalePlan, planes: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """(4, ..., H, W_in) -> (4, ..., H, W_out) along the last axis."""
    ax, mask = plan.x, plan.working_mask
    if ax.filter == FilterType.COPY:
        return planes
    if ax.filter == FilterType.ONE:
        return planes[..., :1].expand(*planes.shape[:-1], ax.dim_out)
    if ax.filter.is_bilinear:
        return _bilinear(planes, ax, mask, ops, vertical=False)
    return _box_horizontal(planes, ax, mask, plan.storage, ops)


def vfilter(plan: ScalePlan, hrows: torch.Tensor, ops: _Ops) -> torch.Tensor:
    """(4, ..., H_in, W_out) -> (4, ..., H_out, W_out) along the row axis."""
    ay, mask = plan.y, plan.working_mask
    if ay.filter == FilterType.COPY:
        return hrows
    if ay.filter == FilterType.ONE:
        return hrows[..., :1, :].expand(*hrows.shape[:-2], ay.dim_out, hrows.shape[-1])
    if ay.filter.is_bilinear:
        return _bilinear(hrows, ay, mask, ops, vertical=True)
    return _box_vertical(hrows, ay, mask, plan.storage, ops)


def _box_horizontal(planes, ax, mask, storage, ops):
    """interp_horizontal_boxes_{64,128}bpp (generic.c:1427-1556): a
    sequential span walk carrying the left fractional remainder."""
    n_out = ax.dim_out
    out = torch.zeros((*planes.shape[:-1], n_out), dtype=_I64, device=planes.device)
    strides, fracs = ax.strides, ax.factors
    pos = 1
    left = (planes[..., 0] * 256 >> 8) & mask
    for j in range(n_out - 1):
        n = int(strides[j])
        acc = planes[..., pos : pos + n].sum(dim=-1) + left
        r = planes[..., pos + n]
        s = r * int(fracs[j])
        acc = acc + ((s >> 8) & mask)
        left = (((r << 8) - r - s) >> 8) & mask
        out[..., j] = ops.scale_span(acc, ax.span_mul, storage)
        pos += n + 1
    n = int(strides[n_out - 1])
    acc = planes[..., pos : pos + n].sum(dim=-1) + left
    pos += n
    f = int(fracs[n_out - 1])
    if f > 0:
        acc = acc + ((planes[..., pos] * f >> 8) & mask)
    out[..., n_out - 1] = ops.scale_span(acc, ax.span_mul, storage)
    return out


def _box_vertical(planes, ax, mask, storage, ops):
    """scale_outrow_box_* (generic.c:2112-2260): per-output-row edge
    weights; the 128bpp path weights its last row by w2 - 1 (line 2248)."""
    n_out, dim_in = ax.dim_out, ax.dim_in
    ofs, fracs = ax.offsets, ax.factors
    out = torch.zeros((*planes.shape[:-2], n_out, planes.shape[-1]), dtype=_I64,
                      device=planes.device)
    for i in range(n_out):
        y0, y1 = int(ofs[i]), int(ofs[i + 1])
        w1 = 256 if i == 0 else 255 - int(fracs[i - 1])
        w2 = int(fracs[i])
        acc = (planes[..., y0, :] * w1 >> 8) & mask
        if storage == StorageType.S64:
            if w2 or y1 < dim_in:
                acc = acc + ((planes[..., y1, :] * w2 >> 8) & mask)
            if y1 > y0 + 1:
                acc = acc + planes[..., y0 + 1 : y1, :].sum(dim=-2)
        else:
            if y1 > y0 + 1:
                acc = acc + planes[..., y0 + 1 : y1, :].sum(dim=-2)
            if w2 > 0:
                acc = acc + ((planes[..., y1, :] * (w2 - 1) >> 8) & mask)
        out[..., i, :] = ops.scale_span(acc, ax.span_mul, storage)
    return out


def scale(plan: ScalePlan, img: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Scale ``(..., H_in, W_in, n_bytes_in)`` uint8 on the device where it
    lies -> ``(..., H_out, W_out, n_bytes_out)`` uint8."""
    expect = (plan.height_in, plan.width_in, plan.meta_in.n_bytes)
    if tuple(img.shape[-3:]) != expect:
        raise ValueError(f"input shape {tuple(img.shape)} does not match plan {expect}")
    ops = _Ops(img.device, exact)
    planes = unpack(plan, img, ops)
    return pack(plan, vfilter(plan, hfilter(plan, planes, ops), ops), ops)
