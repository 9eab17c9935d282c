"""Scale planning: filter selection, storage/alpha/gamma modes, precalc arrays.

Frozen copy of ``smolscale_tpu/plan.py`` for the benchmark's plain
reference (``portbench.reference``): it imports nothing of the JAX
package or of the port, and the benchmark holds the port to it.

This is the traced-setup replacement for the reference's context
initialization (smolscale.c:816-870) and the backend precalc routines
(smolscale-generic.c:14-179).  Everything here depends only on *shapes and
formats*, never on pixel data, so a :class:`ScalePlan` is a static,
hashable compile-time object: JAX programs close over its arrays as
constants and jit-cache per plan.

All fixed-point computations use Python ints (arbitrary precision), matching
the reference's uint64 arithmetic exactly; array outputs are numpy int32
(every stored value fits in uint16, smolscale-private.h:303-306).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .formats import AlphaType, FormatMeta, GammaType, PixelType, StorageType, get_meta

SMOL_SMALL_MUL = 256
SMOL_BIG_MUL = 65536
SMOL_BOXES_MULTIPLIER = SMOL_BIG_MUL * SMOL_SMALL_MUL  # 2**24
SMOL_BILIN_MULTIPLIER = SMOL_BIG_MUL * SMOL_BIG_MUL  # 2**32

MAX_DIM = 65535  # uint16 offset contract (README:9)


class FilterType(enum.IntEnum):
    """Per-axis filter (smolscale-private.h:101-116)."""

    COPY = 0
    ONE = 1
    BILINEAR_0H = 2
    BILINEAR_1H = 3
    BILINEAR_2H = 4
    BILINEAR_3H = 5
    BILINEAR_4H = 6
    BILINEAR_5H = 7
    BILINEAR_6H = 8
    BOX = 9

    @property
    def is_bilinear(self) -> bool:
        return FilterType.BILINEAR_0H <= self <= FilterType.BILINEAR_6H

    @property
    def n_halvings(self) -> int:
        assert self.is_bilinear
        return int(self) - int(FilterType.BILINEAR_0H)


def pick_filter_params(
    dim_in: int, dim_out: int, with_srgb: bool
) -> tuple[FilterType, StorageType, int, int]:
    """Choose per-axis filter, storage class, halvings and bilinear dim.

    Port of pick_filter_params (smolscale.c:427-478): BOX past 8:1 (forced
    128bpp past 255:1), ONE for dim_in==1, COPY for equal sizes, otherwise
    bilinear with n halvings such that dim_out << n is the largest
    power-of-two multiple still below dim_in.
    """
    storage = StorageType.S128 if with_srgb else StorageType.S64
    dim_bilin = dim_out
    halvings = 0
    if dim_in > dim_out * 255:
        filt = FilterType.BOX
        storage = StorageType.S128
    elif dim_in > dim_out * 8:
        filt = FilterType.BOX
    elif dim_in == 1:
        filt = FilterType.ONE
    elif dim_in == dim_out:
        filt = FilterType.COPY
    else:
        n = 0
        d = dim_out
        while True:
            d *= 2
            if d >= dim_in:
                break
            n += 1
        dim_bilin = dim_out << n
        filt = FilterType(int(FilterType.BILINEAR_0H) + n)
        halvings = n
    return filt, storage, halvings, dim_bilin


def precalc_bilinear(dim_in: int, dim_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample (absolute offset, 256-scale factor) arrays for bilinear.

    Port of precalc_bilinear_array (smolscale-generic.c:14-66) with
    make_absolute_offsets always on (we convert to relative form nowhere;
    kernels gather with absolute indices).  ``dim_out`` is the dimension
    *after* halvings, i.e. width_bilin/height_bilin.

    Semantics: minification centers the first sample at (step-1)/2 of a
    2**32-per-pixel fixed-point ramp; magnification spans (dim_in-1) over
    (dim_out-1); the tail clamps to the last pixel pair at 100% bias.
    Each output sample j lerps in[ofs_j] and in[ofs_j+1] with weight
    F_j in [0,256] on the *left* pixel.
    """
    offsets = np.zeros(dim_out, dtype=np.int32)
    factors = np.zeros(dim_out, dtype=np.int32)
    if dim_in > dim_out:
        frac_step = (dim_in * SMOL_BILIN_MULTIPLIER) // dim_out
        frac = (frac_step - SMOL_BILIN_MULTIPLIER) // 2
    else:
        frac_step = ((dim_in - 1) * SMOL_BILIN_MULTIPLIER) // (
            dim_out - 1 if dim_out > 1 else 1
        )
        frac = 0
    j = 0
    last_ofs = dim_in - 2  # used by the clamp tail below
    while j < dim_out:
        ofs = frac // SMOL_BILIN_MULTIPLIER
        if ofs >= dim_in - 1:
            break
        offsets[j] = ofs
        factors[j] = SMOL_SMALL_MUL - (
            (frac // (SMOL_BILIN_MULTIPLIER // SMOL_SMALL_MUL)) % SMOL_SMALL_MUL
        )
        frac += frac_step
        j += 1
    while j < dim_out:
        offsets[j] = dim_in - 2
        factors[j] = 0
        j += 1
    return offsets, factors


def precalc_boxes(
    dim_in: int, dim_out: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Box-filter span table.

    Port of precalc_boxes_array (smolscale-generic.c:68-135).  Returns

    * ``ofs`` (length dim_out+1): absolute span starts; span j covers input
      [ofs[j], ofs[j+1]], with the trailing sentinel entry the C code
      appends at lines 133-134 — this is what the vertical filter consumes
      (absolute mode, init_vertical generic.c:166-171);
    * ``frac`` (length dim_out): 0..255 weight of the right-edge pixel;
    * ``strides`` (length dim_out): whole-pixel count per span as the C
      relative mode stores it (tail entries from an early break are 0 even
      though offsets repeat) — the horizontal box kernel's sequential
      pointer walk consumes these (interp_horizontal_boxes, generic.c:1443-1470);
    * ``span_mul``: the 2**24-fixed-point normalization constant (lines 86-91).
    """
    frac_step = (dim_in * SMOL_BIG_MUL) // dim_out
    stride = frac_step // SMOL_BIG_MUL
    f = (frac_step // SMOL_SMALL_MUL) % SMOL_SMALL_MUL
    a = SMOL_BOXES_MULTIPLIER * 255
    b = stride * 255 + (f * 255) // 256
    span_mul = (a + b // 2) // b

    ofs_arr = np.zeros(dim_out + 1, dtype=np.int32)
    frac_arr = np.zeros(dim_out, dtype=np.int32)
    strides = np.zeros(dim_out, dtype=np.int32)
    frac = 0
    ofs = 0
    j = 0
    while j < dim_out:
        frac += frac_step
        next_ofs = frac // SMOL_BIG_MUL
        if ofs >= dim_in - 1:
            ofs = dim_in - 1
            break
        if next_ofs > dim_in - 1:
            next_ofs = dim_in - 1
            if next_ofs <= ofs:
                break
        ofs_arr[j] = ofs
        strides[j] = next_ofs - ofs - 1
        frac_arr[j] = (frac // SMOL_SMALL_MUL) % SMOL_SMALL_MUL
        ofs = next_ofs
        j += 1
    while j < dim_out:
        ofs_arr[j] = ofs
        frac_arr[j] = 0
        strides[j] = 0
        j += 1
    ofs_arr[dim_out] = ofs  # trailing sentinel (generic.c:133-134)
    return ofs_arr, frac_arr, strides, span_mul


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """Filter plan for one axis."""

    dim_in: int
    dim_out: int
    filter: FilterType
    halvings: int
    dim_bilin: int
    # bilinear: offsets/factors of length dim_bilin
    # box: offsets of length dim_out+1, factors/strides of length dim_out
    offsets: Optional[np.ndarray]
    factors: Optional[np.ndarray]
    strides: Optional[np.ndarray]
    span_mul: int

    def __hash__(self):
        return hash((self.dim_in, self.dim_out, self.filter))

    def __eq__(self, other):
        return (
            isinstance(other, AxisPlan)
            and (self.dim_in, self.dim_out, self.filter)
            == (other.dim_in, other.dim_out, other.filter)
        )


def _make_axis_plan(dim_in: int, dim_out: int, with_srgb: bool) -> tuple[AxisPlan, StorageType]:
    filt, storage, halvings, dim_bilin = pick_filter_params(dim_in, dim_out, with_srgb)
    offsets = factors = strides = None
    span_mul = 0
    if filt == FilterType.BOX:
        offsets, factors, strides, span_mul = precalc_boxes(dim_in, dim_out)
    elif filt.is_bilinear:
        offsets, factors = precalc_bilinear(dim_in, dim_bilin)
    return (
        AxisPlan(
            dim_in, dim_out, filt, halvings, dim_bilin, offsets, factors, strides, span_mul
        ),
        storage,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ScalePlan:
    """Complete static plan for one (shape, format, srgb) configuration.

    Replaces SmolScaleCtx init (smol_scale_init, smolscale.c:816-870) plus
    get_implementations' mode decisions (smolscale.c:724-814): the PREMUL16
    rule for unassociated->unassociated (751-758) and the sRGB cutoff past
    8191:1 (760-770).  The repack-chain search (647-719) is unnecessary in
    the per-channel-plane representation: unpack/pack are direct channel
    permutations + alpha/gamma conversions chosen from (alpha_in,
    internal_alpha, gamma, storage).
    """

    width_in: int
    height_in: int
    width_out: int
    height_out: int
    pixel_type_in: PixelType
    pixel_type_out: PixelType
    with_srgb: bool
    x: AxisPlan
    y: AxisPlan
    storage: StorageType
    internal_alpha: AlphaType
    gamma: GammaType

    def __init__(
        self,
        width_in: int,
        height_in: int,
        width_out: int,
        height_out: int,
        pixel_type_in: PixelType,
        pixel_type_out: PixelType,
        with_srgb: bool = False,
    ):
        for d in (width_in, height_in, width_out, height_out):
            if not 1 <= d <= MAX_DIM:
                raise ValueError(f"dimension {d} out of range 1..{MAX_DIM}")
        object.__setattr__(self, "width_in", width_in)
        object.__setattr__(self, "height_in", height_in)
        object.__setattr__(self, "width_out", width_out)
        object.__setattr__(self, "height_out", height_out)
        object.__setattr__(self, "pixel_type_in", PixelType(pixel_type_in))
        object.__setattr__(self, "pixel_type_out", PixelType(pixel_type_out))
        object.__setattr__(self, "with_srgb", bool(with_srgb))

        xplan, storage_x = _make_axis_plan(width_in, width_out, self.with_srgb)
        yplan, storage_y = _make_axis_plan(height_in, height_out, self.with_srgb)
        storage = StorageType(max(storage_x, storage_y))

        meta_in = get_meta(self.pixel_type_in)
        meta_out = get_meta(self.pixel_type_out)
        internal_alpha = AlphaType.PREMUL8
        if (
            meta_in.alpha == AlphaType.UNASSOCIATED
            and meta_out.alpha == AlphaType.UNASSOCIATED
        ):
            # Preserve color of transparent pixels: 16-bit premul internally
            # (smolscale.c:751-758).
            internal_alpha = AlphaType.PREMUL16
            storage = StorageType.S128

        gamma = GammaType.SRGB_LINEAR if self.with_srgb else GammaType.SRGB_COMPRESSED
        if width_in > width_out * 8191 or height_in > height_out * 8191:
            # Not enough headroom for 11-bit linear channels (smolscale.c:760-770).
            gamma = GammaType.SRGB_COMPRESSED

        object.__setattr__(self, "x", xplan)
        object.__setattr__(self, "y", yplan)
        object.__setattr__(self, "storage", storage)
        object.__setattr__(self, "internal_alpha", internal_alpha)
        object.__setattr__(self, "gamma", gamma)

    @property
    def key(self):
        return (
            self.width_in, self.height_in, self.width_out, self.height_out,
            int(self.pixel_type_in), int(self.pixel_type_out), self.with_srgb,
        )

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, ScalePlan) and self.key == other.key

    @property
    def meta_in(self) -> FormatMeta:
        return get_meta(self.pixel_type_in)

    @property
    def meta_out(self) -> FormatMeta:
        return get_meta(self.pixel_type_out)

    @property
    def working_mask(self) -> int:
        """Per-lane working mask: 0xff in 64bpp lanes, 0xffffff in 128bpp."""
        return 0xFF if self.storage == StorageType.S64 else 0xFFFFFF

    def _mid_colors_reversed(self) -> bool:
        """Orientation of the color channels in the reference's mid-order.

        Models the unpack half of find_repacks (smolscale.c:647-719) on a
        little-endian host: pixels fetched as u32 appear byte-reversed
        (pixel_type_u32_le, smolscale.c:63-75), and the unpack reorder moves
        an alpha-first apparent order's alpha to the last mid slot, rotating
        the colors (reorder 1234_TO_2341, smolscale.c:20).  The result: mid
        color order is the apparent color order with alpha removed.  Returns
        True when that order is (B,G,R)-wise reversed relative to canonical.
        """
        layout = self.meta_in.layout
        apparent = tuple(reversed(layout)) if len(layout) == 4 else layout
        colors = [c for c in apparent if c != 3]
        return colors[0] > colors[-1]

    @property
    def pack24_linear_direct(self) -> bool:
        """True when packing must apply the reference's direct-to-sRGB quirk.

        The reference ships two 128bpp-PREMUL8-LINEAR -> 24bpp-premul pack
        row functions that differ numerically: the "...to_123..." variant
        (generic.c:922-935) applies the to-sRGB LUT to the still
        premultiplied linear values (line 929 passes row_in, not the
        unpremultiplied t), while the "...to_321..." variant
        (generic.c:1010-1023) unpremultiplies first.  find_repacks selects
        the 123 variant exactly when the mid-order color orientation equals
        the output byte orientation; bit-exactness requires reproducing the
        selection.  Verified against the oracle for all 10x2 format pairs.
        """
        if (
            self.meta_out.n_bytes != 3
            or self.gamma != GammaType.SRGB_LINEAR
            or self.internal_alpha != AlphaType.PREMUL8
        ):
            return False
        out_layout = self.meta_out.layout
        out_reversed = out_layout[0] > out_layout[-1]
        return self._mid_colors_reversed() == out_reversed
