"""Pixel formats and their metadata.

Frozen copy of ``smolscale_tpu/formats.py`` for the benchmark's plain
reference (``portbench.reference``): it imports nothing of the JAX
package or of the port, and the benchmark holds the port to it.

Mirrors the reference's public ``SmolPixelType`` enum (smolscale.h:14-35) and
the internal per-type metadata table (``pixel_type_meta``, smolscale.c:45-58).

Design note (TPU-first): the reference stores pixels as packed u32s and runs a
two-stage repack-chain search over channel *reorders* with alpha forced into
the last lane (smolscale.c:647-719), plus a little-endian reinterpretation
dance (smolscale.c:63-75, 589-596).  All internal lanes are processed
identically by every filter, and alpha-dependent ops always read the alpha
lane — so the *values* never depend on which lane holds which color channel.
We therefore define formats directly in **byte order** and collapse the whole
repack machinery to a channel permutation at unpack/pack time.  Outputs are
bit-identical; tests/test_exact_vs_oracle.py holds the proof.
"""

from __future__ import annotations

import enum


class PixelType(enum.IntEnum):
    """Public pixel formats; values match the reference enum for familiarity."""

    RGBA8_PREMULTIPLIED = 0
    BGRA8_PREMULTIPLIED = 1
    ARGB8_PREMULTIPLIED = 2
    ABGR8_PREMULTIPLIED = 3
    RGBA8_UNASSOCIATED = 4
    BGRA8_UNASSOCIATED = 5
    ARGB8_UNASSOCIATED = 6
    ABGR8_UNASSOCIATED = 7
    RGB8 = 8
    BGR8 = 9


class AlphaType(enum.IntEnum):
    """Alpha handling class (smolscale-private.h:149-157)."""

    UNASSOCIATED = 0
    PREMUL8 = 1
    PREMUL16 = 2


class GammaType(enum.IntEnum):
    """Gamma handling class (smolscale-private.h:159-166)."""

    SRGB_COMPRESSED = 0
    SRGB_LINEAR = 1


class StorageType(enum.IntEnum):
    """Internal storage class (smolscale-private.h:90-99).

    Only 64BPP / 128BPP are internal working formats; 24/32BPP classify
    external storage.  In this framework 64/128BPP name the *numeric
    contract* (8-bit values in 16-bit lanes vs up-to-24-bit values in 32-bit
    lanes), not a physical packing: we store one int32 plane per channel.
    """

    S24 = 0
    S32 = 1
    S64 = 2
    S128 = 3


# Byte-order channel layout per format.  Entry i names the logical channel
# stored in byte i of a pixel: 0,1,2 are color channels in canonical (R,G,B)
# order, 3 is alpha.  (Reference expresses the same content as u32 "order"
# arrays after LE reinterpretation, smolscale.c:45-75.)
_LAYOUTS = {
    PixelType.RGBA8_PREMULTIPLIED: (0, 1, 2, 3),
    PixelType.BGRA8_PREMULTIPLIED: (2, 1, 0, 3),
    PixelType.ARGB8_PREMULTIPLIED: (3, 0, 1, 2),
    PixelType.ABGR8_PREMULTIPLIED: (3, 2, 1, 0),
    PixelType.RGBA8_UNASSOCIATED: (0, 1, 2, 3),
    PixelType.BGRA8_UNASSOCIATED: (2, 1, 0, 3),
    PixelType.ARGB8_UNASSOCIATED: (3, 0, 1, 2),
    PixelType.ABGR8_UNASSOCIATED: (3, 2, 1, 0),
    PixelType.RGB8: (0, 1, 2),
    PixelType.BGR8: (2, 1, 0),
}

_ALPHA = {
    PixelType.RGBA8_PREMULTIPLIED: AlphaType.PREMUL8,
    PixelType.BGRA8_PREMULTIPLIED: AlphaType.PREMUL8,
    PixelType.ARGB8_PREMULTIPLIED: AlphaType.PREMUL8,
    PixelType.ABGR8_PREMULTIPLIED: AlphaType.PREMUL8,
    PixelType.RGBA8_UNASSOCIATED: AlphaType.UNASSOCIATED,
    PixelType.BGRA8_UNASSOCIATED: AlphaType.UNASSOCIATED,
    PixelType.ARGB8_UNASSOCIATED: AlphaType.UNASSOCIATED,
    PixelType.ABGR8_UNASSOCIATED: AlphaType.UNASSOCIATED,
    PixelType.RGB8: AlphaType.PREMUL8,
    PixelType.BGR8: AlphaType.PREMUL8,
}


class FormatMeta:
    """Static metadata for a :class:`PixelType`."""

    __slots__ = ("pixel_type", "layout", "alpha", "n_bytes", "storage")

    def __init__(self, pixel_type: PixelType):
        self.pixel_type = PixelType(pixel_type)
        self.layout = _LAYOUTS[self.pixel_type]
        self.alpha = _ALPHA[self.pixel_type]
        self.n_bytes = len(self.layout)
        self.storage = StorageType.S24 if self.n_bytes == 3 else StorageType.S32

    @property
    def has_alpha(self) -> bool:
        return self.n_bytes == 4

    # channel index (0..3 canonical) -> byte position within the pixel
    def byte_of_channel(self, channel: int) -> int:
        return self.layout.index(channel)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FormatMeta({self.pixel_type.name})"


_META = {pt: FormatMeta(pt) for pt in PixelType}


def get_meta(pixel_type: PixelType) -> FormatMeta:
    return _META[PixelType(pixel_type)]
