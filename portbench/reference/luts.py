"""Fixed-point lookup tables: sRGB<->linear and inverse-division-by-alpha.

Frozen copy of ``smolscale_tpu/luts.py`` for the benchmark's plain
reference (``portbench.reference``): it imports nothing of the JAX
package or of the port, and the benchmark holds the port to it.

Four of the six tables are generated at import time by ports of the
reference's offline tools (tools/gen-gamma.c:8-84 and a generalized
tools/gen-inv-div.c:3-40); tests/test_luts.py asserts byte-for-byte equality
with the tables compiled into the C reference (smolscale.c:87-262, 350-421)
via the ctypes oracle.

The two *lossy* inverse-division tables (INV_DIV_P8, INV_DIV_P8L) are
hand-tuned in the reference ("values tuned to minimize the error",
smolscale.c:268-273) and are not reproduced by any committed generator tool
(we verified the shipped tools/gen-inv-div.c output differs).  They are part
of the bit-exact numeric contract of the format, so they are embedded below
as data constants, provenance smolscale.c:276-347.  Empirically each entry
lies in the range of multipliers minimizing the worst-case premultiply
round-trip error for its alpha, but the exact tie-breaking rule was never
published.

All tables are plain numpy int64 arrays so both the numpy reference backend
and the JAX backends can consume them (JAX casts to int32/uint32 lanes).
"""

from __future__ import annotations

import functools
import math

import numpy as np

SRGB_LINEAR_BITS = 11
SRGB_LINEAR_MAX = 1 << SRGB_LINEAR_BITS

# Shifts used when applying the inverse-division tables
# (smolscale-private.h:320-323).
INVERTED_DIV_SHIFT_P8 = 21 - 8
INVERTED_DIV_SHIFT_P8L = 21 - SRGB_LINEAR_BITS
INVERTED_DIV_SHIFT_P16 = 24 - 8
INVERTED_DIV_SHIFT_P16L = 30 - SRGB_LINEAR_BITS


def _to_srgb_float(v: int) -> int:
    """11-bit linear -> 8-bit sRGB, the tool's float rounding (gen-gamma.c:8-15)."""
    f = v / float(SRGB_LINEAR_MAX - 1)
    f = f * 12.92 if f <= 0.0031308 else math.pow(f, 1.0 / 2.4) * 1.055 - 0.055
    return int(f * 255.5)


@functools.cache
def _gen_srgb_luts() -> tuple[np.ndarray, np.ndarray]:
    """Build (from_srgb[256] -> 11-bit, to_srgb[2048] -> 8-bit).

    Port of tools/gen-gamma.c:17-84; the fixups guarantee
    to_srgb[from_srgb[i]] == i for all i.
    """
    from_lut = np.zeros(256, dtype=np.int64)
    last_v = -1
    for i in range(256):
        f = i / 255.0
        f = f / 12.92 if f <= 0.04045 else math.pow((f + 0.055) / 1.055, 2.4)
        v = int(f * float(SRGB_LINEAR_MAX - 1) + 0.5)
        # Ensure reversibility.
        while i > _to_srgb_float(v):
            v += 1
        if v <= last_v:
            # Keep the low, linear part strictly increasing so it reverses.
            v = last_v + 1
        else:
            # Of a run of equal-mapping values, skip the lowest: better
            # precision under lossy alpha premultiplication.
            if _to_srgb_float(v) == _to_srgb_float(v + 1):
                v += 1
        v = min(v, 2047)
        from_lut[i] = v
        last_v = v

    to_lut = np.zeros(SRGB_LINEAR_MAX, dtype=np.int64)
    for i in range(SRGB_LINEAR_MAX):
        v = _to_srgb_float(i)
        if v > last_v + 1:
            v = last_v + 1
        to_lut[i] = v
        last_v = v
    return from_lut, to_lut


@functools.cache
def _gen_inv_div_lut(max_value: int, shift: int) -> np.ndarray:
    """Lossless inverse-division table: divide by alpha in [1,255] by mul+shift.

    Generalization of tools/gen-inv-div.c:10-34: entry f is the first value
    at/above the seed such that (max_value*i*f) >> shift == max_value exactly,
    i.e. the top of the value range round-trips losslessly.

    The shipped lossless tables correspond to:
      p16  -> max 0xff,  shift 16 (== INVERTED_DIV_SHIFT_P16)
      p16l -> max 0x7ff, shift 19 (== INVERTED_DIV_SHIFT_P16L)
    """
    lut = np.zeros(256, dtype=np.int64)
    for i in range(1, 256):
        f = ((1 << shift) + i // 2) // i - 100
        while ((max_value * i * f) >> shift) < max_value:
            f += 1
        if ((max_value * i * f) >> shift) > max_value:
            f -= 1
        lut[i] = f
    return lut


# Hand-tuned lossy tables, embedded as numeric-contract data.  The
# reference ships no generator for these (tools/gen-inv-div.c covers only
# the lossless p16/p16l rule, reproduced by _gen_inv_div_lut above);
# tests/test_luts_p8_analysis.py demonstrates with witnesses that neither
# the published rule nor round-trip L1/L2 error minimization reproduces
# them, and pins the partial top-anchor structure they do have.  Byte
# equality against the reference's own symbols is enforced by
# tests/test_luts.py.
# Provenance: smolscale.c:276-310 (_smol_inv_div_p8_lut).
_INV_DIV_P8_DATA = (
    0x00000000, 0x00181fff, 0x000e2fff, 0x0009f555, 0x0007a7ff, 0x00063333, 0x00052555, 0x00047999,
    0x0003ebff, 0x0003838e, 0x00032333, 0x0002e2e8, 0x0002a2aa, 0x0002713b, 0x00024249, 0x00021ccc,
    0x0001f924, 0x0001dd17, 0x0001c1c7, 0x0001ab4b, 0x000195e5, 0x0001830c, 0x000170c3, 0x00016164,
    0x0001537a, 0x0001450d, 0x0001390b, 0x00012de9, 0x00012249, 0x00011846, 0x00010eaa, 0x0001069e,
    0x0000fd70, 0x0000f6aa, 0x0000eedb, 0x0000e8f5, 0x0000e1c7, 0x0000db8e, 0x0000d638, 0x0000d069,
    0x0000cb7c, 0x0000c690, 0x0000c186, 0x0000bd2d, 0x0000b8f9, 0x0000b4f7, 0x0000b0ff, 0x0000ad65,
    0x0000a9ac, 0x0000a687, 0x0000a286, 0x00009f33, 0x00009c98, 0x000099b9, 0x000096f1, 0x00009414,
    0x00009147, 0x00008efa, 0x00008c59, 0x00008a0a, 0x000087b4, 0x0000856c, 0x00008341, 0x0000818c,
    0x00007f55, 0x00007d60, 0x00007b7f, 0x000079b2, 0x000077b9, 0x00007608, 0x0000743c, 0x000072b5,
    0x0000711a, 0x00006fac, 0x00006e1a, 0x00006cad, 0x00006b17, 0x000069e1, 0x00006864, 0x00006736,
    0x000065db, 0x000064b1, 0x00006357, 0x00006250, 0x000060c5, 0x00006060, 0x00005ec0, 0x00005da5,
    0x00005c9b, 0x00005b8b, 0x00005a93, 0x000059ab, 0x00005884, 0x00005799, 0x000056ae, 0x000055d5,
    0x000054e2, 0x0000540b, 0x00005343, 0x00005255, 0x0000517c, 0x000050a7, 0x00004fff, 0x00004f2c,
    0x00004e5e, 0x00004d9f, 0x00004cec, 0x00004c34, 0x00004b78, 0x00004adc, 0x00004a23, 0x00004981,
    0x000048ce, 0x00004836, 0x0000478c, 0x000046eb, 0x00004656, 0x000045b6, 0x00004524, 0x0000449c,
    0x000043ff, 0x00004370, 0x000042e2, 0x00004257, 0x000041ce, 0x00004147, 0x000040c3, 0x00004081,
    0x00003fff, 0x00003f57, 0x00003ed3, 0x00003e54, 0x00003dd9, 0x00003d60, 0x00003ced, 0x00003c78,
    0x00003c07, 0x00003b9a, 0x00003b26, 0x00003abf, 0x00003a4f, 0x000039e1, 0x0000397e, 0x00003917,
    0x000038af, 0x00003848, 0x000037ee, 0x00003787, 0x00003726, 0x000036c9, 0x0000366b, 0x0000360d,
    0x000035b0, 0x00003567, 0x00003503, 0x000034aa, 0x00003453, 0x000033ff, 0x000033a8, 0x0000335c,
    0x00003305, 0x000032b3, 0x00003266, 0x00003213, 0x000031c7, 0x00003178, 0x0000312b, 0x000030df,
    0x00003094, 0x00003049, 0x00003018, 0x00002fc0, 0x00002f76, 0x00002f2d, 0x00002ee8, 0x00002ea6,
    0x00002e5f, 0x00002e1c, 0x00002dd9, 0x00002d99, 0x00002d59, 0x00002d17, 0x00002cdf, 0x00002c9b,
    0x00002c5d, 0x00002c1c, 0x00002be1, 0x00002ba6, 0x00002b6a, 0x00002b2e, 0x00002af3, 0x00002ac7,
    0x00002a85, 0x00002a4a, 0x00002a11, 0x000029dc, 0x000029a6, 0x0000296e, 0x00002936, 0x00002904,
    0x000028cd, 0x0000289a, 0x00002866, 0x00002833, 0x0000280a, 0x000027d0, 0x0000279e, 0x0000276f,
    0x0000273c, 0x0000270d, 0x000026de, 0x000026ad, 0x0000267e, 0x00002652, 0x00002622, 0x000025f5,
    0x000025c9, 0x0000259b, 0x0000256f, 0x00002545, 0x00002518, 0x000024ef, 0x000024c3, 0x0000249c,
    0x0000246f, 0x00002446, 0x0000241c, 0x000023f4, 0x000023ca, 0x000023a2, 0x0000237b, 0x00002354,
    0x0000232e, 0x00002306, 0x000022e0, 0x000022b9, 0x00002294, 0x0000226f, 0x0000224b, 0x00002226,
    0x00002202, 0x000021dc, 0x000021b8, 0x00002195, 0x00002172, 0x0000214f, 0x0000212c, 0x0000210a,
    0x000020e7, 0x000020c5, 0x000020a4, 0x00002083, 0x00002061, 0x00002041, 0x00002020, 0x00002020,
)

# Provenance: smolscale.c:313-347 (_smol_inv_div_p8l_lut).
_INV_DIV_P8L_DATA = (
    0x00000000, 0x0003f2db, 0x0001fc3f, 0x0001542a, 0x0000ff4d, 0x0000cc4b, 0x0000aa5b, 0x0000921b,
    0x00007fd2, 0x0000719c, 0x0000663a, 0x00005d02, 0x00005534, 0x00004ead, 0x00004902, 0x00004422,
    0x00003fe9, 0x00003c1e, 0x000038ce, 0x000035d9, 0x0000331d, 0x000030ab, 0x00002e77, 0x00002c72,
    0x00002a98, 0x000028e4, 0x00002756, 0x000025e0, 0x00002485, 0x00002342, 0x00002217, 0x00002101,
    0x00001ff5, 0x00001f00, 0x00001e13, 0x00001d39, 0x00001c6a, 0x00001ba3, 0x00001ae9, 0x00001a39,
    0x00001992, 0x000018f3, 0x0000185b, 0x000017c9, 0x00001740, 0x000016bb, 0x0000163d, 0x000015c4,
    0x00001550, 0x000014e0, 0x00001476, 0x0000140f, 0x000013ad, 0x0000134e, 0x000012f2, 0x0000129a,
    0x00001245, 0x000011f3, 0x000011a3, 0x00001157, 0x0000110d, 0x000010c6, 0x00001080, 0x0000103d,
    0x00000ffd, 0x00000fbe, 0x00000f80, 0x00000f46, 0x00000f0c, 0x00000ed4, 0x00000e9e, 0x00000e69,
    0x00000e36, 0x00000e04, 0x00000dd4, 0x00000da5, 0x00000d77, 0x00000d4a, 0x00000d1e, 0x00000cf4,
    0x00000cca, 0x00000ca2, 0x00000c7a, 0x00000c54, 0x00000c2e, 0x00000c0a, 0x00000be6, 0x00000bc3,
    0x00000ba1, 0x00000b7f, 0x00000b5f, 0x00000b3f, 0x00000b1f, 0x00000b01, 0x00000ae3, 0x00000ac5,
    0x00000aa9, 0x00000a8d, 0x00000a71, 0x00000a56, 0x00000a3c, 0x00000a22, 0x00000a08, 0x000009ef,
    0x000009d7, 0x000009bf, 0x000009a7, 0x00000990, 0x0000097a, 0x00000963, 0x0000094e, 0x00000938,
    0x00000923, 0x0000090e, 0x000008fa, 0x000008e6, 0x000008d2, 0x000008bf, 0x000008ac, 0x00000899,
    0x00000887, 0x00000875, 0x00000863, 0x00000852, 0x00000841, 0x00000830, 0x0000081f, 0x0000080f,
    0x000007ff, 0x000007ef, 0x000007df, 0x000007d0, 0x000007c0, 0x000007b2, 0x000007a3, 0x00000794,
    0x00000786, 0x00000778, 0x0000076a, 0x0000075d, 0x0000074f, 0x00000742, 0x00000735, 0x00000728,
    0x0000071b, 0x0000070f, 0x00000702, 0x000006f6, 0x000006ea, 0x000006de, 0x000006d3, 0x000006c7,
    0x000006bc, 0x000006b0, 0x000006a5, 0x0000069a, 0x0000068f, 0x00000685, 0x0000067a, 0x00000670,
    0x00000665, 0x0000065b, 0x00000651, 0x00000647, 0x0000063e, 0x00000634, 0x0000062a, 0x00000621,
    0x00000618, 0x0000060e, 0x00000605, 0x000005fc, 0x000005f3, 0x000005ea, 0x000005e2, 0x000005d9,
    0x000005d1, 0x000005c8, 0x000005c0, 0x000005b8, 0x000005b0, 0x000005a8, 0x000005a0, 0x00000598,
    0x00000590, 0x00000588, 0x00000581, 0x00000579, 0x00000572, 0x0000056a, 0x00000563, 0x0000055c,
    0x00000555, 0x0000054e, 0x00000547, 0x00000540, 0x00000539, 0x00000532, 0x0000052b, 0x00000525,
    0x0000051e, 0x00000518, 0x00000511, 0x0000050b, 0x00000504, 0x000004fe, 0x000004f8, 0x000004f2,
    0x000004ec, 0x000004e6, 0x000004e0, 0x000004da, 0x000004d4, 0x000004ce, 0x000004c8, 0x000004c3,
    0x000004bd, 0x000004b7, 0x000004b2, 0x000004ac, 0x000004a7, 0x000004a2, 0x0000049c, 0x00000497,
    0x00000492, 0x0000048d, 0x00000487, 0x00000482, 0x0000047d, 0x00000478, 0x00000473, 0x0000046e,
    0x00000469, 0x00000465, 0x00000460, 0x0000045b, 0x00000456, 0x00000452, 0x0000044d, 0x00000448,
    0x00000444, 0x0000043f, 0x0000043b, 0x00000436, 0x00000432, 0x0000042d, 0x00000429, 0x00000425,
    0x00000421, 0x0000041c, 0x00000418, 0x00000414, 0x00000410, 0x0000040c, 0x00000408, 0x00000404,
)


_FROM_SRGB, _TO_SRGB = _gen_srgb_luts()
FROM_SRGB: np.ndarray = _FROM_SRGB
TO_SRGB: np.ndarray = _TO_SRGB
INV_DIV_P8: np.ndarray = np.array(_INV_DIV_P8_DATA, dtype=np.int64)
INV_DIV_P8L: np.ndarray = np.array(_INV_DIV_P8L_DATA, dtype=np.int64)
INV_DIV_P16: np.ndarray = _gen_inv_div_lut(0xFF, INVERTED_DIV_SHIFT_P16)
INV_DIV_P16L: np.ndarray = _gen_inv_div_lut(0x7FF, INVERTED_DIV_SHIFT_P16L)
