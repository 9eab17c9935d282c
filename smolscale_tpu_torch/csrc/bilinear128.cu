// The 128bpp scale for Hopper (sm_90a): per axis a bilinear 0h-6h halving
// ladder, a box with fractional edge weights, COPY or ONE, at 128bpp
// storage, internal PREMUL8 or PREMUL16, compressed gamma or sRGB linear
// light; 3- or 4-byte pixels in and out.
//
// Replaces three Pallas TPU kernels: smolscale_tpu/ops/pallas_128.py
// `_make_kernel` (:86, built by `_built`, pallas_call at :314: compressed
// gamma, internal PREMUL16 or the deep-box PREMUL8), and
// smolscale_tpu/ops/pallas_srgb.py `_make_kernel` (:162, `_built`, :364:
// linear light, PREMUL16-linear or PREMUL8-linear) with its 24bpp planes
// form `_built_planes` (:415, :459), together with the pack that follows
// each in backends/xla.py `_pack`.  The three are TPU tilings of one
// pipeline that differ only in the unpack and pack: unpack at the plan's
// (alpha, gamma) (pixels.cuh), the filter of each axis at 128bpp masks,
// pack.  The COPY and ONE axes, which those kernels leave to the XLA op
// graph, run here too.  Their limb-split gather matmuls, 128-lane
// dynamic-gather LUT (`lut_gather`, `_lut_tables`) and int32 output planes
// exist for the MXU and Mosaic; this kernel computes what
// backends/numpy_ref.py `hfilter` / `vfilter` specify, one thread per
// output pixel (i, j), as bilinear.cu does at 64bpp:
//
//   for each tap row r of the V filter of output row i, the H-filtered value
//   h(r, j), rounded on its own:
//     BILINEAR, n halvings: sample k of output j is table entry s = j*2^n + k,
//       lerp(px[ofs[s]], px[ofs[s]+1], F[s]) = (((p - q)*F >> 8) + q) & M
//       with an arithmetic (floor) shift, then ((sum of the 2^n samples)
//       >> n) & M;
//     BOX: ((px[first]*w_first >> 8) & M) + px[mid..mid+len)
//       + ((px[last]*w_last >> 8) & M), then ((acc*span_mul + 2^23) >> 24) & N;
//     COPY: px[j];  ONE: px[0] -- one template kind, px[j*stride] with a
//       stride of 1 or 0 set at run time, so the two cost one kind's
//       instances;
//   then the same filter over the h values of the tap rows, and the pack
//   fused into the store (this replaces the TPU's int32 planes and the XLA
//   pack, the 24bpp linear pack asymmetry included).
//
// M is the 128bpp working mask 0xffffff, N the normalised mask 0xffff
// (numpy_ref._scale_span: a box value is cut to 16 bits; COPY and ONE pass
// their unpacked value on, which is below M, and normalise nothing).  The V
// box table weights its last row by max(frac - 1, 0) (scale_outrow_box_128bpp,
// generic.c:2198-2260; ops/bilinear.axis_table at S128).  Pixels are
// unpacked where they are loaded, by one of three readers (Px): a 4-byte
// pixel as one word (4-byte aligned input) or as four bytes, unpacked at the
// plan's (alpha, gamma) with linear light's FROM_SRGB and INV_DIV_P8 in a
// per-block shared-memory copy; and a 3-byte pixel at internal PREMUL8 (the
// only alpha 3-byte pixels are planned at) as three bytes, each unpacked by
// one entry of a 256-entry table that folds the unpremultiply at alpha 255,
// FROM_SRGB and the 11-bit premultiply (ops/pixels.unpack24_table, also in
// shared memory; at compressed gamma the byte itself), with the constant
// alpha 255 -- this replaces #12's planes feed and its folded table row.  A
// 3-byte bilinear column's samples (at most 4) are loaded once into
// registers, so that a pass's pixel loads are all in flight, and a sample's
// two pixels (six bytes) come from the two or three aligned words that hold
// them (pixels.cuh unpack24_pair), in place of six byte loads.  The PREMUL16
// alpha (a << 8) | 0x80 is filtered like a colour.  `row0` is the first
// output row computed (the row API).
//
// Tiles.  A block of 256 threads covers a tile of 32 output columns by 8
// rows (tile_w = 1-16 columns by 256-16 rows where w_out is narrower, so no
// thread idles on a 1-7 or 64 pixel wide output).  Nothing is divided per
// output pixel; indices are 32-bit within an image (only an image's and a
// row's base offset are 64-bit); no register array is indexed at run time
// (nvcc would put it in local memory): pixels.cuh's pack picks alpha with a
// select and swizzles the output bytes with one __byte_perm.  Neighbouring
// threads take neighbouring output columns, so a warp's loads of one tap row
// fall into one contiguous stretch that L1 serves, and its stores into one
// 128-byte line.  Three forms, chosen on the host (ops/bilinear128.form):
//
//   LOOP (every plan): block (x, y, z) takes column tile x, row groups y,
//     y + grid_y, ... of the range and images z, z + grid_z, ...
//     (ops/bilinear.launch_shape: about 16 blocks per SM, so each block
//     copies its tables once for several row groups; grid y and z below
//     2^16).  Each thread walks the V taps of its output pixel and H-filters
//     each tap row from global memory: a V sample's two rows (r, r + 1) -- a
//     V box's edge rows, and its mid rows two by two -- go through one pass
//     of the H samples, so each X table word is loaded once per pair and two
//     rows' loads are in flight; COPY x COPY takes two row groups per turn
//     with both loads first.  A tap row is H-filtered again for every output
//     row that reads it.
//   H TILE (3-byte input where each output row reads three tap rows or
//     more -- a V ladder of 1 or more halvings, a V box -- and the tile
//     fits): row groups are counted from output row 0
//     (ops/bilinear.launch_shape), and a row group's output rows read a
//     contiguous range of tap rows [r_lo, r_hi) (a host table per row group,
//     ops/bilinear.row_windows).  The block H-filters each (tap row, column)
//     of its tile once, all of them at once, two tap rows per pass of a
//     thread's H samples, and keeps each result in shared memory as a cell
//     of two words, 16 bits per channel; then each thread runs the V filter,
//     of a kind read at run time, over its column's cells, packs and stores.
//     The cells are sized per plan (h_cells, at most kHCells: 32 KB), which
//     leaves the rest of the SM to L1.  A 0h V axis stays on LOOP, upscales
//     included: there the two barriers per row group cost more than the
//     shared H values save.
//   ROLL (4-byte pixels in and out, with a 0-halving bilinear V axis beside
//     a BILINEAR, COPY or ONE X axis, at internal PREMUL16 compressed --
//     unassociated pixels in and out: upstream's format-conversion pairs
//     between unassociated types, the farm's 2:1 level of unassociated
//     images -- or at P8-linear -- sRGB linear light with a premultiplied
//     side: the linear sweep's 0h upscales and downscales, a video field
//     halved in linear light), bilinear.cu's direct_roll at 128bpp.  The V
//     window only slides down, by 0 or 1 tap rows per output row on an
//     upscale and by 1 or 2 on a downscale (0h stops at 0.5x).  A lane owns
//     4 consecutive output columns (their X samples loaded once, into
//     registers, as offset << 9 | F) and walks a strip of strip_rows output
//     rows (ops/bilinear.roll_shape) top to bottom, holding the H values of
//     tap rows ofs_y[i] and ofs_y[i] + 1 of its 4 columns, 4 channels each,
//     in registers: on a step of one row it H-filters the new bottom row
//     alone, on a step of two both rows.  Each output row is then one V lerp
//     per channel, the pack, and one aligned 16-byte store of 4 pixels, the
//     lanes passing their pixels on with one shuffle as each row's alignment
//     asks; no barrier but the one after P8-linear copies its unpack and
//     pack tables into shared memory (TO_SRGB as 2 KB of bytes; its pack
//     gathered them from global memory 11% slower on srgb up-2.0, PERF.md
//     §6).  A pixel is rotated as it loads so that alpha is its byte 3, and
//     neither the unpack nor the pack picks alpha per channel.  LOOP
//     H-filtered both tap rows again for every output pixel -- on a
//     downscale by a pixel every input row twice, each time with the X table
//     loaded before the pixels, the unpack and a 4-byte store; in linear
//     light each unpack is three FROM_SRGB lookups and, for premultiplied
//     input, an INV_DIV_P8 one, so a 2x upscale unpacked each input pixel
//     about 16 times, ROLL about 4 (one per output pixel).
//     Measured and dropped (PERF.md §6): a column's left pixel taken from
//     the column before, INV_DIV_P16 in shared memory or computed by a
//     reciprocal, and 4 blocks per SM (a spill) at PREMUL16; at P8-linear
//     the held H values as two 16-bit channels a word (slower at 3 blocks
//     per SM and at 4), and the unpack tables copied 16 or 32 times across
//     the banks (slower).
//
// What bounds it (PERF.md §6).  Not bytes: the latency of each bilinear
// sample's table load before its pixel loads (rows 6, 7); linear light's
// TO_SRGB gathered from global memory in the pack and FROM_SRGB from
// bank-conflicted shared memory in the unpack (a1-srgb-field).  On 3-byte
// pixels: the pixels unpacked per input pixel (on 6b ~1.6 in H TILE, where
// neighbouring columns' samples overlap, against ~2.7 in LOOP), each a
// lookup per colour in a bank-conflicted shared table after its share of a
// pair's word loads, and H TILE's two barriers per row group.  Left out,
// measured: tiles up to 256 columns wide, a 4-byte bilinear axis's samples
// held in registers (faster on rows 6 and 7, slower on the COPY rows), the
// pack's tables in shared memory (TO_SRGB as 2 KB of bytes too: no faster on
// the 3-byte rows), and a third form that unpacked each tile's stretch of the
// tap rows once into shared memory for the H pass to read (slower than H
// TILE or LOOP on every 3-byte row).  Not built: a split of one box span
// over several threads (a box axis of thousands to one beside a bilinear
// axis walks its span in one thread).
//
// Arithmetic and its bounds:
//   unpacked values are at most 2047*255 = 521985 (PREMUL16 linear), so
//   |p - q|*F < 2^19 * 2^8 = 2^27 and the lerp is exact in int32 with an
//   arithmetic shift; a halving sum is at most 64 * 2^24 < 2^31;
//   box span sums are unsigned 32-bit: an H or V span holds at most
//   dim_in <= 65535 values, of at most 65408 at compressed gamma (65535 *
//   65408 < 2^32) and of at most 521985 in linear light, which is planned
//   only up to 8191:1 (smolscale.c:760-770; 8193 * 521985 < 2^32) -- the
//   bounds deep.cu proves;
//   H TILE's cells hold 16 bits per channel: its plans are 3-byte PREMUL8,
//   whose unpacked values are at most 2040 (linear light) or 255 and whose
//   alpha is 255; a lerp lies between its two values and a halving sum's
//   mean within its samples' range, so a bilinear, COPY or ONE H value stays
//   below 2^11, and a box H value is cut to 0xffff (N);
//   the normalising multiply is 64-bit;
//   ROLL lerps as (p*F + q*(256 - F)) >> 8 in unsigned 32 bits: that is
//   floor(((p - q)*F + 256*q) / 256), the lerp above, for every F in
//   [0, 256], and p*F + q*(256 - F) <= 2^8 * max(p, q) < 2^32 for working
//   values below 2^24 -- at P8-linear, colours of at most 2040 and alpha of
//   at most 255, it is below 2^19; the result lies between p and q, so the
//   mask changes nothing (tests/test_torch_bilinear128.py holds the
//   identity, for every pair of P8-linear values too);
//   ROLL's P8-linear unpack (unpack8l) multiplies a byte by INV_DIV_P8
//   (below 2^29) and FROM_SRGB + 1 by 8a + 1 (below 2^23), and gives
//   colours of at most 2040; a lerp and a halving mean lie within their
//   values, so ROLL's pack reads colours of at most 2040 and alpha of at
//   most 255, and the colour's product with INV_DIV_P8L (at most 258779) is
//   below 2^29 (the same test file holds these bounds);
//   an image's and a row's base offsets are 64-bit (8 x 2048^2 x 4 bytes is
//   128 MiB, larger inputs pass 2^31); a table index is below 65535 * 2^6 <
//   2^22 and an offset within a row below 65535 * 4 < 2^18.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixels.cuh"

// Launch parameters; the field order and the all-int64 layout match the
// ctypes Structure in ops/bilinear128.py.
struct Bilinear128Params {
  int64_t batch, h_in, w_in, h_out, w_out;
  int64_t row0, n_rows;            // output rows [row0, row0 + n_rows)
  int64_t kind_x, kind_y;          // kCopy, kOne, kBilinear or kBox
  int64_t halvings_x, halvings_y;  // n of a BILINEAR axis
  int64_t len_x, len_y;            // table row length: dim_bilin or dim_out
  int64_t span_mul_x, span_mul_y;  // BOX normalisation
  int64_t mode;                    // Mode
  int64_t tile_w;                  // output columns per block: a power of two <= kThreads
  int64_t grid_y, grid_z;          // blocks over a column tile's row groups, over the batch
  int64_t nb_in, nb_out;
  int64_t alpha_ch;                // work channel holding alpha: 0 or 3
  int64_t unassoc_in, unassoc_out;
  int64_t pack24_direct;           // plan.pack24_linear_direct
  int64_t src[4];                  // output byte k <- work channel src[k]
  int64_t form;                    // Form
  int64_t h_cells;                 // H TILE: cells of the h tile
  int64_t strip_rows;              // ROLL: output rows a lane walks
};

namespace {

// axis kinds, ops/bilinear.COPY, ONE, BILINEAR and BOX; kCopy is also the
// template kind of ONE (stride 0)
constexpr int kCopy = 0, kOne = 1, kBilinear = 2, kBox = 3;
constexpr uint32_t kWorkMask = 0xffffff, kNormMask = 0xffff;
constexpr int kThreads = 256;
// pixel readers: a 4-byte pixel as one word (4-byte aligned input) or as
// four bytes; a 3-byte pixel at internal PREMUL8 through unpack24
enum Px { kWord = 0, kBytes = 1, kRgb = 2 };
// the forms (ops/bilinear128.LOOP, H_TILE, ROLL); H TILE reads the V kind
// at run time, its template KY is kAnyY; ROLL's is kBilinear
enum Form { kLoop = 0, kHTile = 1, kRoll = 2 };
constexpr int kAnyY = 4;
// ROLL's X kind for a BILINEAR axis of 1 or 2 halvings (kBilinear: none)
constexpr int kLadder = 5;
// the h tile's largest size in cells: ops/bilinear128.H_CELLS
constexpr int kHCells = 4096;

__device__ __forceinline__ uint32_t lerp(uint32_t p, uint32_t q, int32_t f) {
  // numpy_ref._lerp: (p - q)*f is negative when p < q; >> floors it
  const int32_t d = static_cast<int32_t>(p) - static_cast<int32_t>(q);
  return static_cast<uint32_t>(((d * f) >> 8) + static_cast<int32_t>(q)) & kWorkMask;
}

// H TILE keeps an H value in a cell of two words, 16 bits per channel.
__device__ __forceinline__ uint2 cell(const uint32_t v[4]) {
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

__device__ __forceinline__ void from_cell(uint2 w, uint32_t v[4]) {
  v[0] = w.x & 0xffff;
  v[1] = w.x >> 16;
  v[2] = w.y & 0xffff;
  v[3] = w.y >> 16;
}

// The H filter of one output column j, with its X table words loaded once:
// the H-filtered values of N input rows (1 or 2) in one pass, so that the
// rows share those loads and their pixel loads are in flight together.
template <int KX, int MODE, int PX>
struct Columns {
  Fmt f;
  const int32_t* lut;  // shared: FROM_SRGB and INV_DIV_P8, or unpack24's fold (kRgb)
  const int32_t* tab;  // kBilinear: column j's first table entry, j << n
  int len, n;          // kBilinear: table row length, halvings
  int x;               // kCopy: column j * stride (1 for COPY, 0 for ONE)
  int first, w_first, mid, n_mid, last, w_last;  // kBox: column j's table entries
  int64_t span_mul;
  // kBilinear, 3-byte pixels: column j's samples, loaded once (at most 4:
  // the planner's ladders have n <= 2, a ratio past 8:1 being a box)
  int sample_ofs[4], sample_f[4];

  __device__ __forceinline__ Columns(const Fmt& fmt, const int32_t* s_lut,
                                     const int32_t* __restrict__ tab_x,
                                     const Bilinear128Params& p, int j)
      : f(fmt), lut(s_lut), tab(tab_x), len(static_cast<int>(p.len_x)),
        n(static_cast<int>(p.halvings_x)), x(p.kind_x == kCopy ? j : 0), first(0),
        w_first(0), mid(0), n_mid(0), last(0), w_last(0), span_mul(p.span_mul_x) {
    if (KX == kBilinear) tab = tab_x + (j << n);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool on = KX == kBilinear && PX == kRgb && k < (1 << n);
      sample_ofs[k] = on ? __ldg(tab + k) : 0;
      sample_f[k] = on ? __ldg(tab + len + k) : 0;
    }
    if (KX == kBox) {
      const int32_t* t = tab_x + j;
      first = __ldg(t);
      w_first = __ldg(t + len);
      mid = __ldg(t + 2 * len);
      n_mid = __ldg(t + 3 * len);
      last = __ldg(t + 4 * len);
      w_last = __ldg(t + 5 * len);
    }
  }

  __device__ __forceinline__ void pixel(const uint8_t* row, int i, uint32_t v[4]) const {
    if constexpr (PX == kRgb)
      unpack24<MODE>(row + i * 3, lut, v);
    else
      unpack<MODE>(load_pixel<PX == kWord>(row, i, f), f, lut, v);
  }

  template <int N>
  __device__ __forceinline__ void operator()(const uint8_t* const (&rows)[N],
                                             uint32_t (&v)[N][4]) const {
    if constexpr (KX == kCopy) {
#pragma unroll
      for (int m = 0; m < N; ++m) pixel(rows[m], x, v[m]);
    } else if constexpr (KX == kBilinear && PX == kRgb) {
      // as below, the samples from registers, so that all of a pass's pixel
      // loads are in flight, and each sample's two 3-byte pixels from one
      // cover of words
      uint32_t sum[N][4] = {};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < (1 << n)) {
#pragma unroll
          for (int m = 0; m < N; ++m) {
            uint32_t a[4], b[4];
            unpack24_pair<MODE>(rows[m] + sample_ofs[k] * 3, lut, a, b);
#pragma unroll
            for (int c = 0; c < 4; ++c) sum[m][c] += lerp(a[c], b[c], sample_f[k]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < N; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[m][c] = (sum[m][c] >> n) & kWorkMask;
    } else if constexpr (KX == kBilinear) {
      // sample k of output j: lerp(px[ofs], px[ofs + 1], F), then the
      // halving sum
      uint32_t sum[N][4] = {};
      for (int k = 0; k < (1 << n); ++k) {
        const int o = __ldg(tab + k);
        const int32_t fx = __ldg(tab + len + k);
#pragma unroll
        for (int m = 0; m < N; ++m) {
          uint32_t a[4], b[4];
          pixel(rows[m], o, a);
          pixel(rows[m], o + 1, b);
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[m][c] += lerp(a[c], b[c], fx);
        }
      }
#pragma unroll
      for (int m = 0; m < N; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[m][c] = (sum[m][c] >> n) & kWorkMask;
    } else {  // kBox
      uint32_t acc[N][4], t[4];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        pixel(rows[m], first, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = weigh(t[c], w_first, kWorkMask);
        pixel(rows[m], last, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] += weigh(t[c], w_last, kWorkMask);
      }
#pragma unroll 4
      for (int i = mid; i < mid + n_mid; ++i) {
#pragma unroll
        for (int m = 0; m < N; ++m) {
          pixel(rows[m], i, t);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] += t[c];
        }
      }
#pragma unroll
      for (int m = 0; m < N; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[m][c] = normalise(acc[m][c], span_mul, kNormMask);
    }
  }
};

// H TILE: the H values of one column of the tile by input row, from its
// cells (row r_lo is the tile's first; a column's cells are 2^shift apart).
struct TileCells {
  const uint2* s;
  int shift, r_lo;

  template <int N>
  __device__ __forceinline__ void operator()(const int (&r)[N], uint32_t (&v)[N][4]) const {
#pragma unroll
    for (int m = 0; m < N; ++m) from_cell(s[(r[m] - r_lo) << shift], v[m]);
  }
};

// Output row i of a V axis of kind KY over the H values that `h` gives by
// input row: h(rows, v) fills v[m] for rows[m] = row(r) (N of 1 or 2) --
// LOOP's rows are pointers into the image (Columns), H TILE's their indices
// (TileCells).  Each V sample's pair of rows (r, r + 1), and a box's edge
// rows and mid rows two by two, go through one call.
template <int KY, class H, class Row>
__device__ __forceinline__ void vfilter(const H& h, const Row& row,
                                        const int32_t* __restrict__ tab,
                                        const Bilinear128Params& p, int i, uint32_t o[4]) {
  using R = decltype(row(0));
  if constexpr (KY == kCopy) {
    const R rows[1] = {row(p.kind_y == kCopy ? i : 0)};
    uint32_t v[1][4];
    h(rows, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = v[0][c];
  } else if constexpr (KY == kBilinear) {
    const int n = static_cast<int>(p.halvings_y), len = static_cast<int>(p.len_y);
    const int32_t* t = tab + (i << n);
    uint32_t sum[4] = {0, 0, 0, 0};
    for (int k = 0; k < (1 << n); ++k) {
      const int r = __ldg(t + k);
      const int32_t fy = __ldg(t + len + k);
      const R rows[2] = {row(r), row(r + 1)};
      uint32_t v[2][4];
      h(rows, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += lerp(v[0][c], v[1][c], fy);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = (sum[c] >> n) & kWorkMask;
  } else {  // kBox
    const int len = static_cast<int>(p.len_y);
    const int32_t* t = tab + i;
    const uint32_t w_first = __ldg(t + len), w_last = __ldg(t + 5 * len);
    const int mid = __ldg(t + 2 * len), mid_end = mid + __ldg(t + 3 * len);
    uint32_t acc[4], v[2][4];
    {
      const R rows[2] = {row(__ldg(t)), row(__ldg(t + 4 * len))};
      h(rows, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[c] = weigh(v[0][c], w_first, kWorkMask) + weigh(v[1][c], w_last, kWorkMask);
    }
    int r = mid;
    for (; r + 1 < mid_end; r += 2) {
      const R rows[2] = {row(r), row(r + 1)};
      h(rows, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[0][c] + v[1][c];
    }
    if (r < mid_end) {
      const R rows[1] = {row(r)};
      uint32_t v1[1][4];
      h(rows, v1);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v1[0][c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = normalise(acc[c], p.span_mul_y, kNormMask);
  }
}

// LOOP.  A block of kThreads threads covers a tile of tile_w consecutive
// output columns (thread t: column t % tile_w) by kThreads / tile_w
// consecutive output rows (row t / tile_w); block (x, y, z) takes column
// tile x, row groups y, y + grid_y, ... of the range and images z, z +
// grid_z, ....  COPY x COPY takes two row groups per turn, both loads first.
template <int KX, int KY, int MODE, int PX>
__device__ __forceinline__ void direct_loop(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const int32_t* __restrict__ luts,
                                            const int32_t* __restrict__ fold,
                                            const int32_t* __restrict__ tab_x,
                                            const int32_t* __restrict__ tab_y,
                                            const Bilinear128Params& p) {
  constexpr bool kLinear = MODE == kP8Linear || MODE == kP16Linear;
  constexpr int kTurn = KX == kCopy && KY == kCopy ? 2 : 1;
  __shared__ int32_t s_lut[!kLinear ? 1 : PX == kRgb ? 256 : 512];
  if constexpr (kLinear && PX == kRgb)
    load_unpack24_lut(fold, s_lut);
  else if constexpr (kLinear)
    load_unpack_luts(luts, s_lut);
  const int tile_w = static_cast<int>(p.tile_w), shift = __ffs(tile_w) - 1;
  const int j = static_cast<int>(blockIdx.x) * tile_w + (threadIdx.x & (tile_w - 1));
  const int w_out = static_cast<int>(p.w_out), n_rows = static_cast<int>(p.n_rows);
  if (j >= w_out) return;
  const Fmt f{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const Columns<KX, MODE, PX> h(f, s_lut, tab_x, p, j);
  const unsigned perm = out_perm(p);
  const int nb_out = static_cast<int>(p.nb_out);
  const int row_bytes = static_cast<int>(p.w_in * p.nb_in), out_row = w_out * nb_out;
  const int tile_h = kThreads >> shift, step = static_cast<int>(gridDim.y) * tile_h;
  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * p.h_in * row_bytes;
    const auto row = [&](int r) { return img + static_cast<int64_t>(r) * row_bytes; };
    uint8_t* dst = out + b * n_rows * out_row + j * nb_out;
    for (int ir = static_cast<int>(blockIdx.y) * tile_h + (threadIdx.x >> shift);
         ir < n_rows; ir += kTurn * step) {
      uint32_t o[kTurn][4];
#pragma unroll
      for (int u = 0; u < kTurn; ++u)
        vfilter<KY>(h, row, tab_y, p, static_cast<int>(p.row0) + min(ir + u * step, n_rows - 1),
                    o[u]);
#pragma unroll
      for (int u = 0; u < kTurn; ++u)
        if (ir + u * step < n_rows)
          store_pixel(pack_word<MODE>(o[u], p, luts, perm), nb_out,
                      dst + static_cast<int64_t>(ir + u * step) * out_row);
    }
  }
}

// H TILE, for 3-byte pixels at internal PREMUL8.  Tiles as LOOP's, but row
// groups are counted from output row 0: block (x, y, z) takes column tile
// x, the range's row groups y, y + grid_y, ... and images z, z + grid_z,
// ....  `windows` holds [r_lo, r_hi) of every row group of the plan: the
// r_lo row, then the r_hi row.
template <int KX, int MODE>
__device__ __forceinline__ void direct_tile(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const int32_t* __restrict__ luts,
                                            const int32_t* __restrict__ fold,
                                            const int32_t* __restrict__ tab_x,
                                            const int32_t* __restrict__ tab_y,
                                            const int32_t* __restrict__ windows,
                                            const Bilinear128Params& p) {
  // the h tile, h_cells cells sized per plan (dynamic shared memory)
  extern __shared__ uint2 s_cells[];
  __shared__ int32_t s_fold[MODE == kP8Linear ? 256 : 1];
  if constexpr (MODE == kP8Linear) load_unpack24_lut(fold, s_fold);
  const int tile_w = static_cast<int>(p.tile_w), shift = __ffs(tile_w) - 1;
  const int hshift = 8 - shift, tile_h = 1 << hshift;
  const int c = static_cast<int>(threadIdx.x) & (tile_w - 1);
  const int tr = static_cast<int>(threadIdx.x) >> shift;
  const int j = static_cast<int>(blockIdx.x) * tile_w + c;
  const int w_out = static_cast<int>(p.w_out);
  const int row0 = static_cast<int>(p.row0), row_end = row0 + static_cast<int>(p.n_rows);
  const int g_first = (row0 >> hshift) + static_cast<int>(blockIdx.y);
  const int g_end = ((row_end - 1) >> hshift) + 1;
  if (g_first >= g_end) return;  // the whole block: no row group
  const bool active = j < w_out;
  const Fmt f{3, false, p.unassoc_in != 0};
  const Columns<KX, MODE, kRgb> h(f, s_fold, tab_x, p, active ? j : w_out - 1);
  const unsigned perm = out_perm(p);
  const int nb_out = static_cast<int>(p.nb_out), ky = static_cast<int>(p.kind_y);
  const int row_bytes = static_cast<int>(p.w_in) * 3, out_row = w_out * nb_out;
  const int groups = (static_cast<int>(p.h_out) + tile_h - 1) >> hshift;
  uint2* col = s_cells + c;
  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * p.h_in * row_bytes;
    const auto row = [&](int r) { return img + static_cast<int64_t>(r) * row_bytes; };
    for (int g = g_first; g < g_end; g += static_cast<int>(gridDim.y)) {
      const int r_lo = __ldg(windows + g), n_taps = __ldg(windows + groups + g) - r_lo;
      // each (tap row, column) of the tile once, all of them at once: two
      // rows per pass of the column's H samples
      if (active) {
        int t = tr;
        for (; t + tile_h < n_taps; t += 2 * tile_h) {
          const uint8_t* rows[2] = {row(r_lo + t), row(r_lo + t + tile_h)};
          uint32_t v[2][4];
          h(rows, v);
          col[t << shift] = cell(v[0]);
          col[(t + tile_h) << shift] = cell(v[1]);
        }
        if (t < n_taps) {
          const uint8_t* rows[1] = {row(r_lo + t)};
          uint32_t v[1][4];
          h(rows, v);
          col[t << shift] = cell(v[0]);
        }
      }
      __syncthreads();
      const int i = (g << hshift) + tr;
      if (active && i >= row0 && i < row_end) {
        const TileCells cells{col, shift, r_lo};
        const auto index = [](int r) { return r; };
        uint32_t o[4];
        switch (ky) {
          case kBilinear: vfilter<kBilinear>(cells, index, tab_y, p, i, o); break;
          case kBox: vfilter<kBox>(cells, index, tab_y, p, i, o); break;
          default: vfilter<kCopy>(cells, index, tab_y, p, i, o); break;  // COPY, ONE
        }
        store_pixel(pack_word<MODE>(o, p, luts, perm), nb_out,
                    out + (b * p.n_rows + (i - row0)) * out_row + j * nb_out);
      }
      __syncthreads();
    }
  }
}

// ROLL.  Lane t of a tile row owns output columns j0 = tile_w * blockIdx.x
// + 4t .. j0 + 3 and walks a strip of strip_rows output rows down, holding
// the H values of tap rows ofs_y[i] and ofs_y[i] + 1 of its columns.  It
// works with alpha in channel 3: a pixel whose alpha is its byte 0 is
// rotated by a byte as it is loaded, and the pack's swizzle turns it back,
// so neither the unpack nor the pack picks alpha per channel.

// ROLL's lerp: (p*F + q*(256 - F)) >> 8, the lerp for working values (see
// the arithmetic note), with g = 256 - F computed once per sample.
__device__ __forceinline__ uint32_t mix(uint32_t p, uint32_t q, uint32_t f, uint32_t g) {
  return (p * f + q * g) >> 8;
}

// The PREMUL16 work channels of a pixel word whose alpha is byte 3 (unpack
// at kP16Compressed): colour c times alpha, alpha (a << 8) | 0x80.
__device__ __forceinline__ void unpack16(uint32_t w, uint32_t v[4]) {
  const uint32_t a = w >> 24;
  v[0] = (w & 0xff) * a;
  v[1] = ((w >> 8) & 0xff) * a;
  v[2] = ((w >> 16) & 0xff) * a;
  v[3] = (a << 8) | 0x80;
}

// The pack at kP16Compressed (pack_word) of work channels whose alpha is
// channel 3: colour (v * inv) >> 16 with inv = INV_DIV_P16[a], then the
// swizzle.  A colour value is at most 255 * 255 and inv at most 2^16, so
// the product fits 32 bits.
__device__ __forceinline__ uint32_t pack16(const uint32_t o[4], const int32_t* inv_p16,
                                           unsigned perm) {
  const uint32_t a = (o[3] >> 8) & 0xff;
  const uint32_t inv = static_cast<uint32_t>(inv_p16[a]);
  uint32_t w = a << 24;
#pragma unroll
  for (int c = 0; c < 3; ++c) w |= (((o[c] * inv) >> 16) & 0xff) << (8 * c);
  return __byte_perm(w, 0, perm);
}

// The P8-linear work channels of a pixel word whose alpha is byte 3:
// pixels.cuh's unpack at kP8Linear with alpha's INV_DIV_P8 entry loaded
// once (that unpack, called here, was 9-21% slower on the srgb rows,
// PERF.md §6).  `lut` is the block's shared FROM_SRGB then INV_DIV_P8.
__device__ __forceinline__ void unpack8l(uint32_t w, const int32_t* lut, bool premul,
                                         uint32_t v[4]) {
  const uint32_t a = w >> 24, a8 = (a << 3) + 1;
  const uint32_t inv = premul ? static_cast<uint32_t>(lut[256 + a]) : 0u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint32_t u = (w >> (8 * c)) & 0xff;
    if (premul) u = ((u * inv) >> 13) & 0xff;
    v[c] = (((static_cast<uint32_t>(lut[u]) + 1) * a8 - 1) >> 11) & 0x7ff;
  }
  v[3] = a;
}

// ROLL's unpack and pack at the plan's mode, alpha in channel 3: PREMUL16
// at compressed gamma (unpack16, pack16), or P8-linear (unpack8l, and the
// pack below), which first copies its tables into the block's shared
// memory.
template <int MODE>
struct RollFmt {
  const int32_t* inv_p16;

  __device__ __forceinline__ RollFmt(const Bilinear128Params&, const int32_t* __restrict__ luts)
      : inv_p16(luts + kInvDivP16) {}
  __device__ __forceinline__ void unpack(uint32_t w, uint32_t v[4]) const { unpack16(w, v); }
  __device__ __forceinline__ uint32_t pack(const uint32_t o[4], unsigned perm) const {
    return pack16(o, inv_p16, perm);
  }
};

template <>
struct RollFmt<kP8Linear> {
  const int32_t* lut;  // shared: FROM_SRGB, INV_DIV_P8, INV_DIV_P8L
  const uint8_t* to;   // shared: TO_SRGB as bytes
  bool premul_in, premul_out;

  __device__ __forceinline__ RollFmt(const Bilinear128Params& p, const int32_t* __restrict__ luts)
      : premul_in(p.unassoc_in == 0), premul_out(p.unassoc_out == 0) {
    __shared__ int32_t s_lut[768];
    __shared__ uint8_t s_to[2048];
    for (int k = threadIdx.x; k < 256; k += blockDim.x)
      s_lut[512 + k] = __ldg(luts + kInvDivP8L + k);
    for (int k = threadIdx.x; k < 2048; k += blockDim.x)
      s_to[k] = static_cast<uint8_t>(__ldg(luts + kToSrgb + k));
    load_unpack_luts(luts, s_lut);  // and the barrier
    lut = s_lut;
    to = s_to;
  }
  __device__ __forceinline__ void unpack(uint32_t w, uint32_t v[4]) const {
    unpack8l(w, lut, premul_in, v);
  }
  // pack_word at kP8Linear for 4-byte pixels: colour (v * INV_DIV_P8L[a])
  // >> 10 through TO_SRGB, premultiplied to 8 bits where the output is
  // premultiplied; then the swizzle.  A colour value is at most 2040 and
  // inv at most 258779, so the product fits 32 bits.
  __device__ __forceinline__ uint32_t pack(const uint32_t o[4], unsigned perm) const {
    const uint32_t a = o[3];
    const uint32_t inv = static_cast<uint32_t>(lut[512 + a]);
    uint32_t w = a << 24;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t r = to[((o[c] * inv) >> 10) & 0x7ff];
      if (premul_out) r = (((r + 1) * (a + 1) - 1) >> 8) & 0xff;
      w |= r << (8 * c);
    }
    return __byte_perm(w, 0, perm);
  }
};

// ROLL's X filter of one output column, its table entries in registers:
// kCopy reads column x (0 for ONE); kBilinear and kLadder keep sample k as
// offset << 9 | F (offsets below 2^16, F at most 256), and kLadder sums the
// 2^n samples' lerps (n <= 2).
template <int KX, int PX>
struct RollCol {
  int x;
  uint32_t s[4];

  __device__ __forceinline__ RollCol(const Bilinear128Params& p,
                                     const int32_t* __restrict__ tab, int j) {
    x = p.kind_x == kOne ? 0 : j;
    const int n = static_cast<int>(p.halvings_x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool on = (KX == kBilinear && k == 0) || (KX == kLadder && k < (1 << n));
      s[k] = on ? (static_cast<uint32_t>(__ldg(tab + (j << n) + k)) << 9) |
                      static_cast<uint32_t>(__ldg(tab + p.len_x + (j << n) + k))
                : 0u;
    }
  }
};

// Pixel i of a row as a word with alpha in byte 3 (`rot` rotates it there).
template <int PX>
__device__ __forceinline__ uint32_t roll_pixel(const uint8_t* row, int i, unsigned rot) {
  const uint32_t w = PX == kWord ? __ldg(reinterpret_cast<const uint32_t*>(row) + i)
                                 : load_pixel<false>(row, i, Fmt{4, false, true});
  return __byte_perm(w, 0, rot);
}

// The H values of a lane's 4 columns in `row`.  Neighbouring columns that
// share a pixel load it again: taking it from the column before, a branch
// per column, orders the loads and was slower (PERF.md §6).
template <int KX, int PX, int MODE>
__device__ __forceinline__ void roll_h(const RollCol<KX, PX> (&col)[4], const RollFmt<MODE>& fmt,
                                       const uint8_t* row, unsigned rot, int n,
                                       uint32_t (&v)[4][4]) {
  if constexpr (KX == kCopy) {
#pragma unroll
    for (int k = 0; k < 4; ++k) fmt.unpack(roll_pixel<PX>(row, col[k].x, rot), v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t sum[4] = {0, 0, 0, 0};
#pragma unroll
      for (int m = 0; m < (KX == kLadder ? 4 : 1); ++m) {
        if (KX == kBilinear || m < (1 << n)) {
          const int o = static_cast<int>(col[k].s[m] >> 9);
          const uint32_t fx = col[k].s[m] & 511u, gx = 256 - fx;
          uint32_t a[4], b[4];
          fmt.unpack(roll_pixel<PX>(row, o, rot), a);
          fmt.unpack(roll_pixel<PX>(row, o + 1, rot), b);
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[c] += mix(a[c], b[c], fx, gx);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) v[k][c] = KX == kLadder ? sum[c] >> n : sum[c];
    }
  }
}

template <int KX, int MODE, int PX>
__device__ __forceinline__ void direct_roll(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const int32_t* __restrict__ luts,
                                            const int32_t* __restrict__ tab_x,
                                            const int32_t* __restrict__ tab_y,
                                            const Bilinear128Params& p) {
  const RollFmt<MODE> fmt(p, luts);
  // lanes: threads of a tile row, 4 columns each; a row of lanes walks one
  // strip, and shuffles within its lanes only
  const int lanes = static_cast<int>(p.tile_w) >> 2;
  const int lshift = __ffs(lanes) - 1;
  const int t = static_cast<int>(threadIdx.x) & (lanes - 1);
  const unsigned mask = lanes == 32 ? 0xffffffffu
                                    : ((1u << lanes) - 1u) << (threadIdx.x & 31 & ~(lanes - 1));
  const int w_out = static_cast<int>(p.w_out);
  const int j0 = static_cast<int>(blockIdx.x) * static_cast<int>(p.tile_w) + 4 * t;
  const int n_x = static_cast<int>(p.halvings_x);
  // alpha to byte 3, and back: work channel k is the pixel's channel k + 1
  // (mod 4) where alpha is its byte 0
  const bool alpha_first = p.alpha_ch == 0;
  const unsigned rot = alpha_first ? 0x0321u : 0x3210u;
  const unsigned perm = static_cast<unsigned>(((p.src[0] + alpha_first * 3) & 3) |
                                              (((p.src[1] + alpha_first * 3) & 3) << 4) |
                                              (((p.src[2] + alpha_first * 3) & 3) << 8) |
                                              (((p.src[3] + alpha_first * 3) & 3) << 12));
  // columns past w_out compute column w_out - 1 and store nothing of their own
  const RollCol<KX, PX> col[4] = {RollCol<KX, PX>(p, tab_x, min(j0, w_out - 1)),
                                  RollCol<KX, PX>(p, tab_x, min(j0 + 1, w_out - 1)),
                                  RollCol<KX, PX>(p, tab_x, min(j0 + 2, w_out - 1)),
                                  RollCol<KX, PX>(p, tab_x, min(j0 + 3, w_out - 1))};
  const int row_bytes = static_cast<int>(p.w_in) * 4, out_row = w_out * 4;
  const int row0 = static_cast<int>(p.row0), n_rows = static_cast<int>(p.n_rows);
  const int R = static_cast<int>(p.strip_rows);
  const int strips = (n_rows + R - 1) / R;
  const int per_block = kThreads >> lshift;
  const int s_step = static_cast<int>(gridDim.y) * per_block;
  const int32_t* fy_tab = tab_y + p.len_y;
  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * p.h_in * row_bytes;
    uint8_t* out_img = out + b * p.n_rows * out_row;
    for (int s = static_cast<int>(blockIdx.y) * per_block + (static_cast<int>(threadIdx.x) >> lshift);
         s < strips; s += s_step) {
      const int i_lo = row0 + s * R, i_hi = min(i_lo + R, row0 + n_rows);
      int held = -2;  // the tap row in top; bot holds the next
      uint32_t top[4][4], bot[4][4];
      for (int i = i_lo; i < i_hi; ++i) {
        const int oy = __ldg(tab_y + i);
        if (oy != held) {
          if (oy == held + 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int c = 0; c < 4; ++c) top[k][c] = bot[k][c];
          } else {
            roll_h(col, fmt, img + static_cast<int64_t>(oy) * row_bytes, rot, n_x, top);
          }
          roll_h(col, fmt, img + static_cast<int64_t>(oy + 1) * row_bytes, rot, n_x, bot);
          held = oy;
        }
        const uint32_t fy = __ldg(fy_tab + i), gy = 256 - fy;
        uint32_t o[4], pv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = mix(top[k][c], bot[k][c], fy, gy);
          o[k] = fmt.pack(v, perm);
          pv[k] = __shfl_up_sync(mask, o[k], 1, lanes);
        }
        // The row's 16-byte aligned words of 4 pixels start `a` columns
        // before each lane's first: a lane stores the word that starts
        // there, its first `a` pixels from the lane before; lane 0 stores
        // its first 4 - a pixels alone, the last lane its last a, so the
        // tiles meet.
        uint8_t* row = out_img + static_cast<int64_t>(i - row0) * out_row;
        const int a = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
        const uint32_t c0 = a == 0 ? o[0] : a == 1 ? pv[3] : a == 2 ? pv[2] : pv[1];
        const uint32_t c1 = a == 0 ? o[1] : a == 1 ? o[0] : a == 2 ? pv[3] : pv[2];
        const uint32_t c2 = a == 0 ? o[2] : a == 1 ? o[1] : a == 2 ? o[0] : pv[3];
        const uint32_t c3 = a == 0 ? o[3] : a == 1 ? o[2] : a == 2 ? o[1] : o[0];
        const int cs = j0 - a;
        uint32_t* d = reinterpret_cast<uint32_t*>(row);
        if (t > 0 || a == 0) {
          if (cs + 3 < w_out) {
            *reinterpret_cast<uint4*>(d + cs) = make_uint4(c0, c1, c2, c3);
          } else {
            if (cs < w_out) d[cs] = c0;
            if (cs + 1 < w_out) d[cs + 1] = c1;
            if (cs + 2 < w_out) d[cs + 2] = c2;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k < 4 - a && j0 + k < w_out) d[j0 + k] = o[k];
        }
        if (t == lanes - 1 && a > 0) {
#pragma unroll
          for (int k = 1; k < 4; ++k)
            if (k >= 4 - a && j0 + k < w_out) d[j0 + k] = o[k];
        }
      }
    }
  }
}

template <int KX, int KY, int MODE, int PX, int FORM>
__global__ void __launch_bounds__(kThreads)
bilinear128_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const int32_t* __restrict__ luts, const int32_t* __restrict__ fold,
                   const int32_t* __restrict__ tab_x, const int32_t* __restrict__ tab_y,
                   const int32_t* __restrict__ windows, const Bilinear128Params p) {
  if constexpr (FORM == kLoop)
    direct_loop<KX, KY, MODE, PX>(in, out, luts, fold, tab_x, tab_y, p);
  else
    direct_tile<KX, MODE>(in, out, luts, fold, tab_x, tab_y, windows, p);
}

// ROLL's instances (X kinds kCopy, kBilinear and kLadder, 4-byte pixels as
// words or as bytes, at PREMUL16 compressed or P8-linear), with launch
// bounds of their own: ROLL keeps no shared memory but P8-linear's 5 KB of
// tables, so its registers alone set how many threads an SM holds, and
// BLOCKS blocks per SM cap them at 65536 / (256 BLOCKS), as far as they go
// without a spill (4 blocks spill at PREMUL16).
#define ROLL_INSTANCE(KX, MODE, PX, BLOCKS)                                                  \
  template <>                                                                              \
  __global__ void __launch_bounds__(kThreads, BLOCKS)                                      \
  bilinear128_kernel<KX, kBilinear, MODE, PX, kRoll>(                                      \
      const uint8_t* __restrict__ in, uint8_t* __restrict__ out,                           \
      const int32_t* __restrict__ luts, const int32_t* __restrict__,                       \
      const int32_t* __restrict__ tab_x, const int32_t* __restrict__ tab_y,                \
      const int32_t* __restrict__, const Bilinear128Params p) {                            \
    direct_roll<KX, MODE, PX>(in, out, luts, tab_x, tab_y, p);                             \
  }
ROLL_INSTANCE(kCopy, kP16Compressed, kWord, 3)
ROLL_INSTANCE(kCopy, kP16Compressed, kBytes, 3)
ROLL_INSTANCE(kBilinear, kP16Compressed, kWord, 3)
ROLL_INSTANCE(kBilinear, kP16Compressed, kBytes, 3)
ROLL_INSTANCE(kLadder, kP16Compressed, kWord, 2)
ROLL_INSTANCE(kLadder, kP16Compressed, kBytes, 2)
ROLL_INSTANCE(kCopy, kP8Linear, kWord, 3)
ROLL_INSTANCE(kCopy, kP8Linear, kBytes, 3)
ROLL_INSTANCE(kBilinear, kP8Linear, kWord, 3)
ROLL_INSTANCE(kBilinear, kP8Linear, kBytes, 3)
ROLL_INSTANCE(kLadder, kP8Linear, kWord, 2)
ROLL_INSTANCE(kLadder, kP8Linear, kBytes, 2)
#undef ROLL_INSTANCE

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, const int32_t*,
                         const Bilinear128Params&, dim3, cudaStream_t);

template <int KX, int KY, int MODE, int PX, int FORM>
void launch(const uint8_t* in, uint8_t* out, const int32_t* luts, const int32_t* fold,
            const int32_t* tab_x, const int32_t* tab_y, const int32_t* windows,
            const Bilinear128Params& p, dim3 grid, cudaStream_t s) {
  const size_t smem = FORM == kHTile ? sizeof(uint2) * p.h_cells : 0;
  bilinear128_kernel<KX, KY, MODE, PX, FORM><<<grid, kThreads, smem, s>>>(
      in, out, luts, fold, tab_x, tab_y, windows, p);
}

// LOOP: one instance per (KX, KY, MODE, reader); 3-byte pixels (kRgb) are
// planned at PREMUL8 only
template <int KX, int KY, int MODE>
Launcher pick(int px) {
  if (px == kWord) return &launch<KX, KY, MODE, kWord, kLoop>;
  if (px == kBytes) return &launch<KX, KY, MODE, kBytes, kLoop>;
  if constexpr (MODE == kP8Compressed || MODE == kP8Linear)
    return &launch<KX, KY, MODE, kRgb, kLoop>;
  return nullptr;
}

template <int KX, int KY>
Launcher pick(int64_t mode, int px) {
  switch (mode) {
    case kP8Compressed: return pick<KX, KY, kP8Compressed>(px);
    case kP8Linear: return pick<KX, KY, kP8Linear>(px);
    case kP16Compressed: return pick<KX, KY, kP16Compressed>(px);
    case kP16Linear: return pick<KX, KY, kP16Linear>(px);
  }
  return nullptr;
}

template <int KX>
Launcher pick(int64_t ky, int64_t mode, int px, int64_t form) {
  if (form == kHTile) {
    if (ky < kCopy || ky > kBox || px != kRgb) return nullptr;
    switch (mode) {
      case kP8Compressed: return &launch<KX, kAnyY, kP8Compressed, kRgb, kHTile>;
      case kP8Linear: return &launch<KX, kAnyY, kP8Linear, kRgb, kHTile>;
    }
    return nullptr;
  }
  if (form != kLoop) return nullptr;
  switch (ky) {
    case kCopy:
    case kOne: return pick<KX, kCopy>(mode, px);
    case kBilinear: return pick<KX, kBilinear>(mode, px);
    case kBox: return pick<KX, kBox>(mode, px);
  }
  return nullptr;
}

// ROLL: a BILINEAR V axis (of no halvings, 4-byte pixels: checked by the
// caller) beside a COPY, ONE or BILINEAR X axis, at PREMUL16 compressed or
// P8-linear
template <int MODE, int PX>
Launcher pick_roll(int64_t kx, int64_t halvings_x) {
  switch (kx) {
    case kCopy:
    case kOne: return &launch<kCopy, kBilinear, MODE, PX, kRoll>;
    case kBilinear:
      return halvings_x > 0 ? &launch<kLadder, kBilinear, MODE, PX, kRoll>
                            : &launch<kBilinear, kBilinear, MODE, PX, kRoll>;
  }
  return nullptr;
}

template <int PX>
Launcher pick_roll(int64_t mode, int64_t kx, int64_t halvings_x) {
  switch (mode) {
    case kP16Compressed: return pick_roll<kP16Compressed, PX>(kx, halvings_x);
    case kP8Linear: return pick_roll<kP8Linear, PX>(kx, halvings_x);
  }
  return nullptr;
}

Launcher pick(int64_t kx, int64_t ky, int64_t mode, int px, int64_t form) {
  switch (kx) {
    case kCopy:
    case kOne: return pick<kCopy>(ky, mode, px, form);
    case kBilinear: return pick<kBilinear>(ky, mode, px, form);
    case kBox: return pick<kBox>(ky, mode, px, form);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8, `out`
// is (batch, n_rows, w_out, nb_out) uint8 and 4-byte aligned, `luts` the
// int32 tables of ops/pixels.lut_table, `fold` the 256 int32 entries of
// ops/pixels.unpack24_table (read for 3-byte input in linear light),
// `tab_x` and `tab_y` the axes' tables, `windows` (read by H TILE only)
// [r_lo, r_hi) of each row group of 256 / tile_w output rows
// (ops/bilinear.row_windows), whose widest is h_cells / tile_w rows or
// fewer; the grid is (ceil(w_out / tile_w), grid_y, grid_z)
// (ops/bilinear.launch_shape, from row 0 for LOOP and from the range's
// first row for H TILE; ROLL's ops/bilinear.roll_shape).  The kernel runs on
// `stream` and is not waited for.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an axis kind, mode or form outside
// the class (H TILE: 3-byte input at PREMUL8 only; ROLL: a 0-halving
// BILINEAR V axis beside a COPY, ONE or BILINEAR X axis of at most 2
// halvings, at PREMUL16 compressed or P8-linear, 4-byte pixels in and out),
// or a tile width, grid, h tile or strip outside the limits.
extern "C" int smolscale_bilinear128_scale(const uint8_t* in, uint8_t* out,
                                           const int32_t* luts, const int32_t* fold,
                                           const int32_t* tab_x, const int32_t* tab_y,
                                           const int32_t* windows,
                                           const Bilinear128Params* params, void* stream) {
  const Bilinear128Params p = *params;
  if (p.batch * p.n_rows * p.w_out <= 0) return static_cast<int>(cudaSuccess);
  if (p.tile_w < 1 || p.tile_w > kThreads || (p.tile_w & (p.tile_w - 1)) != 0 ||
      p.grid_y < 1 || p.grid_y > 65535 || p.grid_z < 1 || p.grid_z > 65535 ||
      (p.form == kHTile && (p.tile_w > 32 || p.h_cells < 1 || p.h_cells > kHCells)) ||
      (p.form == kRoll &&
       (p.tile_w < 4 || p.tile_w > 128 || p.strip_rows < 1 || p.kind_y != kBilinear ||
        p.halvings_y != 0 || p.halvings_x > 2 ||
        (p.mode != kP16Compressed && p.mode != kP8Linear) || p.nb_in != 4 || p.nb_out != 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int px = p.nb_in == 3                                    ? kRgb
                 : (reinterpret_cast<uintptr_t>(in) & 3) == 0 ? kWord
                                                               : kBytes;
  const Launcher fn = p.form != kRoll ? pick(p.kind_x, p.kind_y, p.mode, px, p.form)
                      : px == kWord   ? pick_roll<kWord>(p.mode, p.kind_x, p.halvings_x)
                                      : pick_roll<kBytes>(p.mode, p.kind_x, p.halvings_x);
  if (fn == nullptr || (px == kRgb && p.kind_x == kBilinear && p.halvings_x > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.w_out + p.tile_w - 1) / p.tile_w),
                  static_cast<unsigned>(p.grid_y), static_cast<unsigned>(p.grid_z));
  fn(in, out, luts, fold, tab_x, tab_y, windows, p, grid, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
