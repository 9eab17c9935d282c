// The general 64bpp PREMUL8 scale for Hopper (sm_90a): per axis a bilinear
// halving ladder, a box with fractional edge weights, COPY or ONE; 3- or
// 4-byte pixels in and out.
//
// Replaces the Pallas TPU kernel smolscale_tpu/ops/pallas_bilinear.py
// `_make_kernel` at its three pallas_call sites: `_built` (:1732, the whole
// image), `_built_rows` (:1834, output row groups for the row API) and
// `_built_planes` (:1939, 24bpp input through u8 planes), together with the
// unpremultiply epilogue they apply for unassociated output, which is fused
// into the store here.  The TPU kernel's lerp and span matrices, row-group
// windows and u32 pixel view exist for the MXU and Mosaic; this kernel
// computes what backends/numpy_ref.py specifies for the class directly.
// For output pixel (i, j):
//
//   for each tap row r of the V filter of output row i, the H-filtered value
//   h(r, j), rounded to 8 bits on its own:
//     BILINEAR, n halvings: sample k of output j is table entry s = j*2^n + k,
//       lerp(px[ofs[s]], px[ofs[s]+1], F[s]) = ((p - q)*F >> 8) + q with an
//       arithmetic (floor) shift, then (sum of the 2^n samples) >> n;
//     BOX: (px[first]*w_first >> 8) + px[mid..mid+len) + (px[last]*w_last >> 8),
//       normalised with (acc*span_mul + 2^23) >> 24;
//     COPY: px[j];  ONE: px[0];
//   then the same filter over the h values of the tap rows, the unpremultiply
//   for unassociated output ((v*inv_div_p8[a]) >> 13), and the pack.
//
// H is rounded per input row before V, as in the reference: filtering the
// 2-D block once gives other bytes.  Pixels are unpacked where they are
// read: 24bpp input gets a constant alpha of 255 (this replaces the TPU's
// planes feed), unassociated input is premultiplied, ((v+1)*(a+1)-1) >> 8.
// `row0` is the first output row computed: the row API needs no sliced
// tables.  No register array is indexed at run time (nvcc would put it in
// local memory): alpha is picked with selects and the output bytes are
// swizzled with __byte_perm.
//
// Two paths, chosen on the host per plan (ops/bilinear.py).
//
// The direct path (ladders, COPY, ONE, boxes under 16 pixels per output
// column) maps a block of 256 threads onto a tile of tile_w output columns
// (a power of two up to 32) by 256 / tile_w output rows, a row group; the
// row groups are counted from output row 0, so that the host's tables of
// them hold for any `row0`.  Block (x, y, z) takes column tile x, row groups
// y, y + grid_y, ... of the range and images z, z + grid_z, ...
// (ops/bilinear.launch_shape: about 16 blocks per SM, grid y and z below
// 2^16).  Indices are 32-bit within an image; only an image's and a row's
// base offsets are 64-bit; nothing is divided per output pixel (the
// earlier flat loop paid three 64-bit divisions per output).  Three forms,
// chosen on the host by class (ops/bilinear.direct_form):
//
//   LOOP: each thread walks the V taps of its output pixel and H-filters
//     each tap row from global memory (L1 serves the neighbours' overlaps),
//     so a tap row is H-filtered again for every output row that reads it.
//     It takes a COPY V axis (one tap row per output row), 0h downscales,
//     and V boxes whose row groups read more rows than the h tile holds
//     (a1-strip-rows' 128:1).
//   H TILE: a row group's output rows read a contiguous range of tap rows,
//     [r_lo, r_hi) (a host table per row group, `windows`); the block
//     H-filters each (tap row, column) of its tile once, all of them at
//     once, so many loads are in flight, and keeps each result in shared
//     memory as one word (8 bits per channel, rounded per row as the
//     reference does); then each thread runs the V filter, of a kind read
//     at run time, over those words.  The tile's shared memory is sized per
//     plan (h_words, at most kHWords: 16 KB), which leaves the rest of the
//     SM's 256 KB to L1.  It takes V ladders of 1 or 2 halvings, V boxes
//     and ONE: there each output row reads three tap rows or more, or shares
//     them two-fold or more.
//   ROLL: 0-halving bilinear V upscales (beside a BILINEAR, COPY or ONE X
//     axis), which H TILE and LOOP took before.  There the output is 4f^2
//     times the input, and the V window only slides down, by 0 or 1 tap rows
//     per output row.  So a thread owns 4 output columns (their X table
//     entries loaded once, into registers) and walks a strip of strip_rows
//     output rows (ops/bilinear.roll_shape) top to bottom, holding the H
//     values of its two tap rows in registers, 8 bits a channel, and
//     H-filtering one new tap row when the window steps.  Each row is then
//     one V lerp per pixel, two channels to a 32-bit word (lerp4), and one
//     16-byte store (3-byte pixels: three 4-byte stores) of 4 pixels at an
//     aligned address: the lanes pass their words on with one shuffle, as
//     each row's alignment asks.  Nothing is shared between threads but
//     those shuffles, so it has no shared memory and no barrier: H TILE
//     spent two barriers per 8 output rows and left 96 of 256 threads idle
//     while 160 H-filtered the 5 tap rows of a 2x row group; LOOP H-filtered
//     both tap rows again for every output pixel.  Its bound is bytes, on an
//     upscale mostly the store: ~4f^2 output bytes per input byte.
//
// What bounds the direct path: not bytes (PERF.md §6: the timed rows run at
// 12-76% of their byte bound) but the loads and instructions per output
// pixel.  An H value costs 1-16 pixel loads, each unpacked (and
// premultiplied for unassociated input), and a 3-byte pixel is three byte
// loads; LOOP repeats those for every output row that reads a tap row, H
// TILE once per tile, at the price of a pass through shared memory and two
// barriers per row group.  Measured and dropped (PERF.md §6): a form
// that staged each tile's stretch of the tap rows in shared memory with
// 16-byte cp.async in a ring of three stages, to replace the byte loads of
// 3-byte pixels with two shared words and a funnel shift, was slower than H
// TILE on every timed row, 3-byte rows included.
//
// The staged box path: a box X axis whose columns read 16 pixels or more,
// edges included (about 15:1 and past), is staged: a thread walking such a
// span alone loads 4 bytes 64 bytes or more apart from its neighbours.  A
// block of 256 threads owns a tile of 256/G consecutive output columns of
// one output row, G threads (lanes, a power of two up to 32) per column.
// For each tap row of the V filter, in order, the block copies the stretch
// of that input row that the tile's spans cover (a host table, `windows`:
// [lo, hi) per tile, at most kStageBytes; ops/bilinear.stage_table) into
// shared memory with 16-byte loads from an aligned start, bytes at the
// ragged ends, so 3-byte and unaligned pixels load as fast as the rest;
// then each column's lanes sum its span from there, lane g taking pixels g,
// g + G, ..., and add their sums with shuffles; the V filter runs over the
// h values in registers, and a tap row equal to the last is not staged
// again.  Shared words are skewed by one per 32, so that lanes reading spans
// 4 to 32 words apart hit distinct banks.  G grows with the span (128:1: G =
// 8), so no span is staged in pieces.
//
// Arithmetic: a box span at 64bpp is at most 255:1 (the planner goes to
// 128bpp past it), so it holds at most 257 values of at most 255 and its
// sum stays below 2^17; the normalising multiply is 64-bit.  Offsets within
// an image stay below 2^31 (65535 rows of 65535 x 4 bytes is 2^34: image
// bases are 64-bit, and so are row bases; a row is below 2^18 bytes, a
// table index below 65535 * 4).

#include <cuda_runtime.h>
#include <stdint.h>

// Launch parameters; the field order and the all-int64 layout match the
// ctypes Structure in ops/bilinear.py.
struct BilinearParams {
  int64_t batch, h_in, w_in, h_out, w_out;
  int64_t row0, n_rows;            // output rows [row0, row0 + n_rows)
  int64_t kind_x, kind_y;          // AxisKind
  int64_t halvings_x, halvings_y;  // n of a BILINEAR axis
  int64_t len_x, len_y;            // table row length: dim_bilin or dim_out
  int64_t span_mul_x, span_mul_y;  // BOX normalisation
  int64_t lanes_x;                 // staged BOX X axis: threads per output column; 0: direct
  int64_t nb_in, nb_out;
  int64_t alpha_ch;                // work channel holding alpha (3 for 24bpp input)
  int64_t unassoc_in, unassoc_out;
  int64_t src[4];                  // output byte k <- work channel src[k]
  int64_t tile_w;                  // direct path: output columns per block row, a power of
                                   // two <= 32 (ROLL: 4 to 128)
  int64_t grid_y, grid_z;          // direct path: blocks over the row groups, over the batch
  int64_t form;                    // direct path: Form
  int64_t h_words;                 // H TILE: words of the h tile, a multiple of 4
  int64_t strip_rows;              // ROLL: output rows a thread walks
};

enum AxisKind { kCopy = 0, kOne = 1, kBilinear = 2, kBox = 3 };

namespace {

// The X axis's template kinds: kCopy serves COPY and ONE (ONE reads column
// 0), kBilinear and kBox load directly, kStaged is a staged BOX axis.
constexpr int kStaged = 4;
// ROLL's X kind for a BILINEAR axis of 1 or more halvings (kBilinear: none).
constexpr int kLadder = 5;
// The direct path's forms (ops/bilinear.LOOP, H_TILE, ROLL); H TILE reads
// the V kind at run time, its template KY is kAnyY; ROLL's is kBilinear.
enum Form { kLoop = 0, kHTile = 1, kRoll = 2 };
constexpr int kAnyY = 4;

constexpr int kThreads = 256;
// The h tile's largest size in words: ops/bilinear.H_WORDS.
constexpr int kHWords = 4096;
// Largest input stretch of the staged box path at once, in bytes:
// ops/bilinear.STAGE_BYTES.
constexpr int kStageBytes = 24576;
// Its words, with the 16-byte aligned head before it and the word read past
// its end by an unaligned pixel; then one skew word per 32.
constexpr int kStageWords = kStageBytes / 4 + 6;
constexpr int kSmemWords = kStageWords + kStageWords / 32 + 1;

// One axis's filter: its table (ops/bilinear.axis_table) and constants.
struct Axis {
  const int32_t* tab;
  int64_t len;
  int halvings;
  int64_t span_mul;
};

struct Unpack {
  int nb;
  bool alpha_first;  // alpha in work channel 0, else 3
  bool unassoc;
};

// Channel c of four is alpha: a select, so that no register array is
// indexed at run time (nvcc puts such arrays in local memory).
__device__ __forceinline__ bool is_alpha(int c, bool alpha_first) {
  return alpha_first ? c == 0 : c == 3;
}

// The work channels of a pixel held as four bytes, byte k channel k.
__device__ __forceinline__ void unpack(uint32_t px, const Unpack& u, int v[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = (px >> (8 * c)) & 0xff;
  if (u.unassoc) {
    // premul_u_to_p8 (generic.c:238-244)
    const int a1 = (u.alpha_first ? v[0] : v[3]) + 1;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (!is_alpha(c, u.alpha_first)) v[c] = (((v[c] + 1) * a1 - 1) >> 8) & 0xff;
  }
}

// The pixel at `p` as four bytes (24bpp: alpha 255), as stored.
template <bool PACKED>
__device__ __forceinline__ uint32_t raw_pixel(const uint8_t* __restrict__ p, int nb) {
  if (PACKED) return __ldg(reinterpret_cast<const uint32_t*>(p));
  return static_cast<uint32_t>(__ldg(p)) | (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
         (static_cast<uint32_t>(nb == 4 ? __ldg(p + 3) : 255) << 24);
}

template <bool PACKED>
__device__ __forceinline__ void load_pixel(const uint8_t* __restrict__ p,
                                           const Unpack& u, int v[4]) {
  unpack(raw_pixel<PACKED>(p, u.nb), u, v);
}

__device__ __forceinline__ int lerp(int p, int q, int f) {
  // numpy_ref._lerp: (p - q)*f is negative when p < q; >> floors it
  return ((((p - q) * f) >> 8) + q) & 0xff;
}

__device__ __forceinline__ int normalise(int acc, int64_t span_mul) {
  return static_cast<int>(((static_cast<int64_t>(acc) * span_mul +
                            (int64_t{1} << 23)) >> 24) & 0xff);
}

// Output `j` of an axis of kind KIND over the values fetch(index, v); I is
// the index type (int on the direct path, int64_t on the staged box path).
template <int KIND, class I, class Fetch>
__device__ __forceinline__ void filter(Fetch&& fetch, const Axis& ax, I j, int out[4]) {
  if (KIND == kCopy) {
    fetch(j, out);
  } else if (KIND == kOne) {
    fetch(I{0}, out);
  } else if (KIND == kBilinear) {
    const int n = ax.halvings;
    int sum[4] = {0, 0, 0, 0};
    for (int k = 0; k < (1 << n); ++k) {
      const I s = (j << n) + k;
      const I o = __ldg(ax.tab + s);
      const int f = __ldg(ax.tab + ax.len + s);
      int p[4], q[4];
      fetch(o, p);
      fetch(o + 1, q);
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += lerp(p[c], q[c], f);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = (sum[c] >> n) & 0xff;
  } else {  // kBox
    const int32_t* t = ax.tab + j;
    const int64_t len = ax.len;
    const int w_first = __ldg(t + len), n_mid = __ldg(t + 3 * len);
    const int w_last = __ldg(t + 5 * len);
    const I mid = __ldg(t + 2 * len);
    int v[4], acc[4];
    fetch(static_cast<I>(__ldg(t)), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = ((v[c] * w_first) >> 8) & 0xff;
    for (int k = 0; k < n_mid; ++k) {
      fetch(mid + k, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[c];
    }
    fetch(static_cast<I>(__ldg(t + 4 * len)), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] += ((v[c] * w_last) >> 8) & 0xff;
      out[c] = normalise(acc[c], ax.span_mul);
    }
  }
}

// One output pixel's word at `dst`: 4 bytes, or the first 3.
__device__ __forceinline__ void put_pixel(uint8_t* dst, uint32_t w, int64_t nb) {
  if (nb == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
    dst[0] = static_cast<uint8_t>(w);
    dst[1] = static_cast<uint8_t>(w >> 8);
    dst[2] = static_cast<uint8_t>(w >> 16);
  }
}

// The __byte_perm selector that puts work channel src[k] into output byte k.
__device__ __forceinline__ unsigned swizzle(const BilinearParams& p) {
  return static_cast<unsigned>(p.src[0] | (p.src[1] << 4) | (p.src[2] << 8) |
                               (p.src[3] << 12));
}

// One output pixel of normalised work channels `o`: unpremultiplied for
// unassociated output (unpremul_p8_to_u, generic.c:227-236,
// INVERTED_DIV_SHIFT_P8 = 13), packed into a word, swizzled and stored.
__device__ __forceinline__ void store(int o[4], const BilinearParams& p, bool alpha_first,
                                      unsigned perm, const int32_t* __restrict__ inv_div_p8,
                                      uint8_t* dst) {
  if (p.unassoc_out) {
    const int64_t inv = __ldg(inv_div_p8 + (alpha_first ? o[0] : o[3]));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (!is_alpha(c, alpha_first)) o[c] = static_cast<int>((o[c] * inv) >> 13) & 0xff;
  }
  const uint32_t w = __byte_perm(
      static_cast<uint32_t>(o[0]) | (static_cast<uint32_t>(o[1]) << 8) |
          (static_cast<uint32_t>(o[2]) << 16) | (static_cast<uint32_t>(o[3]) << 24),
      0, perm);
  put_pixel(dst, w, p.nb_out);
}

// ---------------------------------------------------------------------------
// Direct path: output tiles over row groups, two forms
// ---------------------------------------------------------------------------

// The pixels of one input row in global memory, by input column.
template <bool PACKED>
struct GlobalRow {
  const uint8_t* row;
  Unpack u;
  __device__ __forceinline__ void operator()(int x, int v[4]) const {
    load_pixel<PACKED>(row + x * u.nb, u, v);
  }
};

// The X filter of output column j for H TILE: the H-filtered
// value of a row whose pixels `px` gives.  A BILINEAR column's samples are
// loaded once (at most 2 halvings at 64bpp, a ratio past 8:1 being a box, so
// 4 samples); a BOX column reads its six table words per row (L1 serves
// them), which keeps them out of the registers live across the H pass.
template <int KX>
struct XCol {
  Axis ax;
  int x;             // the column read: j (0 for ONE)
  int n;             // kBilinear: halvings
  int ofs[4], fx[4];  // kBilinear: the samples

  __device__ __forceinline__ XCol(const BilinearParams& p, const int32_t* __restrict__ tab,
                                  int j)
      : ax{tab, p.len_x, static_cast<int>(p.halvings_x), p.span_mul_x},
        x(p.kind_x == kOne ? 0 : j), n(static_cast<int>(p.halvings_x)) {
    const int len = static_cast<int>(p.len_x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool on = KX == kBilinear && k < (1 << n);
      ofs[k] = on ? __ldg(tab + (j << n) + k) : 0;
      fx[k] = on ? __ldg(tab + len + (j << n) + k) : 0;
    }
  }

  template <class Px>
  __device__ __forceinline__ void operator()(const Px& px, int out[4]) const {
    if constexpr (KX == kBilinear) {
      int sum[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < (1 << n)) {
          int a[4], b[4];
          px(ofs[k], a);
          px(ofs[k] + 1, b);
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[c] += lerp(a[c], b[c], fx[k]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = (sum[c] >> n) & 0xff;
    } else {  // kCopy reads column x, kBox walks its span
      filter<KX>(px, ax, x, out);
    }
  }
};

// LOOP: the H-filtered values of output column j by input row, from global
// memory (the X table read per tap, as L1 serves it).
template <int KX, bool PACKED>
struct RowsH {
  const uint8_t* img;
  int row_bytes;
  Unpack u;
  Axis ax;
  int j;
  __device__ __forceinline__ void operator()(int r, int v[4]) const {
    filter<KX>(GlobalRow<PACKED>{img + static_cast<int64_t>(r) * row_bytes, u}, ax, j, v);
  }
};

// H TILE: the h words of one column of the tile, by input row
// (row r_lo is the tile's first; a column's words are `shift` apart).
struct TileH {
  const uint32_t* s;
  int shift, r_lo;
  __device__ __forceinline__ void operator()(int r, int v[4]) const {
    const uint32_t w = s[(r - r_lo) << shift];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (w >> (8 * c)) & 0xff;
  }
};

// The V filter of kind `ky` over the h tile's column `h` for output row i,
// and the store.
__device__ __forceinline__ void tile_store(int ky, const TileH& h, const Axis& ay, int i,
                                           const BilinearParams& p, bool alpha_first,
                                           unsigned perm,
                                           const int32_t* __restrict__ inv_div_p8,
                                           uint8_t* dst) {
  int o[4];
  switch (ky) {
    case kCopy: filter<kCopy>(h, ay, i, o); break;
    case kOne: filter<kOne>(h, ay, i, o); break;
    case kBilinear: filter<kBilinear>(h, ay, i, o); break;
    default: filter<kBox>(h, ay, i, o); break;
  }
  store(o, p, alpha_first, perm, inv_div_p8, dst);
}

__device__ __forceinline__ uint32_t pack_h(const int v[4]) {
  return static_cast<uint32_t>(v[0]) | (static_cast<uint32_t>(v[1]) << 8) |
         (static_cast<uint32_t>(v[2]) << 16) | (static_cast<uint32_t>(v[3]) << 24);
}

// The tile and loop geometry of both forms.
struct Tiles {
  int tile_w, shift, hshift, tile_h;  // tile_w columns by tile_h = 2^hshift rows
  int c, tr;                          // this thread's column and row in the tile
  int j, w_out;                       // its output column; j < w_out: it computes one
  int row0, row_end;                  // the output rows [row0, row_end)
  int g_first, g_end;                 // this block's first row group, the range's end
  int row_bytes, out_row, nb_out;

  // this thread's output row in row group g, or -1 outside [row0, row_end)
  __device__ __forceinline__ int row(int g) const {
    const int i = (g << hshift) + tr;
    return j < w_out && i >= row0 && i < row_end ? i : -1;
  }
  __device__ __forceinline__ uint8_t* dst(uint8_t* out, const BilinearParams& p, int64_t b,
                                          int i) const {
    return out + (b * p.n_rows + (i - row0)) * out_row + j * nb_out;
  }
};

__device__ __forceinline__ Tiles tiles(const BilinearParams& p) {
  Tiles t;
  t.tile_w = static_cast<int>(p.tile_w);
  t.shift = __ffs(t.tile_w) - 1;
  t.hshift = 8 - t.shift;
  t.tile_h = 1 << t.hshift;
  t.c = static_cast<int>(threadIdx.x) & (t.tile_w - 1);
  t.tr = static_cast<int>(threadIdx.x) >> t.shift;
  t.j = static_cast<int>(blockIdx.x) * t.tile_w + t.c;
  t.w_out = static_cast<int>(p.w_out);
  t.row0 = static_cast<int>(p.row0);
  t.row_end = t.row0 + static_cast<int>(p.n_rows);
  t.g_first = (t.row0 >> t.hshift) + static_cast<int>(blockIdx.y);
  t.g_end = ((t.row_end - 1) >> t.hshift) + 1;
  t.row_bytes = static_cast<int>(p.w_in * p.nb_in);
  t.out_row = static_cast<int>(p.w_out * p.nb_out);
  t.nb_out = static_cast<int>(p.nb_out);
  return t;
}

template <int KX, int KY, bool PACKED>
__device__ __forceinline__ void direct_loop(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const int32_t* __restrict__ inv_div_p8,
                                            const int32_t* __restrict__ tab_x,
                                            const int32_t* __restrict__ tab_y,
                                            const BilinearParams& p) {
  const Tiles T = tiles(p);
  if (T.j >= T.w_out) return;
  const Unpack u{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const Axis ax{tab_x, p.len_x, static_cast<int>(p.halvings_x), p.span_mul_x};
  const Axis ay{tab_y, p.len_y, static_cast<int>(p.halvings_y), p.span_mul_y};
  const int jx = KX == kCopy && p.kind_x == kOne ? 0 : T.j;
  const unsigned perm = swizzle(p);
  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const RowsH<KX, PACKED> h{in + b * p.h_in * T.row_bytes, T.row_bytes, u, ax, jx};
    for (int g = T.g_first; g < T.g_end; g += static_cast<int>(gridDim.y)) {
      const int i = T.row(g);
      if (i < 0) continue;
      int o[4];
      filter<KY>(h, ay, i, o);
      store(o, p, u.alpha_first, perm, inv_div_p8, T.dst(out, p, b, i));
    }
  }
}

// H TILE.  `windows` holds [r_lo, r_hi) of every row group of the plan
// (groups counted from output row 0): the r_lo row, then the r_hi row.
template <int KX, bool PACKED>
__device__ __forceinline__ void direct_tile(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const int32_t* __restrict__ inv_div_p8,
                                            const int32_t* __restrict__ tab_x,
                                            const int32_t* __restrict__ tab_y,
                                            const int32_t* __restrict__ windows,
                                            const BilinearParams& p) {
  // the h tile, h_words words sized per plan (dynamic shared memory)
  extern __shared__ uint32_t s_h[];
  const Tiles T = tiles(p);
  if (T.g_first >= T.g_end) return;  // the whole block: no row group
  const bool active = T.j < T.w_out;
  const Unpack u{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const XCol<KX> col(p, tab_x, active ? T.j : T.w_out - 1);
  const Axis ay{tab_y, p.len_y, static_cast<int>(p.halvings_y), p.span_mul_y};
  const int ky = static_cast<int>(p.kind_y);
  const unsigned perm = swizzle(p);
  const int groups = (static_cast<int>(p.h_out) + T.tile_h - 1) >> T.hshift;
  uint32_t* h_col = s_h + T.c;
  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * p.h_in * T.row_bytes;
    for (int g = T.g_first; g < T.g_end; g += static_cast<int>(gridDim.y)) {
      const int r_lo = __ldg(windows + g), n_taps = __ldg(windows + groups + g) - r_lo;
      // each (tap row, column) of the tile once, all of them at once
      if (active) {
        for (int t = T.tr; t < n_taps; t += T.tile_h) {
          int v[4];
          col(GlobalRow<PACKED>{img + static_cast<int64_t>(r_lo + t) * T.row_bytes, u}, v);
          h_col[t << T.shift] = pack_h(v);
        }
      }
      __syncthreads();
      const int i = T.row(g);
      if (i >= 0)
        tile_store(ky, TileH{h_col, T.shift, r_lo}, ay, i, p, u.alpha_first, perm, inv_div_p8,
                   T.dst(out, p, b, i));
      __syncthreads();
    }
  }
}

// ROLL: a 0-halving bilinear V upscale.  Lane t of a tile row owns output
// columns j0 = tile_w * blockIdx.x + 4t .. j0 + 3 and walks a strip of
// strip_rows output rows down, holding the H values of tap rows ofs_y[i] and
// ofs_y[i] + 1 of its columns in registers.

// The lerp of four 8-bit channels at once: per channel ((p - q)*f >> 8) + q,
// which is (p*f + q*(256 - f)) >> 8; for f in [0, 256] each such sum is below
// 2^16, so two channels in the 16-bit halves of a word never carry into each
// other (tests/test_torch_bilinear.py holds it for every p, q and f).
__device__ __forceinline__ uint32_t lerp4(uint32_t p, uint32_t q, uint32_t f) {
  const uint32_t g = 256 - f;
  const uint32_t lo = (p & 0x00ff00ffu) * f + (q & 0x00ff00ffu) * g;
  const uint32_t hi = ((p >> 8) & 0x00ff00ffu) * f + ((q >> 8) & 0x00ff00ffu) * g;
  return ((lo >> 8) & 0x00ff00ffu) | (hi & 0xff00ff00u);
}

// The work channels of the pixel at `p` as one word, byte k channel k.
template <bool PACKED>
__device__ __forceinline__ uint32_t pixel_word(const uint8_t* __restrict__ p, const Unpack& u) {
  const uint32_t px = raw_pixel<PACKED>(p, u.nb);
  if (!u.unassoc) return px;
  int v[4];
  unpack(px, u, v);
  return pack_h(v);
}

// ROLL's X filter of one output column, its table entries in registers:
// kCopy reads column x (0 for ONE); kBilinear and kLadder keep sample k as
// offset << 9 | F (offsets below 2^16, F at most 256), and kLadder sums the
// 2^n samples' lerps two channels to a word (at most 4 x 255 a half).
template <int KX>
struct RollCol {
  int x;
  uint32_t s[4];

  __device__ __forceinline__ RollCol(const BilinearParams& p,
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

  template <bool PACKED>
  __device__ __forceinline__ uint32_t operator()(const uint8_t* row, const Unpack& u,
                                                 int n) const {
    if constexpr (KX == kBilinear) {
      return lerp4(pixel_word<PACKED>(row + (s[0] >> 9) * u.nb, u),
                   pixel_word<PACKED>(row + ((s[0] >> 9) + 1) * u.nb, u), s[0] & 511u);
    } else if constexpr (KX == kLadder) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < (1 << n)) {
          const uint32_t o = s[k] >> 9;
          const uint32_t w = lerp4(pixel_word<PACKED>(row + o * u.nb, u),
                                   pixel_word<PACKED>(row + (o + 1) * u.nb, u), s[k] & 511u);
          lo += w & 0x00ff00ffu;
          hi += (w >> 8) & 0x00ff00ffu;
        }
      }
      return ((lo >> n) & 0x00ff00ffu) | (((hi >> n) & 0x00ff00ffu) << 8);
    } else {
      return pixel_word<PACKED>(row + x * u.nb, u);
    }
  }
};

// An output pixel's word from its normalised work channels: unpremultiplied
// for unassociated output, as `store` does, and swizzled.
__device__ __forceinline__ uint32_t out_word(uint32_t w, const BilinearParams& p,
                                             bool alpha_first, unsigned perm,
                                             const int32_t* __restrict__ inv_div_p8) {
  if (p.unassoc_out) {
    int o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = (w >> (8 * c)) & 0xff;
    const int64_t inv = __ldg(inv_div_p8 + (alpha_first ? o[0] : o[3]));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (!is_alpha(c, alpha_first)) o[c] = static_cast<int>((o[c] * inv) >> 13) & 0xff;
    w = pack_h(o);
  }
  return __byte_perm(w, 0, perm);
}

template <int KX, bool PACKED>
__device__ __forceinline__ void direct_roll(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const int32_t* __restrict__ inv_div_p8,
                                            const int32_t* __restrict__ tab_x,
                                            const int32_t* __restrict__ tab_y,
                                            const BilinearParams& p) {
  // lanes: threads of a tile row, 4 columns each; a row of lanes walks one
  // strip, and shuffles within its lanes only
  const int lanes = static_cast<int>(p.tile_w) >> 2;
  const int lshift = __ffs(lanes) - 1;
  const int t = static_cast<int>(threadIdx.x) & (lanes - 1);
  const unsigned mask = lanes == 32 ? 0xffffffffu
                                    : ((1u << lanes) - 1u) << (threadIdx.x & 31 & ~(lanes - 1));
  const int w_out = static_cast<int>(p.w_out);
  const int j0 = static_cast<int>(blockIdx.x) * static_cast<int>(p.tile_w) + 4 * t;
  const int nb = static_cast<int>(p.nb_out);
  const int n_x = static_cast<int>(p.halvings_x);
  const Unpack u{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const unsigned perm = swizzle(p);
  // columns past w_out compute column w_out - 1 and store nothing of their own
  const RollCol<KX> col[4] = {RollCol<KX>(p, tab_x, min(j0, w_out - 1)),
                              RollCol<KX>(p, tab_x, min(j0 + 1, w_out - 1)),
                              RollCol<KX>(p, tab_x, min(j0 + 2, w_out - 1)),
                              RollCol<KX>(p, tab_x, min(j0 + 3, w_out - 1))};
  const int row_bytes = static_cast<int>(p.w_in * p.nb_in);
  const int out_row = w_out * nb;
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
      uint32_t top[4], bot[4];
      for (int i = i_lo; i < i_hi; ++i) {
        const int oy = __ldg(tab_y + i);
        if (oy != held) {
          const uint8_t* r1 = img + static_cast<int64_t>(oy + 1) * row_bytes;
          if (oy == held + 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) top[k] = bot[k];
          } else {
            const uint8_t* r0 = img + static_cast<int64_t>(oy) * row_bytes;
#pragma unroll
            for (int k = 0; k < 4; ++k) top[k] = col[k].template operator()<PACKED>(r0, u, n_x);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) bot[k] = col[k].template operator()<PACKED>(r1, u, n_x);
          held = oy;
        }
        const uint32_t fy = __ldg(fy_tab + i);
        uint32_t o[4], pv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          o[k] = out_word(lerp4(top[k], bot[k], fy), p, u.alpha_first, perm, inv_div_p8);
          pv[k] = __shfl_up_sync(mask, o[k], 1, lanes);
        }
        // The row's 16-byte (3-byte pixels: 4-byte) aligned words of 4
        // pixels start `a` columns before each lane's first: a lane stores
        // the word that starts there, its first `a` pixels from the lane
        // before; lane 0 stores its first 4 - a pixels alone, the last lane
        // its last a, so the tiles meet.
        uint8_t* row = out_img + static_cast<int64_t>(i - row0) * out_row;
        const uintptr_t base = reinterpret_cast<uintptr_t>(row);
        const int a = static_cast<int>(nb == 4 ? (base >> 2) & 3 : (3 * base) & 3);
        const uint32_t c0 = a == 0 ? o[0] : a == 1 ? pv[3] : a == 2 ? pv[2] : pv[1];
        const uint32_t c1 = a == 0 ? o[1] : a == 1 ? o[0] : a == 2 ? pv[3] : pv[2];
        const uint32_t c2 = a == 0 ? o[2] : a == 1 ? o[1] : a == 2 ? o[0] : pv[3];
        const uint32_t c3 = a == 0 ? o[3] : a == 1 ? o[2] : a == 2 ? o[1] : o[0];
        const int cs = j0 - a;
        if (t > 0 || a == 0) {
          uint8_t* d = row + cs * nb;
          if (cs + 3 < w_out) {
            if (nb == 4) {
              *reinterpret_cast<uint4*>(d) = make_uint4(c0, c1, c2, c3);
            } else {
              uint32_t* d3 = reinterpret_cast<uint32_t*>(d);
              d3[0] = __byte_perm(c0, c1, 0x4210);
              d3[1] = __byte_perm(c1, c2, 0x5421);
              d3[2] = __byte_perm(c2, c3, 0x6542);
            }
          } else {
            if (cs < w_out) put_pixel(d, c0, nb);
            if (cs + 1 < w_out) put_pixel(d + nb, c1, nb);
            if (cs + 2 < w_out) put_pixel(d + 2 * nb, c2, nb);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k < 4 - a && j0 + k < w_out) put_pixel(row + (j0 + k) * nb, o[k], nb);
        }
        if (t == lanes - 1 && a > 0) {
#pragma unroll
          for (int k = 1; k < 4; ++k)
            if (k >= 4 - a && j0 + k < w_out) put_pixel(row + (j0 + k) * nb, o[k], nb);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Staged path: a BOX X axis's input stretches in shared memory
// ---------------------------------------------------------------------------

// Shared word w of a stretch, skewed by one word per 32.
__device__ __forceinline__ int skew(int w) { return w + (w >> 5); }

// Copies the `nbytes` bytes at `src` into `s_px`: the byte at src + k goes
// to byte o = (src & 15) + k of the staged words (word o/4, skewed).  16-byte
// loads cover the aligned middle, byte loads the ragged ends, so nothing
// outside the stretch is read.  Returns src & 15.
__device__ __forceinline__ int stage_row(uint32_t* __restrict__ s_px,
                                         const uint8_t* __restrict__ src, int nbytes) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = s + nbytes;
  const uintptr_t a0 = s & ~uintptr_t{15};
  const uintptr_t up = (s + 15) & ~uintptr_t{15}, down = e & ~uintptr_t{15};
  const uintptr_t a = up < e ? up : e;        // first aligned chunk
  const uintptr_t z = down > a ? down : a;    // end of the aligned chunks
  const int n_head = static_cast<int>(a - s), n_ends = n_head + static_cast<int>(e - z);
  uint8_t* s_bytes = reinterpret_cast<uint8_t*>(s_px);
  for (int k = threadIdx.x; k < n_ends; k += kThreads) {
    const uintptr_t x = k < n_head ? s + k : z + (k - n_head);
    const int o = static_cast<int>(x - a0);
    s_bytes[4 * skew(o >> 2) + (o & 3)] = __ldg(reinterpret_cast<const uint8_t*>(x));
  }
  const uint4* chunks = reinterpret_cast<const uint4*>(a);
  const int n_chunks = static_cast<int>((z - a) >> 4);
  const int w0 = static_cast<int>((a - a0) >> 2);
  for (int k0 = threadIdx.x; k0 < n_chunks; k0 += 4 * kThreads) {
    uint4 v[4];  // four loads in flight before the stores
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (k0 + q * kThreads < n_chunks) v[q] = __ldg(chunks + k0 + q * kThreads);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k0 + q * kThreads < n_chunks) {
        // four words of one 32-word group: contiguous after the skew
        uint32_t* d = s_px + skew(w0 + 4 * (k0 + q * kThreads));
        d[0] = v[q].x;
        d[1] = v[q].y;
        d[2] = v[q].z;
        d[3] = v[q].w;
      }
    }
  }
  return static_cast<int>(s & 15);
}

// The pixel at staged byte o as four bytes (24bpp: alpha 255).  PACKED:
// 4-byte pixels on word boundaries, one shared read; else two words and a
// funnel shift.
template <bool PACKED>
__device__ __forceinline__ uint32_t staged_pixel(const uint32_t* s_px, int o, bool rgb) {
  const int w = o >> 2;
  if (PACKED) return s_px[skew(w)];
  const uint32_t v = __funnelshift_r(s_px[skew(w)], s_px[skew(w + 1)], 8 * (o & 3));
  return rgb ? v | 0xff000000u : v;
}

// Adds v over the G lanes of each output column (G consecutive threads).
__device__ __forceinline__ void lane_sum(int v[4], int G) {
  for (int m = 1; m < G; m <<= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] += __shfl_xor_sync(0xffffffffu, v[c], m);
  }
}

// The H-filtered values of output column j of a BOX X axis, by input row,
// for the V filter: each call with a row other than the last stages that
// row's stretch and sums column j's span from it, G lanes splitting the
// pixels between its edges.  Every thread of the block makes the same calls.
template <bool PACKED>
struct StagedBox {
  uint32_t* s_px;
  const uint8_t* img;  // this image's first row
  int64_t row_bytes;
  Unpack u;
  int64_t span_mul;
  int g, G;     // lane, lanes per column
  bool active;  // column j < w_out
  int lo, hi;   // the tile's stretch: input columns [lo, hi)
  int first, w_first, mid, n_mid, last, w_last;  // column j's box table entries
  int64_t r_last;
  int h_last[4];

  __device__ __forceinline__ void pixel(int x, int head, int v[4]) const {
    unpack(staged_pixel<PACKED>(s_px, (x - lo) * u.nb + head, u.nb == 3), u, v);
  }

  __device__ __forceinline__ void operator()(int64_t r, int v[4]) {
    if (r != r_last) {
      __syncthreads();  // every lane is done with the last stretch
      const int head = stage_row(s_px, img + r * row_bytes + static_cast<int64_t>(lo) * u.nb,
                                 (hi - lo) * u.nb);
      __syncthreads();
      int acc[4] = {0, 0, 0, 0};
      if (active) {
        int px[4];
        if (g == 0) {
          pixel(first, head, px);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = ((px[c] * w_first) >> 8) & 0xff;
          pixel(last, head, px);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] += ((px[c] * w_last) >> 8) & 0xff;
        }
        for (int k = g; k < n_mid; k += G) {
          pixel(mid + k, head, px);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] += px[c];
        }
      }
      lane_sum(acc, G);
#pragma unroll
      for (int c = 0; c < 4; ++c) h_last[c] = normalise(acc[c], span_mul);
      r_last = r;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = h_last[c];
  }
};

template <int KY, bool PACKED>
__device__ __forceinline__ void staged(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                       const int32_t* __restrict__ inv_div_p8,
                                       const int32_t* __restrict__ tab_x,
                                       const int32_t* __restrict__ tab_y,
                                       const int32_t* __restrict__ stages,
                                       const BilinearParams& p) {
  __shared__ uint32_t s_px[kSmemWords];
  const Unpack u{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const Axis ay{tab_y, p.len_y, static_cast<int>(p.halvings_y), p.span_mul_y};
  const int G = static_cast<int>(p.lanes_x), T = kThreads / G;
  const int64_t tiles = (p.w_out + T - 1) / T;
  const int64_t row_bytes = p.w_in * p.nb_in;
  const int64_t n_blocks = p.batch * p.n_rows * tiles;
  const unsigned perm = swizzle(p);
  for (int64_t blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int64_t tile = blk % tiles;
    const int64_t ir = (blk / tiles) % p.n_rows;
    const int64_t b = blk / (tiles * p.n_rows);
    const int j = static_cast<int>(tile * T) + static_cast<int>(threadIdx.x) / G;
    StagedBox<PACKED> h;
    h.s_px = s_px;
    h.img = in + b * p.h_in * row_bytes;
    h.row_bytes = row_bytes;
    h.u = u;
    h.span_mul = p.span_mul_x;
    h.g = static_cast<int>(threadIdx.x) % G;
    h.G = G;
    h.active = j < p.w_out;
    h.lo = __ldg(stages + tile);
    h.hi = __ldg(stages + tiles + tile);
    if (h.active) {
      const int32_t* t = tab_x + j;
      const int64_t len = p.len_x;
      h.first = __ldg(t);
      h.w_first = __ldg(t + len);
      h.mid = __ldg(t + 2 * len);
      h.n_mid = __ldg(t + 3 * len);
      h.last = __ldg(t + 4 * len);
      h.w_last = __ldg(t + 5 * len);
    }
    h.r_last = -1;
    int o[4];
    filter<KY>(h, ay, p.row0 + ir, o);
    if (h.active && h.g == 0)
      store(o, p, u.alpha_first, perm, inv_div_p8,
            out + ((b * p.n_rows + ir) * p.w_out + j) * p.nb_out);
  }
}

template <int KX, int KY, bool PACKED, int FORM>
__global__ void __launch_bounds__(kThreads)
bilinear_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                const int32_t* __restrict__ inv_div_p8,
                const int32_t* __restrict__ tab_x,
                const int32_t* __restrict__ tab_y,
                const int32_t* __restrict__ windows, const BilinearParams p) {
  if constexpr (KX == kStaged)
    staged<KY, PACKED>(in, out, inv_div_p8, tab_x, tab_y, windows, p);
  else if constexpr (FORM == kLoop)
    direct_loop<KX, KY, PACKED>(in, out, inv_div_p8, tab_x, tab_y, p);
  else
    direct_tile<KX, PACKED>(in, out, inv_div_p8, tab_x, tab_y, windows, p);
}

// ROLL's six instances (X kinds kCopy, kBilinear and kLadder, PACKED or
// not), with launch bounds of their own: ROLL keeps no shared memory, so its
// registers alone set how many threads an SM holds, and BLOCKS blocks per SM
// cap them at 65536 / (256 BLOCKS), as far as they go without a spill.
#define ROLL_INSTANCE(KX, PACKED, BLOCKS)                                                    \
  template <>                                                                              \
  __global__ void __launch_bounds__(kThreads, BLOCKS)                                      \
  bilinear_kernel<KX, kBilinear, PACKED, kRoll>(                                           \
      const uint8_t* __restrict__ in, uint8_t* __restrict__ out,                           \
      const int32_t* __restrict__ inv_div_p8, const int32_t* __restrict__ tab_x,           \
      const int32_t* __restrict__ tab_y, const int32_t* __restrict__, const BilinearParams p) { \
    direct_roll<KX, PACKED>(in, out, inv_div_p8, tab_x, tab_y, p);                         \
  }
ROLL_INSTANCE(kCopy, false, 4)
ROLL_INSTANCE(kCopy, true, 4)
ROLL_INSTANCE(kBilinear, false, 4)
ROLL_INSTANCE(kBilinear, true, 4)
ROLL_INSTANCE(kLadder, false, 2)
ROLL_INSTANCE(kLadder, true, 2)
#undef ROLL_INSTANCE

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, const BilinearParams&,
                         cudaStream_t);

template <int KX, int KY, bool PACKED, int FORM>
void launch(const uint8_t* in, uint8_t* out, const int32_t* inv_div_p8,
            const int32_t* tab_x, const int32_t* tab_y, const int32_t* windows,
            const BilinearParams& p, cudaStream_t s) {
  dim3 grid;
  size_t smem = 0;
  if (KX == kStaged) {
    const int64_t T = kThreads / p.lanes_x;
    int64_t blocks = p.batch * p.n_rows * ((p.w_out + T - 1) / T);
    if (blocks > 0x7fffffff) blocks = 0x7fffffff;
    grid = dim3(static_cast<unsigned>(blocks));
  } else {
    grid = dim3(static_cast<unsigned>((p.w_out + p.tile_w - 1) / p.tile_w),
                static_cast<unsigned>(p.grid_y), static_cast<unsigned>(p.grid_z));
    if (FORM == kHTile) smem = 4 * p.h_words;
  }
  bilinear_kernel<KX, KY, PACKED, FORM><<<grid, kThreads, smem, s>>>(
      in, out, inv_div_p8, tab_x, tab_y, windows, p);
}

template <int KX, int KY, int FORM>
Launcher pick(bool packed) {
  if (packed) return &launch<KX, KY, true, FORM>;
  return &launch<KX, KY, false, FORM>;
}

// LOOP and the staged box path: one instance per V kind
template <int KX>
Launcher pick_y(int64_t ky, bool packed) {
  switch (ky) {
    case kCopy: return pick<KX, kCopy, kLoop>(packed);
    case kOne: return pick<KX, kOne, kLoop>(packed);
    case kBilinear: return pick<KX, kBilinear, kLoop>(packed);
    case kBox: return pick<KX, kBox, kLoop>(packed);
  }
  return nullptr;
}

template <int KX>
Launcher pick_form(int64_t ky, int64_t form, bool packed) {
  if (ky < kCopy || ky > kBox) return nullptr;
  switch (form) {
    case kLoop: return pick_y<KX>(ky, packed);
    case kHTile: return pick<KX, kAnyY, kHTile>(packed);
  }
  return nullptr;
}

// ROLL: a BILINEAR V axis (of no halvings: checked by the caller) beside a
// COPY, ONE or BILINEAR X axis
Launcher pick_roll(int64_t kx, int64_t ky, int64_t halvings_x, bool packed) {
  if (ky != kBilinear) return nullptr;
  switch (kx) {
    case kCopy:
    case kOne: return pick<kCopy, kBilinear, kRoll>(packed);
    case kBilinear:
      return halvings_x > 0 ? pick<kLadder, kBilinear, kRoll>(packed)
                            : pick<kBilinear, kBilinear, kRoll>(packed);
  }
  return nullptr;
}

Launcher pick(int64_t kx, bool staged, int64_t ky, int64_t form, bool packed) {
  switch (kx) {
    case kCopy:
    case kOne: return pick_form<kCopy>(ky, form, packed);
    case kBilinear: return pick_form<kBilinear>(ky, form, packed);
    case kBox: return staged ? pick_y<kStaged>(ky, packed) : pick_form<kBox>(ky, form, packed);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8,
// `out` is (batch, n_rows, w_out, nb_out) uint8 and 4-byte aligned,
// `inv_div_p8` holds 256 int32 (read only for unassociated output), `tab_x`
// and `tab_y` the axes' tables (unused for COPY and ONE), `windows` the
// host's windows: for a staged BOX X axis (lanes_x > 0, ops/bilinear.
// stage_table) [lo, hi) of each tile of 256 / lanes_x output columns, at
// most kStageBytes of input; for the direct path (ops/bilinear.row_windows;
// read by H TILE only) [r_lo, r_hi) of each row group of 256 / tile_w output
// rows, whose widest is h_words / tile_w rows or fewer.  The direct path's
// grid is (ceil(w_out / tile_w), grid_y, grid_z) (ops/bilinear.
// launch_shape; ROLL's roll_shape).  The kernel runs on `stream` and is not
// waited for.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown axis kind or form, a lane count that
// is not 0 or a power of two up to 32 or is set for another kind than BOX, a
// tile, grid, h tile or strip outside the limits, or ROLL on a V axis other
// than a 0-halving BILINEAR one or beside a BOX X axis.
extern "C" int smolscale_bilinear_scale(const uint8_t* in, uint8_t* out,
                                        const int32_t* inv_div_p8,
                                        const int32_t* tab_x,
                                        const int32_t* tab_y,
                                        const int32_t* windows,
                                        const BilinearParams* params,
                                        void* stream) {
  const BilinearParams p = *params;
  if (p.batch * p.n_rows * p.w_out <= 0) return static_cast<int>(cudaSuccess);
  if (p.lanes_x < 0 || p.lanes_x > 32 || (p.lanes_x & (p.lanes_x - 1)) != 0 ||
      (p.lanes_x > 0 && p.kind_x != kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.lanes_x == 0 &&
      (p.tile_w < (p.form == kRoll ? 4 : 1) || p.tile_w > (p.form == kRoll ? 128 : 32) ||
       (p.tile_w & (p.tile_w - 1)) != 0 || p.grid_y < 1 ||
       p.grid_y > 65535 || p.grid_z < 1 || p.grid_z > 65535 ||
       (p.form == kHTile && (p.h_words < 4 || p.h_words > kHWords || p.h_words % 4 != 0)) ||
       (p.form == kRoll && (p.strip_rows < 1 || p.halvings_y != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool packed =
      p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const Launcher fn = p.lanes_x == 0 && p.form == kRoll
                         ? pick_roll(p.kind_x, p.kind_y, p.halvings_x, packed)
                         : pick(p.kind_x, p.lanes_x > 0, p.kind_y, p.form, packed);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn(in, out, inv_div_p8, tab_x, tab_y, windows, p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
