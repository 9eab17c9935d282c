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
// tables.
//
// What bounds it: device memory.  One thread per output pixel loads the
// pixels its output needs straight from global memory (L1 serves the
// neighbouring outputs' overlaps), and no register array is indexed at run
// time: alpha is picked with selects and the output bytes are swizzled with
// __byte_perm, so nothing goes to local memory, whose traffic per pixel
// would cost more than the loads.  That direct path carries ladders, COPY,
// ONE and boxes under 16 pixels per output column.
//
// A box X axis whose columns read 16 pixels or more, edges included (about
// 15:1 and past), is staged instead: a thread walking such a span alone loads 4 bytes
// 64 bytes or more apart from its neighbours.  A block of 256 threads owns
// a tile of 256/G consecutive output columns of one output row, G threads
// (lanes, a power of two up to 32) per column.  For each tap row of the V
// filter, in order, the block copies the stretch of that input row that
// the tile's spans cover (a host table, `stages`: [lo, hi) per tile, at
// most kStageBytes; ops/bilinear.stage_table) into shared memory with
// 16-byte loads from an aligned start, bytes at the ragged ends, so 3-byte
// and unaligned pixels load as fast as the rest; then each column's lanes
// sum its span from there, lane g taking pixels g, g + G, ..., and add
// their sums with shuffles; the V filter runs over the h values in
// registers, and a tap row equal to the last is not staged again.  Shared
// words are skewed by one per 32, so that lanes reading spans 4 to 32
// words apart hit distinct banks.  G grows with the span (128:1: G = 8),
// so no span is staged in pieces.  Staging ladders and short boxes the
// same way was slower than the direct path (PERF.md §6): one stretch in
// flight per block leaves each tap row's load latency bare.  Left for
// later: a multi-stage cp.async or TMA ring that loads the next tap row
// while this one is filtered, and an h-row cache shared across output rows
// (upscales and overlapping ladder pairs load each input row for every
// output row that reads it).
//
// Arithmetic: a box span at 64bpp is at most 255:1 (the planner goes to
// 128bpp past it), so it holds at most 257 values of at most 255 and its
// sum stays below 2^17; the normalising multiply is 64-bit, and so are byte
// offsets (32 x 2048^2 x 4 bytes is 512 MiB, larger inputs pass 2^31).

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
};

enum AxisKind { kCopy = 0, kOne = 1, kBilinear = 2, kBox = 3 };

namespace {

// The X axis's template kinds: kCopy serves COPY and ONE (ONE reads column
// 0), kBilinear and kBox load directly, kStaged is a staged BOX axis; with
// the four V kinds and PACKED, 32 instances, none holding both paths.
constexpr int kStaged = 4;

constexpr int kThreads = 256;
// Largest input stretch staged at once, in bytes: ops/bilinear.STAGE_BYTES.
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

template <bool PACKED>
__device__ __forceinline__ void load_pixel(const uint8_t* __restrict__ p,
                                           const Unpack& u, int v[4]) {
  uint32_t px;
  if (PACKED) {
    px = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    px = static_cast<uint32_t>(__ldg(p)) | (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
         (static_cast<uint32_t>(u.nb == 4 ? __ldg(p + 3) : 255) << 24);
  }
  unpack(px, u, v);
}

__device__ __forceinline__ int lerp(int p, int q, int f) {
  // numpy_ref._lerp: (p - q)*f is negative when p < q; >> floors it
  return ((((p - q) * f) >> 8) + q) & 0xff;
}

__device__ __forceinline__ int normalise(int acc, int64_t span_mul) {
  return static_cast<int>(((static_cast<int64_t>(acc) * span_mul +
                            (int64_t{1} << 23)) >> 24) & 0xff);
}

// Output `j` of an axis of kind KIND over the values fetch(index, v).
template <int KIND, class Fetch>
__device__ __forceinline__ void filter(Fetch&& fetch, const Axis& ax, int64_t j,
                                       int out[4]) {
  if (KIND == kCopy) {
    fetch(j, out);
  } else if (KIND == kOne) {
    fetch(0, out);
  } else if (KIND == kBilinear) {
    const int n = ax.halvings;
    int sum[4] = {0, 0, 0, 0};
    for (int k = 0; k < (1 << n); ++k) {
      const int64_t s = (j << n) + k;
      const int64_t o = __ldg(ax.tab + s);
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
    const int64_t mid = __ldg(t + 2 * len);
    int v[4], acc[4];
    fetch(__ldg(t), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = ((v[c] * w_first) >> 8) & 0xff;
    for (int k = 0; k < n_mid; ++k) {
      fetch(mid + k, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[c];
    }
    fetch(__ldg(t + 4 * len), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] += ((v[c] * w_last) >> 8) & 0xff;
      out[c] = normalise(acc[c], ax.span_mul);
    }
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
  if (p.nb_out == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
    dst[0] = static_cast<uint8_t>(w);
    dst[1] = static_cast<uint8_t>(w >> 8);
    dst[2] = static_cast<uint8_t>(w >> 16);
  }
}

// ---------------------------------------------------------------------------
// Direct path: one thread per output pixel, pixels loaded from global memory
// ---------------------------------------------------------------------------

// The pixels of one input row, by column.
template <bool PACKED>
struct RowPixels {
  const uint8_t* row;
  Unpack u;
  __device__ __forceinline__ void operator()(int64_t x, int v[4]) const {
    load_pixel<PACKED>(row + x * u.nb, u, v);
  }
};

// The H-filtered values of output column j, by input row.
template <int KX, bool PACKED>
struct HValues {
  const uint8_t* img;
  int64_t row_bytes;
  Unpack u;
  Axis ax;
  int64_t j;
  __device__ __forceinline__ void operator()(int64_t r, int v[4]) const {
    filter<KX>(RowPixels<PACKED>{img + r * row_bytes, u}, ax, j, v);
  }
};

template <int KX, int KY, bool PACKED>
__device__ __forceinline__ void direct(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                       const int32_t* __restrict__ inv_div_p8,
                                       const int32_t* __restrict__ tab_x,
                                       const int32_t* __restrict__ tab_y,
                                       const BilinearParams& p) {
  const Unpack u{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const Axis ax{tab_x, p.len_x, static_cast<int>(p.halvings_x), p.span_mul_x};
  const Axis ay{tab_y, p.len_y, static_cast<int>(p.halvings_y), p.span_mul_y};
  const int64_t row_bytes = p.w_in * p.nb_in;
  const int64_t n_total = p.batch * p.n_rows * p.w_out;
  const unsigned perm = swizzle(p);
  for (int64_t n = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       n < n_total; n += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = n % p.w_out;
    const int64_t i = p.row0 + (n / p.w_out) % p.n_rows;
    const int64_t b = n / (p.w_out * p.n_rows);
    const int64_t jx = KX == kCopy && p.kind_x == kOne ? 0 : j;
    int o[4];
    filter<KY>(HValues<KX, PACKED>{in + b * p.h_in * row_bytes, row_bytes, u, ax, jx}, ay, i,
               o);
    store(o, p, u.alpha_first, perm, inv_div_p8, out + n * p.nb_out);
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

template <int KX, int KY, bool PACKED>
__global__ void __launch_bounds__(kThreads)
bilinear_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                const int32_t* __restrict__ inv_div_p8,
                const int32_t* __restrict__ tab_x,
                const int32_t* __restrict__ tab_y,
                const int32_t* __restrict__ stages, const BilinearParams p) {
  if constexpr (KX == kStaged)
    staged<KY, PACKED>(in, out, inv_div_p8, tab_x, tab_y, stages, p);
  else
    direct<KX, KY, PACKED>(in, out, inv_div_p8, tab_x, tab_y, p);
}

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, const BilinearParams&,
                         cudaStream_t);

template <int KX, int KY, bool PACKED>
void launch(const uint8_t* in, uint8_t* out, const int32_t* inv_div_p8,
            const int32_t* tab_x, const int32_t* tab_y, const int32_t* stages,
            const BilinearParams& p, cudaStream_t s) {
  int64_t blocks;
  if (KX == kStaged) {
    const int64_t T = kThreads / p.lanes_x;
    blocks = p.batch * p.n_rows * ((p.w_out + T - 1) / T);
  } else {
    blocks = (p.batch * p.n_rows * p.w_out + kThreads - 1) / kThreads;
  }
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  bilinear_kernel<KX, KY, PACKED><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      in, out, inv_div_p8, tab_x, tab_y, stages, p);
}

template <int KX, int KY>
Launcher pick(bool packed) {
  if (packed) return &launch<KX, KY, true>;
  return &launch<KX, KY, false>;
}

template <int KX>
Launcher pick(int64_t ky, bool packed) {
  switch (ky) {
    case kCopy: return pick<KX, kCopy>(packed);
    case kOne: return pick<KX, kOne>(packed);
    case kBilinear: return pick<KX, kBilinear>(packed);
    case kBox: return pick<KX, kBox>(packed);
  }
  return nullptr;
}

Launcher pick(int64_t kx, bool staged, int64_t ky, bool packed) {
  switch (kx) {
    case kCopy:
    case kOne: return pick<kCopy>(ky, packed);
    case kBilinear: return pick<kBilinear>(ky, packed);
    case kBox: return staged ? pick<kStaged>(ky, packed) : pick<kBox>(ky, packed);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8,
// `out` is (batch, n_rows, w_out, nb_out) uint8 and 4-byte aligned,
// `inv_div_p8` holds 256 int32 (read only for unassociated output), `tab_x`
// and `tab_y` the axes' tables (unused for COPY and ONE), `stages` the
// stretch table of a staged BOX X axis (lanes_x > 0; ops/bilinear.
// stage_table: [lo, hi) of each tile of 256 / lanes_x output columns, at
// most kStageBytes of input; unused when lanes_x is 0).  The kernel runs on
// `stream` and is not waited for.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unknown axis kind, or a lane
// count that is not 0 or a power of two up to 32 or is set for another
// kind than BOX.
extern "C" int smolscale_bilinear_scale(const uint8_t* in, uint8_t* out,
                                        const int32_t* inv_div_p8,
                                        const int32_t* tab_x,
                                        const int32_t* tab_y,
                                        const int32_t* stages,
                                        const BilinearParams* params,
                                        void* stream) {
  const BilinearParams p = *params;
  if (p.batch * p.n_rows * p.w_out <= 0) return static_cast<int>(cudaSuccess);
  if (p.lanes_x < 0 || p.lanes_x > 32 || (p.lanes_x & (p.lanes_x - 1)) != 0 ||
      (p.lanes_x > 0 && p.kind_x != kBox))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool packed =
      p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const Launcher fn = pick(p.kind_x, p.lanes_x > 0, p.kind_y, packed);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn(in, out, inv_div_p8, tab_x, tab_y, stages, p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
