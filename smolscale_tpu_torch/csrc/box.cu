// Integer-ratio box downscale for Hopper (sm_90a): box x box, COPY x box and
// box x COPY at S64 / PREMUL8, 3- or 4-byte pixels in and out.
//
// Replaces the Pallas TPU kernel smolscale_tpu/ops/pallas_box.py
// `_make_kernel`, launched by `_built` (packed 4-byte pixels) and
// `_built_planes` (24bpp input through u8 planes), together with its XLA
// epilogue `_unpremul_epilogue` (unassociated output), which is fused into
// the store here.  The TPU kernel's int8 span matrices, -128 bias, u32 pixel
// view and 24bpp surrogate plan exist for the MXU and Mosaic; this kernel
// computes what backends/numpy_ref.py specifies for the box class directly:
//
//   per input row of the V span:
//     unpack the rx pixels of the H span (premultiplying unassociated input:
//     ((v+1)*(a+1)-1)>>8), weight the span's first element 255/256 (on 8-bit
//     values (v*255)>>8 == v - (v>0); span 0 is exempt), drop the axis's
//     final element in the last span, and normalise the sum to an 8-bit
//     h-row value with (acc*span_mul + 2^23) >> 24;
//   then the same edge rules on the ry h-row values, normalise again,
//   unpremultiply for unassociated output ((v*inv_div_p8[a]) >> 13), pack.
//
// The H sum is normalised per input row before the V sum: summing the 2-D
// block and normalising once gives other bytes.  A COPY axis has span 1 and
// passes values through without normalisation.
//
// What bounds it: device-memory reads.  Every input byte is read once and
// the output is 1/(rx*ry) of the input (1/256 on the 4096^2 -> 256^2
// headline), with a few integer operations per input byte.  The design aims
// at each input byte crossing HBM once, in 16-byte loads that a warp issues
// over contiguous bytes, with several loads in flight per thread, on every
// SM, at every ratio:
//
// - Work mapping without division.  A warp covers `cw` output columns of one
//   output row, `L = 32 / cw` lanes per column (lanes per span), and a range
//   of the span's input rows; a block is `wc` such warps side by side times
//   `splits` warps that share the rows of the same columns (their partial V
//   sums are exact integer sums and are added in shared memory before the
//   one normalisation).  Grid x is the column tiles, grid y loops over
//   output rows and grid z over images, both below 2^16; ops/box.py
//   `launch_shape` picks cw, wc and splits so that deep ratios with few
//   outputs still give the card some 2 waves of warps.  Indices are 32-bit
//   but for the image and row base offsets (B*H*W*nb passes 2^31).
// - Three forms, chosen per plan and input address on the host
//   (ops/box.py `form`):
//   DIRECT (4-byte pixels, rx % 4 == 0, rows 16-byte aligned): each lane
//     loads 16-byte words of its span row straight into registers, L lanes
//     per span (one or two words each), four input rows' loads issued
//     before their sums; a warp-wide load reads L*16 contiguous bytes per
//     span, 512 contiguous bytes when spans are contiguous (rows 0, 3e);
//   COPY (COPY x box, 4-byte pixels, rows 16-byte aligned): each lane owns 4
//     adjacent output columns, one 16-byte load per input row and stores
//     its 4 outputs with one 16-byte store (row 8);
//   STAGED (everything else: 3-byte pixels, spans not a multiple of 16
//     bytes, unaligned input): each warp copies its columns' input stretch
//     of each row (at most 2 KB) into its own shared-memory slots with
//     16-byte cp.async loads of the aligned chunks that cover it, the next
//     row in flight while it sums this one (one word per 4-byte pixel;
//     3-byte pixels as 12-byte groups of three words, their halves sorted
//     into channels once per row).  It is bound by instructions, not bytes:
//     stretches of 2 KB halve the per-row cost of staging and of the row's
//     end against 1 KB ones (PERF.md §6).
// - Arithmetic in registers only.  Channels 0/2 and 1/3 are summed as the
//   16-bit halves of two words (w & 0x00ff00ff, (w >> 8) & 0x00ff00ff): a
//   span of at most 255 values of at most 255 sums to at most 65,025, and so
//   do the V sums of h-row values.  The 255/256 weight of a span's first
//   element and the dropped final element are one subtract each, by the
//   lane holding that pixel; the premultiply runs on the halves too
//   (v*a + v + a <= 65,535).  The pack is one word: a select for alpha, one
//   `__byte_perm` for the channel order, one store.  No array is indexed at
//   run time, so no instance has a stack frame.
//
// The 16-byte loads of the DIRECT, COPY and STAGED forms read whole aligned
// 16-byte chunks, and a chunk that holds a byte of the input may hold bytes
// before the first or after the last of a tensor that is not 16-byte
// aligned (the STAGED form is then chosen): such a chunk lies in the same
// mapped page as its valid byte, and the bytes outside the stretch are never
// summed.

#include <cuda_runtime.h>
#include <stdint.h>

// Launch parameters; the field order and the all-int64 layout match the
// ctypes Structure in ops/box.py.
struct BoxParams {
  int64_t batch, h_in, w_in, h_out, w_out;
  int64_t rx, ry;          // span length per axis (1 on a COPY axis)
  int64_t box_x, box_y;    // 1 = BOX axis, 0 = COPY axis
  int64_t drop_x, drop_y;  // 1 = the last span drops the axis's final element
  int64_t span_mul_x, span_mul_y;
  int64_t nb_in, nb_out;
  int64_t alpha_ch;        // work channel holding alpha (3 for 24bpp input)
  int64_t unassoc_in, unassoc_out;
  int64_t src[4];          // output byte k <- work channel src[k]
  int64_t form;            // kDirect, kCopy or kStaged (ops/box.py FORMS)
  int64_t cw;              // output columns per warp (kCopy: 128)
  int64_t wc, splits;      // warps per block: wc across columns x splits over rows
  int64_t rows_per_split;  // input rows of a span per split warp
  int64_t grid_x, grid_y, grid_z;
};

namespace {

enum Form { kDirect = 0, kCopy = 1, kStaged = 2 };

constexpr uint32_t kHalves = 0x00ff00ffu;
constexpr int kStages = 2;        // slots per warp (STAGED): this row and the next
constexpr int kSlotBytes = 2080;  // 2 KB stretch, 15 skew bytes, the words read past it
constexpr int kMaxWarps = 8;

// ---------------------------------------------------------------------------
// Pixel arithmetic on 16-bit halves
// ---------------------------------------------------------------------------

// premul_u_to_p8 (generic.c:238-244) on a pixel word: ((v+1)*(a+1)-1)>>8 =
// (v*a + v + a) >> 8 on each half; alpha is kept.
__device__ __forceinline__ uint32_t premultiply(uint32_t px, bool alpha_first) {
  const uint32_t a = alpha_first ? (px & 0xffu) : (px >> 24);
  const uint32_t aa = a | (a << 16);
  const uint32_t e = px & kHalves, o = (px >> 8) & kHalves;
  const uint32_t pe = ((e * a + e + aa) >> 8) & kHalves;
  const uint32_t po = ((o * a + o + aa) >> 8) & kHalves;
  const uint32_t w = pe | (po << 8);
  return alpha_first ? (w & 0xffffff00u) | a : (w & 0x00ffffffu) | (a << 24);
}

// 1 in each 16-bit half whose value (at most 255) is not 0.
__device__ __forceinline__ uint32_t nonzero(uint32_t halves) {
  return ((halves + kHalves) >> 8) & 0x00010001u;
}

// (acc * span_mul + 2^23) >> 24 on each half: acc <= 255 * r and span_mul =
// round(2^24 / r), so the sum stays below 2^32.
__device__ __forceinline__ uint32_t normalise(uint32_t acc, uint32_t mul) {
  const uint32_t lo = (((acc & 0xffffu) * mul + 0x800000u) >> 24) & 0xffu;
  const uint32_t hi = (((acc >> 16) * mul + 0x800000u) >> 24) & 0xffu;
  return lo | (hi << 16);
}

// Adds a pixel's halves to (e, o); `first` weights it 255/256.
__device__ __forceinline__ void add_pixel(uint32_t px, bool first, uint32_t& e, uint32_t& o) {
  const uint32_t pe = px & kHalves, po = (px >> 8) & kHalves;
  e += first ? pe - nonzero(pe) : pe;
  o += first ? po - nonzero(po) : po;
}

// The end of one input row of a span: the L lanes of the span add their
// halves (butterfly, so every lane holds the sum), the sum is normalised to
// an h-row value (BOX x) and added to the V sums, weighted 255/256 on the
// span's first row.
__device__ __forceinline__ void end_row(uint32_t e, uint32_t o, int lanes, bool box_x,
                                        uint32_t mul_x, bool first_row, uint32_t& ve,
                                        uint32_t& vo) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    e += __shfl_xor_sync(0xffffffffu, e, off);
    o += __shfl_xor_sync(0xffffffffu, o, off);
  }
  if (box_x) {
    e = normalise(e, mul_x);
    o = normalise(o, mul_x);
  }
  if (first_row) {
    e -= nonzero(e);
    o -= nonzero(o);
  }
  ve += e;
  vo += o;
}

// numpy_ref.pack of one output pixel from its V sums: normalised (BOX y),
// unpremultiplied for unassociated output (unpremul_p8_to_u,
// generic.c:227-236, INVERTED_DIV_SHIFT_P8 = 13), swizzled.
__device__ __forceinline__ uint32_t pack(uint32_t ve, uint32_t vo, const BoxParams& p,
                                         bool alpha_first, unsigned perm,
                                         const int32_t* __restrict__ inv_div_p8) {
  if (p.box_y) {
    ve = normalise(ve, static_cast<uint32_t>(p.span_mul_y));
    vo = normalise(vo, static_cast<uint32_t>(p.span_mul_y));
  }
  uint32_t w = ve | (vo << 8);
  if (p.unassoc_out) {
    const uint32_t a = alpha_first ? (w & 0xffu) : (w >> 24);
    const uint64_t inv = static_cast<uint32_t>(__ldg(inv_div_p8 + a));
    uint32_t r = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t v = (w >> (8 * c)) & 0xffu;
      const bool is_a = alpha_first ? c == 0 : c == 3;
      r |= (is_a ? v : static_cast<uint32_t>((v * inv) >> 13) & 0xffu) << (8 * c);
    }
    w = r;
  }
  return __byte_perm(w, 0, perm);
}

__device__ __forceinline__ void store_pixel(uint32_t w, int nb_out, uint8_t* dst) {
  if (nb_out == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
    dst[0] = static_cast<uint8_t>(w);
    dst[1] = static_cast<uint8_t>(w >> 8);
    dst[2] = static_cast<uint8_t>(w >> 16);
  }
}

// ---------------------------------------------------------------------------
// cp.async (STAGED)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies the aligned 16-byte chunks that cover bytes [src, src + n) into
// `slot`; byte src + k lands at slot byte (src & 15) + k.
__device__ __forceinline__ void stage_row(uint8_t* slot, const uint8_t* src, int n, int lane) {
  if (n <= 0) return;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uint8_t* a0 = reinterpret_cast<const uint8_t*>(s & ~uintptr_t{15});
  const int chunks = (static_cast<int>(s & 15) + n + 15) >> 4;
  for (int k = lane; k < chunks; k += 32) cp_async16(slot + 16 * k, a0 + 16 * k);
}

// How the staged form reads a span's pixels from its slot.
enum Pixels {
  kPacked = 0,   // 4-byte pixels on word boundaries: one word each
  kShifted = 1,  // 4-byte pixels off word boundaries: two words, a funnel shift
  kRgb = 2,      // 3-byte pixels: 12-byte groups of 4 pixels as 3 words
};

// The 4 bytes at slot byte o.
template <int PX>
__device__ __forceinline__ uint32_t slot_word(const uint32_t* slot, int o) {
  if (PX == kPacked) return slot[o >> 2];
  return __funnelshift_r(slot[o >> 2], slot[(o >> 2) + 1], 8 * (o & 3));
}

// The low `r` bytes of a word kept (r clamped to 0-4).
__device__ __forceinline__ uint32_t low_bytes(int r) {
  return __funnelshift_rc(0xffffffffu, 0u, 8 * (4 - min(max(r, 0), 4)));
}

// One lane's share of a span row of `cols` pixels at slot byte `off`: the
// pixels k = g, g + lanes, ... (4-byte pixels), or the 12-byte groups
// t = g, g + lanes, ... of four 3-byte pixels, summed into (e, o) halves
// with the span's first pixel weighted 255/256 (`h_edge`).  A group's three
// words a, b, c hold the channels (0 1 2 0), (1 2 0 1), (2 0 1 2) in bytes
// 0-3; their halves are summed apart and sorted into channels once per row,
// and 24bpp alpha (255 per pixel) is added by lane 0.
template <int PX>
__device__ __forceinline__ void span_row(const uint32_t* slot, int off, int cols, int g,
                                         int lanes, bool h_edge, bool unassoc_in,
                                         bool alpha_first, uint32_t& e, uint32_t& o) {
  if (PX == kRgb) {
    // groups of 12 bytes at off + 12 t: four shared words, three funnel
    // shifts by the span's constant skew; only a last group short of 12
    // bytes (cols % 4 != 0) is masked
    const int full = cols >> 2, sh = 8 * (off & 3);
    const uint32_t* w = slot + (off >> 2);
    uint32_t ae = 0, ao = 0, be = 0, bo = 0, ce = 0, co = 0, first = 0;
    auto add_group = [&](int t, uint32_t ka, uint32_t kb, uint32_t kc) {
      const uint32_t w0 = w[3 * t], w1 = w[3 * t + 1], w2 = w[3 * t + 2], w3 = w[3 * t + 3];
      const uint32_t a = __funnelshift_r(w0, w1, sh) & ka;
      const uint32_t b = __funnelshift_r(w1, w2, sh) & kb;
      const uint32_t c = __funnelshift_r(w2, w3, sh) & kc;
      if (t == 0) first = a;
      ae += a & kHalves;
      ao += (a >> 8) & kHalves;
      be += b & kHalves;
      bo += (b >> 8) & kHalves;
      ce += c & kHalves;
      co += (c >> 8) & kHalves;
    };
    int t = g;
#pragma unroll 2
    for (; t < full; t += lanes) add_group(t, ~0u, ~0u, ~0u);
    if (t == full && (cols & 3)) {
      const int rem = 3 * (cols & 3);
      add_group(t, low_bytes(rem), low_bytes(rem - 4), low_bytes(rem - 8));
    }
    const uint32_t c0 = (ae & 0xffffu) + (ao >> 16) + (co & 0xffffu) + (be >> 16);
    const uint32_t c1 = (ao & 0xffffu) + (be & 0xffffu) + (bo >> 16) + (ce >> 16);
    const uint32_t c2 = (ae >> 16) + (bo & 0xffffu) + (ce & 0xffffu) + (co >> 16);
    e = c0 | (c2 << 16);
    o = c1;
    if (g == 0) {
      o += static_cast<uint32_t>(255 * cols - (h_edge ? 1 : 0)) << 16;
      if (h_edge) {
        e -= nonzero(first & kHalves);
        o -= nonzero((first >> 8) & 0xffu);
      }
    }
    return;
  }
  uint32_t first = 0;
#pragma unroll 4
  for (int k = g; k < cols; k += lanes) {
    uint32_t px = slot_word<PX>(slot, off + 4 * k);
    if (unassoc_in) px = premultiply(px, alpha_first);
    if (k == 0) first = px;
    add_pixel(px, false, e, o);
  }
  if (g == 0 && h_edge) {
    e -= nonzero(first & kHalves);
    o -= nonzero((first >> 8) & kHalves);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// FORM kDirect with W (1 or 2) words per lane per row, kCopy, or kStaged
// reading pixels as PX says.
template <int FORM, int W, int PX>
__global__ void __launch_bounds__(256) box_kernel(const uint8_t* __restrict__ in,
                                                  uint8_t* __restrict__ out,
                                                  const int32_t* __restrict__ inv_div_p8,
                                                  const BoxParams p) {
  constexpr int kNV = FORM == kCopy ? 8 : 2;  // V sum words per lane
  __shared__ uint32_t part[kMaxWarps][kNV][32];
  __shared__ __align__(16) uint8_t slots[FORM == kStaged ? kMaxWarps * kStages : 1]
                                        [FORM == kStaged ? kSlotBytes : 16];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wc = static_cast<int>(p.wc), splits = static_cast<int>(p.splits);
  const int wcol = warp % wc, split = warp / wc;  // block-constant divisors, once per thread
  const int cw = static_cast<int>(p.cw);
  const int lanes = FORM == kCopy ? 1 : 32 / cw;
  const int grp = lane / lanes, g = lane - grp * lanes;
  const int nb = static_cast<int>(p.nb_in), nb_out = static_cast<int>(p.nb_out);
  const int rx = static_cast<int>(p.rx), ry = static_cast<int>(p.ry);
  const int w_out = static_cast<int>(p.w_out), h_out = static_cast<int>(p.h_out);
  const int row_bytes = static_cast<int>(p.w_in) * nb;
  const int span_bytes = rx * nb;
  const bool alpha_first = p.alpha_ch == 0, unassoc_in = p.unassoc_in != 0;
  const bool box_x = p.box_x != 0;
  const uint32_t mul_x = static_cast<uint32_t>(p.span_mul_x);
  const unsigned perm = static_cast<unsigned>(p.src[0] | (p.src[1] << 4) | (p.src[2] << 8) |
                                              (p.src[3] << 12));
  const int rps = static_cast<int>(p.rows_per_split);
  // first output column of this warp, and of this lane's group
  const int j0 = (static_cast<int>(blockIdx.x) * wc + wcol) * cw;
  const int j = FORM == kCopy ? j0 + 4 * lane : j0 + grp;
  const bool active = j < w_out;
  const bool h_edge = box_x && j > 0;
  const bool drop_here = p.drop_x && j == w_out - 1;
  const int64_t img_in = static_cast<int64_t>(p.h_in) * row_bytes;
  const int64_t img_out = static_cast<int64_t>(h_out) * w_out * nb_out;
  const int q = span_bytes >> 4;  // kDirect: 16-byte words per span row

  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * img_in;
    for (int i = blockIdx.y; i < h_out; i += gridDim.y) {
      const int rows = ry - ((p.drop_y && i == h_out - 1) ? 1 : 0);
      const int t0 = split * rps;
      const int t1 = min(t0 + rps, rows);
      const bool v_edge = p.box_y && i > 0;
      const uint8_t* rows0 = img + static_cast<int64_t>(i) * ry * row_bytes;
      uint32_t ve[kNV / 2], vo[kNV / 2];
#pragma unroll
      for (int c = 0; c < kNV / 2; ++c) ve[c] = vo[c] = 0;

      if constexpr (FORM == kDirect) {
        constexpr int U = 4;
        const uint8_t* col = rows0 + j * span_bytes;
        for (int t = t0; t < t1; t += U) {
          uint4 x[U][W];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int m = 0; m < W; ++m) {
              const int wi = g + lanes * m;
              x[u][m] = (active && wi < q && t + u < t1)
                            ? __ldg(reinterpret_cast<const uint4*>(
                                  col + static_cast<int64_t>(t + u) * row_bytes) + wi)
                            : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (t + u >= t1) break;
            uint32_t e = 0, o = 0;
#pragma unroll
            for (int m = 0; m < W; ++m) {
              const int wi = g + lanes * m;
              uint32_t px[4] = {x[u][m].x, x[u][m].y, x[u][m].z, x[u][m].w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (unassoc_in) px[k] = premultiply(px[k], alpha_first);
                // the span's first pixel is weighted; the last, in a
                // clamped last span, dropped
                const bool first = k == 0 && wi == 0 && h_edge;
                const bool dropped = k == 3 && wi == q - 1 && drop_here;
                add_pixel(dropped ? 0u : px[k], first, e, o);
              }
            }
            end_row(e, o, lanes, box_x, mul_x, v_edge && t + u == 0, ve[0], vo[0]);
          }
        }
      } else if constexpr (FORM == kCopy) {
        constexpr int U = 4;
        const uint8_t* col = rows0 + j * 4;
        for (int t = t0; t < t1; t += U) {
          uint4 x[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            x[u] = (active && t + u < t1)
                       ? __ldg(reinterpret_cast<const uint4*>(
                             col + static_cast<int64_t>(t + u) * row_bytes))
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool first = v_edge && t + u == 0;
            uint32_t px[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (unassoc_in) px[k] = premultiply(px[k], alpha_first);
              add_pixel(px[k], first, ve[k], vo[k]);
            }
          }
        }
      } else {
        // STAGED: this warp's stretch of each row through its kStages slots
        uint8_t* my = &slots[warp * kStages][0];
        const int n = max(0, min(cw, w_out - j0)) * span_bytes;
        const uint8_t* src0 = rows0 + j0 * span_bytes;
        const int cols = rx - (drop_here ? 1 : 0);
        const int nrows = max(0, t1 - t0);
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          if (s < nrows)
            stage_row(my + s * kSlotBytes, src0 + static_cast<int64_t>(t0 + s) * row_bytes, n,
                      lane);
          cp_async_commit();
        }
        int cur = 0;
        for (int r = 0; r < nrows; ++r) {
          const int ahead = r + kStages - 1;
          int slot_ahead = cur + kStages - 1;
          if (slot_ahead >= kStages) slot_ahead -= kStages;
          if (ahead < nrows)
            stage_row(my + slot_ahead * kSlotBytes,
                      src0 + static_cast<int64_t>(t0 + ahead) * row_bytes, n, lane);
          cp_async_commit();
          cp_async_wait<kStages - 1>();
          __syncwarp();
          const uint32_t* slot = reinterpret_cast<const uint32_t*>(my + cur * kSlotBytes);
          // the row's skew: rows of w_in * nb bytes need not keep 16-byte alignment
          const int off0 = static_cast<int>(
                               (reinterpret_cast<uintptr_t>(src0) +
                                static_cast<uintptr_t>(t0 + r) * row_bytes) & 15) +
                           grp * span_bytes;
          uint32_t e = 0, o = 0;
          if (active)
            span_row<PX>(slot, off0, cols, g, lanes, h_edge, unassoc_in, alpha_first, e, o);
          end_row(e, o, lanes, box_x, mul_x, v_edge && t0 + r == 0, ve[0], vo[0]);
          __syncwarp();
          if (++cur == kStages) cur = 0;
        }
      }

      // the split warps' partial V sums, added in shared memory
      if (splits > 1) {
#pragma unroll
        for (int c = 0; c < kNV / 2; ++c) {
          part[warp][2 * c][lane] = ve[c];
          part[warp][2 * c + 1][lane] = vo[c];
        }
        __syncthreads();
        if (split == 0) {
          for (int s = 1; s < splits; ++s) {
#pragma unroll
            for (int c = 0; c < kNV / 2; ++c) {
              ve[c] += part[warp + s * wc][2 * c][lane];
              vo[c] += part[warp + s * wc][2 * c + 1][lane];
            }
          }
        }
        __syncthreads();
      }
      if (split != 0 || !active) continue;
      uint8_t* dst = out + b * img_out + (static_cast<int64_t>(i) * w_out + j) * nb_out;
      if constexpr (FORM == kCopy) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = pack(ve[k], vo[k], p, alpha_first, perm, inv_div_p8);
        if (nb_out == 4) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) store_pixel(w[k], 3, dst + 3 * k);
        }
      } else {
        if (g == 0)
          store_pixel(pack(ve[0], vo[0], p, alpha_first, perm, inv_div_p8), nb_out, dst);
      }
    }
  }
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8,
// `out` is (batch, h_out, w_out, nb_out) uint8 and 16-byte aligned,
// `inv_div_p8` holds 256 int32 (read only for unassociated output).  The
// form, block shape and grid come in `params` (ops/box.py `launch_shape`).
// The kernel runs on `stream` and is not waited for.  Returns
// cudaGetLastError() after the launch.
extern "C" int smolscale_box_scale(const uint8_t* in, uint8_t* out,
                                   const int32_t* inv_div_p8,
                                   const BoxParams* params, void* stream) {
  const BoxParams p = *params;
  if (p.batch * p.h_out * p.w_out <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(p.grid_x), static_cast<unsigned>(p.grid_y),
                  static_cast<unsigned>(p.grid_z));
  const unsigned threads = static_cast<unsigned>(32 * p.wc * p.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool word_aligned = (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const bool two_words = p.form == kDirect && ((p.rx / 4) > (32 / p.cw));
  if (p.form == kDirect && two_words) {
    box_kernel<kDirect, 2, kPacked><<<grid, threads, 0, s>>>(in, out, inv_div_p8, p);
  } else if (p.form == kDirect) {
    box_kernel<kDirect, 1, kPacked><<<grid, threads, 0, s>>>(in, out, inv_div_p8, p);
  } else if (p.form == kCopy) {
    box_kernel<kCopy, 1, kPacked><<<grid, threads, 0, s>>>(in, out, inv_div_p8, p);
  } else if (p.nb_in == 3) {
    box_kernel<kStaged, 1, kRgb><<<grid, threads, 0, s>>>(in, out, inv_div_p8, p);
  } else if (word_aligned) {
    box_kernel<kStaged, 1, kPacked><<<grid, threads, 0, s>>>(in, out, inv_div_p8, p);
  } else {
    box_kernel<kStaged, 1, kShifted><<<grid, threads, 0, s>>>(in, out, inv_div_p8, p);
  }
  return static_cast<int>(cudaGetLastError());
}
