// The deep box class for Hopper (sm_90a): box x box plans at 64 or 128bpp
// storage, internal PREMUL8 or PREMUL16, compressed or linear gamma; 3- or
// 4-byte pixels in and out.
//
// Replaces the Pallas TPU kernels of smolscale_tpu/ops/pallas_deep.py:
// `_make_kernel` (:238, built by `_built`, pallas_call at :388, the
// integer-span tiling), `_make_general_kernel` (:469, `_built_general`
// :844, span-centric) and `_make_chunk_kernel` (:911, `_built_chunked`
// :1350, chunk-centric), with the planes feed of `scale_fn_planes` and the
// pack that follows them in backends/xla.py `_pack`.  The three are TPU
// tilings of one computation, the box walk of backends/numpy_ref.py
// `_box_axis` between the unpack and pack of the plan's (alpha, gamma)
// pair (pixels.cuh).  Their int8 span matrices, biased-limb matmuls, scalar-prefetch
// chunk tables and VMEM carry across grid steps exist for the MXU and
// Mosaic; this kernel computes the walk directly:
//
//   h(r, j) = norm_x( (px[r][first_j]*wf_j >> 8 & M) + sum px[r][mid_j]
//                     + (px[r][last_j]*wl_j >> 8 & M) )
//   o(i, j) = norm_y( (h(first_i, j)*w1_i >> 8 & M) + sum h(mid_i, j)
//                     + (h(last_i, j)*w2_i >> 8 & M) )
//   norm(acc) = ((acc*span_mul + 2^23) >> 24) & N
//
// with M the working mask (0xff at 64bpp, 0xffffff at 128bpp), N the
// normalised mask (0xff, 0xffff), and w2 the V last weight of the plan's
// storage (frac at 64bpp, max(frac - 1, 0) at 128bpp).  Each term is
// additive, so a row or pixel in two roles (a clamped last index inside the
// mid range) counts in both, as in numpy_ref.  H is rounded per input row
// before V.
//
// What bounds it: input bytes.  Deep plans have tiny outputs over large
// inputs (512 MiB -> 2,048 pixels): each input byte is read once (a span's
// edge row and column twice) and the work per byte is a few integer
// operations.  The design aims at every input byte crossing HBM once in
// 16-byte loads, several in flight per lane, on every SM, with few
// instructions per byte:
//
// - Work mapping without division (ops/deep.py `launch_shape`).  `L` lanes
//   (4-32, a power of two) share the span of one output column; a warp
//   covers `cw = 32 / L` columns of one output row and a range of the
//   span's input rows.  A block is `wc` such warps side by side times
//   `splits` warps that share the rows of the same columns, so that plans
//   with few outputs still fill the card.  Grid x is the column tiles,
//   grid y loops over output rows and grid z over images, both below 2^16.
//   Image and row bases are 64-bit, offsets inside a row 32-bit.
// - 16-byte loads of ragged spans.  A span's mid range [mid, mid_end)
//   starts at any byte; its lanes copy the aligned 16-byte words that cover
//   it (word g, g + L, ... of the row's cover, W = `units` of them per lane
//   per chunk, W <= 4 and L the least that allows it).  Words outside the
//   cover that no lane of the warp needs are skipped; pixels of the head
//   and tail words outside the range are dropped by a select.  The span's
//   first and last pixels are copied by lanes 0 and 1 of the span and
//   weighted there, each once.  Three pixel readers, chosen on the host
//   (ops/deep.py `form`): PACKED (4-byte pixels at a 4-byte aligned
//   address: a word is a pixel), SHIFTED (4-byte pixels off word
//   boundaries: two words and a funnel shift, the word after each 16-byte
//   word copied apart) and RGB (3-byte pixels: each word's bytes are
//   channels (p, p+1, p+2, p) for its phase p = row offset mod 3; words are
//   summed by phase and sorted into channels once per chunk; alpha, 255 per
//   pixel, is added as a count).
// - Bytes in flight without registers.  Each lane copies its words with
//   cp.async into its own slots of a ring of shared-memory stages, one
//   (row, chunk) item per stage, 8 words ahead of the one it sums (4 in
//   linear light); it reads back only its own slots, so no barrier is
//   needed.  Loading into registers instead bought bytes in flight with
//   occupancy (PERF.md §6).
// - Sums.  PREMUL8 at compressed gamma sums channels 0/2 and 1/3 as the
//   16-bit halves of two words within a chunk, premultiplying unassociated
//   input on the halves, and adds them into 32-bit channel sums at the
//   chunk's end; the other modes unpack each pixel into four 32-bit channel
//   sums (linear light through a shared-memory copy of from_srgb and
//   inv_div_p8; 3-byte pixels through a 256-entry table of the per-byte
//   unpack, alpha being 255).  At a row's end a transposed butterfly of
//   log2(L) + 1 shuffles leaves each lane the sum of one channel over the
//   span's lanes; the lane normalises it and adds it, weighted by the row's
//   roles in the V span, to its V sum.  The split warps' V sums are exact
//   integers, added in shared memory: the sums are deterministic, with no
//   atomics.  Lane 0 of the span gathers the four channels, normalises,
//   packs and stores the pixel.  No array is indexed at run time.
//
// Bounds (unsigned 32-bit sums, 64-bit normalising multiply):
//   unpacked values: 255 (PREMUL8), 2047 (PREMUL8 linear), 65408 (PREMUL16,
//   alpha (255 << 8) | 0x80), 2047*255 = 521985 (PREMUL16 linear);
//   an H span holds at most stride + 2 pixels.  Linear gamma is planned only
//   up to 8191:1 (smolscale.c:760-770), so a linear H sum is at most
//   8193*521985 < 2^32 over all lanes, per lane less; compressed sums at
//   most 32770*65408 < 2^31.  A 16-bit half holds at most 2*4*4 + 1 values
//   of at most 255 per chunk (PREMUL8 at compressed gamma only: 16-bit pair
//   sums would overflow at PREMUL16 and in linear light).  V sums add
//   normalised values <= 0xffff over at most 32770 rows < 2^31, whatever
//   the split: per lane and per split each is a part of that sum.
//   acc*span_mul < 2^32 * 2^21.
//
// The 16-byte copies read whole aligned 16-byte chunks (and 4-byte copies
// whole aligned words): a chunk that holds a byte of the span's range may
// hold bytes before the first or after the last byte of the input tensor;
// such a chunk lies in the same mapped page as its valid byte, and its
// bytes outside the range are never summed.  A lane with nothing to copy
// copies 0 bytes (zero-filled) from its row's aligned base.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "pixels.cuh"

// Launch parameters; the field order and the all-int64 layout match the
// ctypes Structure in ops/deep.py.
struct DeepParams {
  int64_t batch, h_in, w_in, h_out, w_out;
  int64_t row0, n_rows;            // output rows [row0, row0 + n_rows)
  int64_t span_mul_x, span_mul_y;  // box normalisation
  int64_t work_mask, out_mask;     // M and N above
  int64_t mode;                    // Mode
  int64_t nb_in, nb_out;
  int64_t alpha_ch;                // work channel holding alpha: 0 or 3
  int64_t unassoc_in, unassoc_out;
  int64_t pack24_direct;           // plan.pack24_linear_direct
  int64_t src[4];                  // output byte k <- work channel src[k]
  int64_t form;                    // kPacked, kShifted or kRgb (ops/deep.py FORMS)
  int64_t units;                   // 16-byte words per lane per span row and chunk: 1-4
  int64_t lanes;                   // L: lanes per span, 4-32
  int64_t cw;                      // output columns per warp, 32 / L
  int64_t chunks;                  // chunks of `units` words that cover the widest row
  int64_t wc, splits;              // warps per block: wc across columns x splits over rows
  int64_t rows_per_split;          // input rows of a span per split warp
  int64_t grid_x, grid_y, grid_z;
};

namespace {

enum Form { kPacked = 0, kShifted = 1, kRgb = 2 };

constexpr int kMaxWarps = 8;
// devices whose opt-in to the stages' shared memory is remembered
constexpr int kMaxDevices = 64;
constexpr int kMinBlocks = 3;  // blocks per SM that the register budget allows
constexpr uint32_t kHalves = 0x00ff00ffu;

// One entry of an axis's six-row box table (ops/bilinear.axis_table).
struct Span {
  int first, mid, mid_end, last;
  uint32_t w_first, w_last;
};

__device__ __forceinline__ Span load_span(const int32_t* __restrict__ tab, int len, int j) {
  Span s;
  s.first = __ldg(tab + j);
  s.w_first = static_cast<uint32_t>(__ldg(tab + len + j));
  s.mid = __ldg(tab + 2 * len + j);
  s.mid_end = s.mid + __ldg(tab + 3 * len + j);
  s.last = __ldg(tab + 4 * len + j);
  s.w_last = static_cast<uint32_t>(__ldg(tab + 5 * len + j));
  return s;
}

// premul_u_to_p8 (generic.c:238-244) on a pixel word: ((v+1)*(a+1)-1)>>8 =
// (v*a + v + a) >> 8 on each 16-bit half; alpha is kept.
__device__ __forceinline__ uint32_t premultiply(uint32_t px, bool alpha_first) {
  const uint32_t a = alpha_first ? (px & 0xffu) : (px >> 24);
  const uint32_t aa = a | (a << 16);
  const uint32_t e = px & kHalves, o = (px >> 8) & kHalves;
  const uint32_t pe = ((e * a + e + aa) >> 8) & kHalves;
  const uint32_t po = ((o * a + o + aa) >> 8) & kHalves;
  const uint32_t w = pe | (po << 8);
  return alpha_first ? (w & 0xffffff00u) | a : (w & 0x00ffffffu) | (a << 24);
}

// (v*w) >> 8 on each 16-bit half (v <= 255, w <= 256: no carry between them).
__device__ __forceinline__ uint32_t weigh_halves(uint32_t halves, uint32_t w) {
  return ((halves * w) >> 8) & kHalves;
}

// The low `r` bytes of a word kept (r clamped to 0-4).
__device__ __forceinline__ uint32_t low_bytes(int r) {
  return __funnelshift_rc(0xffffffffu, 0u, 8 * (4 - min(max(r, 0), 4)));
}

// The 16-bit halves of PREMUL8 at compressed gamma within a chunk: PACKED
// and SHIFTED h0 = channels 0/2, h1 = 1/3; RGB the words of phase 0, 1, 2 as
// (even, odd) byte halves in h0-h5.
struct Halves {
  uint32_t h[6];
};

// Adds a chunk's halves to the channel sums `s`.  An RGB word of phase p
// holds channels (p, p+1, p+2, p) in bytes 0-3.
template <int FORM>
__device__ __forceinline__ void flush_halves(const Halves& a, uint32_t s[4]) {
  if (FORM == kRgb) {
    const uint32_t ae = a.h[0], ao = a.h[1], be = a.h[2], bo = a.h[3], ce = a.h[4],
                   co = a.h[5];
    s[0] += (ae & 0xffffu) + (ao >> 16) + (be >> 16) + (co & 0xffffu);
    s[1] += (ao & 0xffffu) + (be & 0xffffu) + (bo >> 16) + (ce >> 16);
    s[2] += (ae >> 16) + (bo & 0xffffu) + (ce & 0xffffu) + (co >> 16);
  } else {
    s[0] += a.h[0] & 0xffffu;
    s[2] += a.h[0] >> 16;
    s[1] += a.h[1] & 0xffffu;
    s[3] += a.h[1] >> 16;
  }
}

// The __byte_perm selector that puts a 4-byte pixel's colour channels in
// bytes 0-2, in work-channel order, and its alpha in byte 3 (the canonical
// order of the modes that unpack each pixel).
__device__ __forceinline__ unsigned canon_perm(bool alpha_first) {
  return alpha_first ? 0x0321u : 0x3210u;
}

// numpy_ref.unpack of a pixel `q` in canonical order at MODE (PREMUL8
// linear or PREMUL16): colours in v[0..2], alpha in v[3].  PREMUL8's
// (l+1)*(8a+1)-1 is one multiply-add, its 11-bit mask dropped (l <= 2047
// gives at most 2040).
template <int MODE>
__device__ __forceinline__ void unpack_canon(uint32_t q, bool unassoc, const int32_t* lut,
                                             uint32_t v[4]) {
  const uint32_t a = q >> 24;
  const uint32_t a8 = (a << 3) + 1;
  // unpremul_p8 (generic.c:227-236) of premultiplied input
  const uint32_t inv = MODE == kP8Linear && !unassoc ? static_cast<uint32_t>(lut[256 + a]) : 0u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t b = (q >> (8 * c)) & 0xffu;
    if (MODE == kP8Linear) {
      const uint32_t u = unassoc ? b : ((b * inv) >> 13) & 0xffu;
      v[c] = (static_cast<uint32_t>(lut[u]) * a8 + a8 - 1) >> 11;  // generic.c:261-269
    } else if (MODE == kP16Compressed) {
      v[c] = b * a;  // generic.c:616-634
    } else {
      v[c] = static_cast<uint32_t>(lut[b]) * a;  // generic.c:636-660
    }
  }
  v[3] = MODE == kP8Linear ? a : (a << 8) | 0x80;
}

// Adds a pixel `q` (canonical order; 0 for a dropped pixel, which adds 0)
// to the colour sums s[0..2].  PREMUL16's alpha (a << 8) | 0x80 is summed as
// its raw alpha in `sa`, shifted at the row's end, and 0x80 per pixel of the
// span, added once per row; PREMUL8 linear's alpha a goes to s[3].
template <int MODE>
__device__ __forceinline__ void add_px(uint32_t q, bool unassoc, const int32_t* lut, uint32_t* s,
                                       uint32_t& sa) {
  uint32_t v[4];
  unpack_canon<MODE>(q, unassoc, lut, v);
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] += v[c];
  if (MODE == kP8Linear)
    s[3] += v[3];
  else
    sa += q >> 24;
}

// Adds one 16-byte word of a span row: `t` its offset from the row's
// aligned base, [lo, hi) the span's mid range there, `ok` false for a word
// the lane did not load; `extra` the word after it (SHIFTED), `skew` the
// row's offset from its aligned base, `tab` the per-byte unpack (RGB in
// linear light).  UNASSOC premultiplies 4-byte pixels on the halves; MASK
// false skips the range test, for words wholly inside their range (or not
// loaded, which are 0 and add 0).
template <int MODE, int FORM, bool UNASSOC, bool MASK>
__device__ __forceinline__ void add_word(uint4 x, uint32_t extra, bool ok, int t, int lo, int hi,
                                         int skew, const Fmt& f, unsigned perm,
                                         const int32_t* s_lut, const int32_t* s_tab, Halves& a,
                                         uint32_t* sum, uint32_t& sa) {
  const uint32_t w[5] = {x.x, x.y, x.z, x.w, extra};
  if constexpr (FORM == kRgb) {
    uint32_t m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = MASK ? w[k] & low_bytes(hi - (t + 4 * k)) & ~low_bytes(lo - (t + 4 * k)) : w[k];
    // the phase of word 0 (byte 0's channel); words 1, 2 follow, word 3 is
    // word 0's (16 = 1 mod 3); t - skew >= -15
    const int ph = (t - skew + 48) % 3;
    const bool p1 = ph == 1, p2 = ph == 2;
    if constexpr (MODE == kP8Compressed) {
      const uint32_t e0 = (m[0] & kHalves) + (m[3] & kHalves);
      const uint32_t o0 = ((m[0] >> 8) & kHalves) + ((m[3] >> 8) & kHalves);
      const uint32_t e1 = m[1] & kHalves, o1 = (m[1] >> 8) & kHalves;
      const uint32_t e2 = m[2] & kHalves, o2 = (m[2] >> 8) & kHalves;
      // phase 0, 1, 2 accumulators take the words of those phases
      a.h[0] += p1 ? e2 : p2 ? e1 : e0;
      a.h[1] += p1 ? o2 : p2 ? o1 : o0;
      a.h[2] += p1 ? e0 : p2 ? e2 : e1;
      a.h[3] += p1 ? o0 : p2 ? o2 : o1;
      a.h[4] += p1 ? e1 : p2 ? e0 : e2;
      a.h[5] += p1 ? o1 : p2 ? o0 : o2;
    } else {
      // the channel ph + c of each byte, c = 0, 1, 2 (tab[0] = 0 for the
      // dropped bytes: from_srgb(0) = 0)
      auto T = [&](uint32_t v, int byte) {
        return static_cast<uint32_t>(s_tab[(v >> (8 * byte)) & 0xffu]);
      };
      const uint32_t r0 = T(m[0], 0) + T(m[0], 3) + T(m[1], 2) + T(m[2], 1) + T(m[3], 0) +
                          T(m[3], 3);
      const uint32_t r1 = T(m[0], 1) + T(m[1], 0) + T(m[1], 3) + T(m[2], 2) + T(m[3], 1);
      const uint32_t r2 = T(m[0], 2) + T(m[1], 1) + T(m[2], 0) + T(m[2], 3) + T(m[3], 2);
      sum[0] += p1 ? r2 : p2 ? r1 : r0;
      sum[1] += p1 ? r0 : p2 ? r2 : r1;
      sum[2] += p1 ? r1 : p2 ? r0 : r2;
    }
  } else {
    // pixels start at byte s of each word (SHIFTED); pixel k of the word
    // lies in the range for k in [k_lo, k_hi)
    const int s = skew & 3;
    const int k_lo = ok ? (lo - t - s) >> 2 : 4, k_hi = (hi - t - s + 3) >> 2;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t px = FORM == kPacked ? w[k] : __funnelshift_r(w[k], w[k + 1], 8 * s);
      const bool in = !MASK || (k >= k_lo && k < k_hi);
      if constexpr (MODE == kP8Compressed) {
        uint32_t v = in ? px : 0u;
        if (UNASSOC) v = premultiply(v, f.alpha_first);
        a.h[0] += v & kHalves;
        a.h[1] += (v >> 8) & kHalves;
      } else {
        add_px<MODE>(__byte_perm(in ? px : 0u, 0, perm), f.unassoc, s_lut, sum, sa);
      }
    }
  }
}

// Adds an edge pixel `px` weighted by `w` (0 on lanes without an edge).
template <int MODE, int FORM, bool UNASSOC>
__device__ __forceinline__ void add_edge(uint32_t px, uint32_t w, uint32_t mask, const Fmt& f,
                                         unsigned perm, const int32_t* s_lut, Halves& a,
                                         uint32_t* sum) {
  if constexpr (MODE == kP8Compressed) {
    if (FORM == kRgb) {
      px &= 0x00ffffffu;  // alpha is counted apart; the channels land as a phase-0 word's
    } else if (UNASSOC) {
      px = premultiply(px, f.alpha_first);
    }
    a.h[0] += weigh_halves(px & kHalves, w);
    a.h[1] += weigh_halves((px >> 8) & kHalves, w);
  } else {
    // RGB in work order (its alpha counted apart), 4-byte pixels canonical
    uint32_t v[4];
    if (FORM == kRgb)
      unpack<MODE>(px, f, s_lut, v);
    else
      unpack_canon<MODE>(__byte_perm(px, 0, perm), f.unassoc, s_lut, v);
#pragma unroll
    for (int c = 0; c < (FORM == kRgb ? 3 : 4); ++c) sum[c] += weigh(v[c], w, mask);
  }
}

// The four channel sums of the L lanes of a span, transposed: lane g of the
// span returns the sum of channel 2*bit(L/2) + bit(L/4) of g.  L >= 4.
__device__ __forceinline__ uint32_t span_sum_transposed(const uint32_t s[4], int g, int lanes) {
  const int h = lanes >> 1, q = lanes >> 2;
  const bool hi = g & h;
  uint32_t k0 = hi ? s[2] : s[0], k1 = hi ? s[3] : s[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? s[0] : s[2], h);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? s[1] : s[3], h);
  const bool odd = g & q;
  uint32_t k = odd ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, q);
  for (int off = q >> 1; off > 0; off >>= 1) k += __shfl_xor_sync(0xffffffffu, k, off);
  return k;
}

// cp.async of `n` bytes (16, or 4) of global `src` into shared `dst`; the
// rest of the 16 or 4 bytes are zero-filled (n = 0: zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage of a warp's pipeline: what each lane copies of one chunk of one
// span row (lane-major, so that a lane's 16-byte reads hit no bank twice).
// A lane reads back only its own copies, so a stage needs no barrier.
template <int FORM, int W>
struct Stage {
  uint4 x[W][32];
  uint32_t xe[FORM == kShifted ? W : 1][32];   // SHIFTED: the word after each
  uint32_t edge[FORM == kPacked ? 1 : 2][32];  // the span's first or last pixel's words
};

// 16-byte words in flight per lane: the stages ahead of the one being
// summed hold this many, whatever W (fewer in linear light, whose work per
// word is larger).
constexpr int kInFlight = 8, kInFlightLinear = 4;
template <int MODE, int W>
__host__ __device__ constexpr int stages() {
  constexpr int words = MODE == kP8Linear || MODE == kP16Linear ? kInFlightLinear : kInFlight;
  return 1 + (words + W - 1) / W;
}

// Where the words of chunk c of span row `row` lie for lane g: the row's
// skew from its aligned base, the span's range [lo, hi) from that base, and
// the lane's first word and the end of the cover.
struct Cover {
  int skew, lo, hi, u0, u_end;
};
__device__ __forceinline__ Cover cover(const uint8_t* row, int lo_b, int hi_b, int g, int lanes,
                                       int w_per_chunk, int c) {
  Cover v;
  v.skew = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  v.lo = v.skew + lo_b;
  v.hi = v.skew + hi_b;
  v.u0 = (v.lo >> 4) + g + lanes * w_per_chunk * c;
  v.u_end = (v.hi + 15) >> 4;
  return v;
}

// FORM reads pixels as above; W words per lane per chunk.
template <int MODE, int FORM, int W>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
deep_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            const int32_t* __restrict__ luts, const int32_t* __restrict__ tab_x,
            const int32_t* __restrict__ tab_y, const DeepParams p) {
  constexpr int S = stages<MODE, W>();
  constexpr bool kLinear = MODE == kP8Linear || MODE == kP16Linear;
  constexpr bool kTab = FORM == kRgb && MODE == kP8Linear;
  __shared__ int32_t s_lut[kLinear ? 512 : 1];
  __shared__ int32_t s_tab[kTab ? 256 : 1];
  __shared__ uint32_t part[kMaxWarps][32];
  extern __shared__ __align__(16) uint8_t s_stages[];

  const Fmt f{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  if (kLinear) load_unpack_luts(luts, s_lut);
  if (kTab) {
    // the unpack of a byte of a 3-byte pixel (alpha 255) in linear light
    for (int k = threadIdx.x; k < 256; k += blockDim.x) {
      uint32_t v[4];
      unpack<MODE>(static_cast<uint32_t>(k) | 0xff000000u, f, s_lut, v);
      s_tab[k] = static_cast<int32_t>(v[0]);
    }
    __syncthreads();
  }
  // premultiplying on the halves: PREMUL8 at compressed gamma, 4-byte
  // unassociated input (a warp-uniform branch between two copies of the sums)
  const bool premul = MODE == kP8Compressed && FORM != kRgb && f.unassoc;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Stage<FORM, W>* st = reinterpret_cast<Stage<FORM, W>*>(s_stages) + warp * S;
  const int wc = static_cast<int>(p.wc), splits = static_cast<int>(p.splits);
  const int split = warp / wc, wcol = warp - split * wc;  // once per thread
  const int lanes = static_cast<int>(p.lanes), cw = static_cast<int>(p.cw);
  const int grp = lane / lanes, g = lane & (lanes - 1);
  const int w_out = static_cast<int>(p.w_out), h_out = static_cast<int>(p.h_out);
  const int j = (static_cast<int>(blockIdx.x) * wc + wcol) * cw + grp;
  const bool active = j < w_out;
  const int nb = static_cast<int>(p.nb_in), nb_out = static_cast<int>(p.nb_out);
  const uint32_t mask = static_cast<uint32_t>(p.work_mask);
  const uint32_t out_mask = static_cast<uint32_t>(p.out_mask);
  const int row_bytes = static_cast<int>(p.w_in) * nb;
  const int64_t img_in = static_cast<int64_t>(p.h_in) * row_bytes;
  const int chunks = static_cast<int>(p.chunks), rps = static_cast<int>(p.rows_per_split);

  Span sx{0, 0, 0, 0, 0, 0};
  if (active) sx = load_span(tab_x, w_out, j);
  const int lo_b = sx.mid * nb, hi_b = sx.mid_end * nb;
  // lanes 0 and 1 of the span load its first and last pixel
  const bool edge_lane = active && g < 2;
  const int edge_b = (g == 0 ? sx.first : sx.last) * nb;
  const uint32_t edge_w = edge_lane ? (g == 0 ? sx.w_first : sx.w_last) : 0u;
  // what a row adds to the alpha sum whatever its pixels, once, by lane 0:
  // RGB's alpha (255 per pixel), PREMUL16's 0x80 per pixel of the mid range
  constexpr bool kP16 = MODE == kP16Compressed || MODE == kP16Linear;
  const uint32_t mid_len = static_cast<uint32_t>(sx.mid_end - sx.mid);
  uint32_t alpha_h = 0;
  if (FORM == kRgb && active && g == 0)
    alpha_h = 255u * mid_len + weigh(255u, sx.w_first, mask) + weigh(255u, sx.w_last, mask);
  if (kP16 && active && g == 0) alpha_h = 0x80u * mid_len;
  const unsigned perm = canon_perm(f.alpha_first);  // per-pixel modes, 4-byte pixels

  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * img_in;
    for (int i = blockIdx.y; i < p.n_rows; i += gridDim.y) {
      const Span sy = load_span(tab_y, h_out, static_cast<int>(p.row0) + i);
      const int r_end = max(sy.last + 1, sy.mid_end);
      const int t0 = sy.first + split * rps;
      const int t1 = min(t0 + rps, r_end);
      // the split's (row, chunk) items, row-major, through S stages
      const int n_items = max(t1 - t0, 0) * chunks;
      int r_in = t0, c_in = 0;  // the next item to copy
      auto issue = [&](int s) {
        if (r_in < t1) {
          Stage<FORM, W>& sg = st[s];
          const uint8_t* row = img + static_cast<int64_t>(r_in) * row_bytes;
          const Cover v = cover(row, lo_b, hi_b, g, lanes, W, c_in);
          const uint8_t* base = row - v.skew;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int unit = v.u0 + lanes * w;
            const bool ok = active && unit < v.u_end;
            cp_async16(&sg.x[w][lane], ok ? base + 16 * unit : base, ok ? 16 : 0);
            if (FORM == kShifted) {
              const bool okx = ok && 16 * unit + 16 < v.hi;
              cp_async4(&sg.xe[w][lane], okx ? base + 16 * unit + 16 : base, okx ? 4 : 0);
            }
          }
          if (c_in == 0) {
            if constexpr (FORM == kPacked) {
              cp_async4(&sg.edge[0][lane], edge_lane ? row + edge_b : base, edge_lane ? 4 : 0);
            } else {
              // the pixel's aligned word, and the next where its bytes reach it
              const uintptr_t a = reinterpret_cast<uintptr_t>(row + edge_b);
              const uint8_t* w0 = reinterpret_cast<const uint8_t*>(a & ~uintptr_t{3});
              const bool two = edge_lane && static_cast<int>(a & 3) + nb > 4;
              cp_async4(&sg.edge[0][lane], edge_lane ? w0 : base, edge_lane ? 4 : 0);
              cp_async4(&sg.edge[1][lane], two ? w0 + 4 : base, two ? 4 : 0);
            }
          }
          if (++c_in == chunks) {
            c_in = 0;
            ++r_in;
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int s = 0; s < S - 1; ++s) issue(s);

      uint32_t acc = 0;  // V sum of this lane's channel
      uint32_t sums[4] = {0, 0, 0, alpha_h};
      uint32_t sa = 0;  // PREMUL16: the raw alpha of the row's mid pixels
      int r = t0, c = 0;
      for (int k = 0; k < n_items; ++k) {
        const int s_use = k % S;
        issue((k + S - 1) % S);
        cp_async_wait<S - 1>();
        const Stage<FORM, W>& sg = st[s_use];
        const uint8_t* row = img + static_cast<int64_t>(r) * row_bytes;
        const Cover v = cover(row, lo_b, hi_b, g, lanes, W, c);
        Halves hv{{0, 0, 0, 0, 0, 0}};
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int unit = v.u0 + lanes * w;
          const bool ok = active && unit < v.u_end;
          // a word no lane of the warp loaded is skipped (a uniform branch);
          // the modes that unpack each pixel take every word, so that the
          // compiler interleaves their chains
          if ((MODE != kP8Compressed && FORM != kShifted) || __any_sync(0xffffffffu, ok)) {
            const uint4 x = sg.x[w][lane];
            const uint32_t xe = FORM == kShifted ? sg.xe[w][lane] : 0u;
            // 3-byte words of the span's interior (every byte of the word in
            // range) skip the byte masks: a uniform branch (4-byte pixels'
            // range test is cheaper than the vote)
            const int t = 16 * unit;
            const bool whole =
                FORM == kRgb && __all_sync(0xffffffffu, !ok || (t >= v.lo && t + 16 <= v.hi));
            if (premul && whole)
              add_word<MODE, FORM, true, false>(x, xe, ok, t, v.lo, v.hi, v.skew, f, perm, s_lut,
                                                s_tab, hv, sums, sa);
            else if (premul)
              add_word<MODE, FORM, true, true>(x, xe, ok, t, v.lo, v.hi, v.skew, f, perm, s_lut,
                                               s_tab, hv, sums, sa);
            else if (whole)
              add_word<MODE, FORM, false, false>(x, xe, ok, t, v.lo, v.hi, v.skew, f, perm, s_lut,
                                                 s_tab, hv, sums, sa);
            else
              add_word<MODE, FORM, false, true>(x, xe, ok, t, v.lo, v.hi, v.skew, f, perm, s_lut,
                                                s_tab, hv, sums, sa);
          }
        }
        if (c == 0) {
          uint32_t px = sg.edge[0][lane];
          if constexpr (FORM != kPacked) {
            const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(row + edge_b) & 3);
            px = __funnelshift_r(px, sg.edge[1][lane], 8 * sh);
            if (FORM == kRgb) px = (px & 0x00ffffffu) | 0xff000000u;
          }
          if (premul)
            add_edge<MODE, FORM, true>(px, edge_w, mask, f, perm, s_lut, hv, sums);
          else
            add_edge<MODE, FORM, false>(px, edge_w, mask, f, perm, s_lut, hv, sums);
        }
        if (MODE == kP8Compressed) flush_halves<FORM>(hv, sums);
        if (++c == chunks) {
          // the row's end: the span's sum, normalised, weighted by the row's
          // roles in the V span; 4-byte pixels summed per pixel go back from
          // canonical to work-channel order
          if (kP16) sums[3] += sa << 8;
          sa = 0;
          if (MODE != kP8Compressed && FORM != kRgb && f.alpha_first) {
            const uint32_t alpha = sums[3];
            sums[3] = sums[2];
            sums[2] = sums[1];
            sums[1] = sums[0];
            sums[0] = alpha;
          }
          const uint32_t h = normalise(span_sum_transposed(sums, g, lanes), p.span_mul_x,
                                       out_mask);
          if (r >= sy.mid && r < sy.mid_end) acc += h;
          if (r == sy.first) acc += weigh(h, sy.w_first, mask);
          if (r == sy.last) acc += weigh(h, sy.w_last, mask);
          sums[0] = sums[1] = sums[2] = 0;
          sums[3] = alpha_h;
          c = 0;
          ++r;
        }
      }
      cp_async_wait<0>();

      // the split warps' partial V sums, added in shared memory
      if (splits > 1) {
        part[warp][lane] = acc;
        __syncthreads();
        if (split == 0)
          for (int s = 1; s < splits; ++s) acc += part[wcol + s * wc][lane];
        __syncthreads();
      }
      if (split != 0) continue;
      // lane 0 of the span gathers the four channels
      uint32_t o[4];
      const int base_lane = lane - g;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int from = base_lane + (c >> 1) * (lanes >> 1) + (c & 1) * (lanes >> 2);
        o[c] = normalise(__shfl_sync(0xffffffffu, acc, from), p.span_mul_y, out_mask);
      }
      if (g == 0 && active)
        pack_store<MODE>(o, p, luts,
                         out + ((b * p.n_rows + i) * w_out + j) * static_cast<int64_t>(nb_out));
    }
  }
}

typedef cudaError_t (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                                const int32_t*, const DeepParams&, cudaStream_t);

template <int MODE, int FORM, int W>
cudaError_t launch(const uint8_t* in, uint8_t* out, const int32_t* luts, const int32_t* tab_x,
                   const int32_t* tab_y, const DeepParams& p, cudaStream_t s) {
  constexpr size_t kStageBytes = stages<MODE, W>() * sizeof(Stage<FORM, W>);
  // the stages' shared memory, and the largest shared-memory carveout: left
  // to the driver, the carveout after another kernel may hold fewer blocks
  // per SM.  CUDA keeps function attributes per device, so each device that
  // launches this instance opts in once (a device past kMaxDevices, at
  // every launch).
  static std::atomic<bool> opted[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !opted[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(deep_kernel<MODE, FORM, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxWarps * kStageBytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(deep_kernel<MODE, FORM, W>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) opted[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(static_cast<unsigned>(p.grid_x), static_cast<unsigned>(p.grid_y),
                  static_cast<unsigned>(p.grid_z));
  const unsigned threads = static_cast<unsigned>(32 * p.wc * p.splits);
  deep_kernel<MODE, FORM, W><<<grid, threads, p.wc * p.splits * kStageBytes, s>>>(
      in, out, luts, tab_x, tab_y, p);
  return cudaGetLastError();
}

template <int MODE, int FORM>
Launcher pick(int64_t units) {
  switch (units) {
    case 1: return &launch<MODE, FORM, 1>;
    case 2: return &launch<MODE, FORM, 2>;
    case 3: return &launch<MODE, FORM, 3>;
    case 4: return &launch<MODE, FORM, 4>;
  }
  return nullptr;
}

template <int MODE>
Launcher pick(int64_t form, int64_t units) {
  if (form == kPacked) return pick<MODE, kPacked>(units);
  if (form == kShifted) return pick<MODE, kShifted>(units);
  if constexpr (MODE == kP8Compressed || MODE == kP8Linear) {
    if (form == kRgb) return pick<MODE, kRgb>(units);
  }
  return nullptr;
}

Launcher pick(int64_t mode, int64_t form, int64_t units) {
  switch (mode) {
    case kP8Compressed: return pick<kP8Compressed>(form, units);
    case kP8Linear: return pick<kP8Linear>(form, units);
    case kP16Compressed: return pick<kP16Compressed>(form, units);
    case kP16Linear: return pick<kP16Linear>(form, units);
  }
  return nullptr;
}

bool pow2_in(int64_t v, int64_t lo, int64_t hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8, `out`
// is (batch, n_rows, w_out, nb_out) uint8, `luts` the int32 tables of
// ops/pixels.lut_table, `tab_x` and `tab_y` the axes' box tables; the pixel
// reader, block shape and grid come in `params` (ops/deep.py
// `launch_shape`).  The kernel runs on `stream` and is not waited for.
// Returns the launch's error, or cudaErrorInvalidValue for parameters the
// kernel does not take (a PACKED reader on an input that is not 4-byte
// aligned among them).
extern "C" int smolscale_deep_scale(const uint8_t* in, uint8_t* out, const int32_t* luts,
                                    const int32_t* tab_x, const int32_t* tab_y,
                                    const DeepParams* params, void* stream) {
  const DeepParams p = *params;
  if (p.batch * p.n_rows * p.w_out <= 0) return static_cast<int>(cudaSuccess);
  const bool packed_ok = p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const bool form_ok = p.form == kPacked ? packed_ok
                       : p.form == kShifted ? p.nb_in == 4 && !packed_ok
                                            : p.nb_in == 3;
  if (!form_ok || !pow2_in(p.lanes, 4, 32) || p.cw * p.lanes != 32 ||
      !pow2_in(p.splits, 1, kMaxWarps) || p.wc < 1 || p.wc * p.splits > kMaxWarps ||
      p.chunks < 1 ||
      p.rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launcher fn = pick(p.mode, p.form, p.units);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(in, out, luts, tab_x, tab_y, p, static_cast<cudaStream_t>(stream)));
}
