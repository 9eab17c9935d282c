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
// unpacked where they are loaded: 24bpp input gets a constant alpha of 255
// (this replaces #12's planes feed), the PREMUL16 alpha (a << 8) | 0x80 is
// filtered like a colour, and linear light reads FROM_SRGB and INV_DIV_P8
// from a per-block shared-memory copy.  `row0` is the first output row
// computed (the row API).
//
// What bounds it: loads and per-pixel work.  Each thread loads and unpacks
// every input pixel its output depends on, so pixels shared by neighbouring
// outputs (overlapping bilinear pairs, box edges) are loaded and unpacked a
// few times, and a box axis of several thousand to one beside a bilinear
// axis serialises its span in one thread.  Neighbouring threads take
// neighbouring output columns, so a warp's loads of one tap row fall into
// one contiguous stretch that L1 serves.  Linear light adds three
// shared-memory gathers per loaded pixel, PREMUL16 three multiplies.  A
// later version could stage a block's h rows in shared memory and keep more
// loads in flight.
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
//   the normalising multiply is 64-bit;
//   byte offsets are 64-bit (8 x 2048^2 x 4 bytes is 128 MiB, larger inputs
//   pass 2^31).

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
  int64_t nb_in, nb_out;
  int64_t alpha_ch;                // work channel holding alpha: 0 or 3
  int64_t unassoc_in, unassoc_out;
  int64_t pack24_direct;           // plan.pack24_linear_direct
  int64_t src[4];                  // output byte k <- work channel src[k]
};

namespace {

// axis kinds, ops/bilinear.COPY, ONE, BILINEAR and BOX; kCopy is also the
// template kind of ONE (stride 0)
constexpr int kCopy = 0, kOne = 1, kBilinear = 2, kBox = 3;
constexpr uint32_t kWorkMask = 0xffffff, kNormMask = 0xffff;
constexpr int kThreads = 256;

// One axis's filter: its table (ops/bilinear.axis_table) and constants.
struct Axis {
  const int32_t* tab;
  int64_t len;
  int halvings;
  int64_t span_mul;
  int64_t stride;  // kCopy: 1 for COPY, 0 for ONE
};

__device__ __forceinline__ uint32_t lerp(uint32_t p, uint32_t q, int32_t f) {
  // numpy_ref._lerp: (p - q)*f is negative when p < q; >> floors it
  const int32_t d = static_cast<int32_t>(p) - static_cast<int32_t>(q);
  return static_cast<uint32_t>(((d * f) >> 8) + static_cast<int32_t>(q)) & kWorkMask;
}

// Output `j` of an axis of kind KIND over the values fetch(index, v).
template <int KIND, class Fetch>
__device__ __forceinline__ void filter(const Fetch& fetch, const Axis& ax,
                                       int64_t j, uint32_t out[4]) {
  if (KIND == kCopy) {
    fetch(j * ax.stride, out);
  } else if (KIND == kBilinear) {
    const int n = ax.halvings;
    uint32_t sum[4] = {0, 0, 0, 0};
    for (int k = 0; k < (1 << n); ++k) {
      const int64_t s = (j << n) + k;
      const int64_t o = __ldg(ax.tab + s);
      const int32_t f = __ldg(ax.tab + ax.len + s);
      uint32_t p[4], q[4];
      fetch(o, p);
      fetch(o + 1, q);
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += lerp(p[c], q[c], f);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = (sum[c] >> n) & kWorkMask;
  } else {  // kBox
    const int32_t* t = ax.tab + j;
    const int64_t len = ax.len;
    const uint32_t w_first = __ldg(t + len), w_last = __ldg(t + 5 * len);
    const int64_t mid = __ldg(t + 2 * len), mid_end = mid + __ldg(t + 3 * len);
    uint32_t v[4], acc[4];
    fetch(__ldg(t), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = weigh(v[c], w_first, kWorkMask);
    for (int64_t x = mid; x < mid_end; ++x) {
      fetch(x, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[c];
    }
    fetch(__ldg(t + 4 * len), v);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[c] = normalise(acc[c] + weigh(v[c], w_last, kWorkMask), ax.span_mul, kNormMask);
  }
}

// The unpacked pixels of one input row, by column.
template <int MODE, bool PACKED>
struct RowPixels {
  const uint8_t* row;
  Fmt f;
  const int32_t* lut;
  __device__ __forceinline__ void operator()(int64_t x, uint32_t v[4]) const {
    unpack<MODE>(load_pixel<PACKED>(row, x, f), f, lut, v);
  }
};

// The H-filtered values of output column j, by input row.
template <int KX, int MODE, bool PACKED>
struct HValues {
  const uint8_t* img;
  int64_t row_bytes;
  Fmt f;
  const int32_t* lut;
  Axis ax;
  int64_t j;
  __device__ __forceinline__ void operator()(int64_t r, uint32_t v[4]) const {
    filter<KX>(RowPixels<MODE, PACKED>{img + r * row_bytes, f, lut}, ax, j, v);
  }
};

template <int KX, int KY, int MODE, bool PACKED>
__global__ void __launch_bounds__(kThreads)
bilinear128_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const int32_t* __restrict__ luts, const int32_t* __restrict__ tab_x,
                   const int32_t* __restrict__ tab_y, const Bilinear128Params p) {
  constexpr bool kLinear = MODE == kP8Linear || MODE == kP16Linear;
  __shared__ int32_t s_lut[kLinear ? 512 : 1];
  if (kLinear) load_unpack_luts(luts, s_lut);
  const Fmt f{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const Axis ax{tab_x, p.len_x, static_cast<int>(p.halvings_x), p.span_mul_x,
                p.kind_x == kCopy};
  const Axis ay{tab_y, p.len_y, static_cast<int>(p.halvings_y), p.span_mul_y,
                p.kind_y == kCopy};
  const int64_t row_bytes = p.w_in * p.nb_in;
  const int64_t n_total = p.batch * p.n_rows * p.w_out;
  for (int64_t n = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       n < n_total; n += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = n % p.w_out;
    const int64_t i = p.row0 + (n / p.w_out) % p.n_rows;
    const int64_t b = n / (p.w_out * p.n_rows);
    const HValues<KX, MODE, PACKED> h{in + b * p.h_in * row_bytes, row_bytes, f, s_lut, ax, j};
    uint32_t o[4];
    filter<KY>(h, ay, i, o);
    pack_store<MODE>(o, p, luts, out + n * p.nb_out);
  }
}

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                         const int32_t*, const Bilinear128Params&, unsigned, cudaStream_t);

template <int KX, int KY, int MODE, bool PACKED>
void launch(const uint8_t* in, uint8_t* out, const int32_t* luts, const int32_t* tab_x,
            const int32_t* tab_y, const Bilinear128Params& p, unsigned blocks,
            cudaStream_t s) {
  bilinear128_kernel<KX, KY, MODE, PACKED><<<blocks, kThreads, 0, s>>>(
      in, out, luts, tab_x, tab_y, p);
}

template <int KX, int KY, int MODE>
Launcher pick(bool packed) {
  if (packed) return &launch<KX, KY, MODE, true>;
  return &launch<KX, KY, MODE, false>;
}

template <int KX, int KY>
Launcher pick(int64_t mode, bool packed) {
  switch (mode) {
    case kP8Compressed: return pick<KX, KY, kP8Compressed>(packed);
    case kP8Linear: return pick<KX, KY, kP8Linear>(packed);
    case kP16Compressed: return pick<KX, KY, kP16Compressed>(packed);
    case kP16Linear: return pick<KX, KY, kP16Linear>(packed);
  }
  return nullptr;
}

template <int KX>
Launcher pick(int64_t ky, int64_t mode, bool packed) {
  switch (ky) {
    case kCopy:
    case kOne: return pick<KX, kCopy>(mode, packed);
    case kBilinear: return pick<KX, kBilinear>(mode, packed);
    case kBox: return pick<KX, kBox>(mode, packed);
  }
  return nullptr;
}

Launcher pick(int64_t kx, int64_t ky, int64_t mode, bool packed) {
  switch (kx) {
    case kCopy:
    case kOne: return pick<kCopy>(ky, mode, packed);
    case kBilinear: return pick<kBilinear>(ky, mode, packed);
    case kBox: return pick<kBox>(ky, mode, packed);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8, `out`
// is (batch, n_rows, w_out, nb_out) uint8, `luts` the int32 tables of
// ops/pixels.lut_table, `tab_x` and `tab_y` the axes' tables.  The kernel
// runs on `stream` and is not waited for.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an axis kind or mode outside the
// class.
extern "C" int smolscale_bilinear128_scale(const uint8_t* in, uint8_t* out,
                                           const int32_t* luts, const int32_t* tab_x,
                                           const int32_t* tab_y,
                                           const Bilinear128Params* params, void* stream) {
  const Bilinear128Params p = *params;
  const int64_t n_total = p.batch * p.n_rows * p.w_out;
  if (n_total <= 0) return static_cast<int>(cudaSuccess);
  const bool packed = p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const Launcher fn = pick(p.kind_x, p.kind_y, p.mode, packed);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n_total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  fn(in, out, luts, tab_x, tab_y, p, static_cast<unsigned>(blocks),
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
