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
// Design.  Deep plans have tiny outputs over large inputs (512 MiB -> 2,048
// pixels), so one thread per output pixel, as box.cu does, would leave the
// card idle.  Here one block computes one output pixel (b, i, j): its warps
// take the input rows of span i in turn, and the 32 lanes of a warp read
// the row's mid pixels of span j coalesced, lanes 0 and 1 its two edge
// pixels.  A transposing shuffle reduction (6 shuffles for 4 channels)
// leaves lane L with the row's H sum of channel 2*bit4(L) + bit3(L); the
// lane normalises it, weights it by the row's roles in span i and adds it
// to its running V sum.  Shared memory then sums the warps, and one thread
// normalises, packs and stores the pixel.  Nothing is carried across blocks,
// so the TPU's sequential chunk axis and its chunk-edge bookkeeping (where
// the TPU's chunk-centric table once lost a span ending on a chunk
// boundary, pallas_deep.py:1269-1274) have no counterpart; neighbouring
// spans share one edge row and one edge column, which both blocks read.
// `row0` is the first output row computed (the row API).
//
// What bounds it: input bytes.  Each input byte is read once (edges twice),
// coalesced, four loads per lane in flight per row; the per-pixel work on
// the compressed path is the byte unpack and four adds.  Linear light adds
// from_srgb gathers from a shared-memory copy of the table (and the
// inv_div_p8 unpremultiply of premultiplied input); the pack's tables
// (to_srgb, inv_div_*) are read once per output pixel from global memory.
//
// Bounds (unsigned 32-bit sums, 64-bit normalising multiply):
//   unpacked values: 255 (PREMUL8), 2047 (PREMUL8 linear), 65408 (PREMUL16,
//   alpha (255 << 8) | 0x80), 2047*255 = 521985 (PREMUL16 linear);
//   an H span holds at most stride + 2 pixels.  Linear gamma is planned only
//   up to 8191:1 (smolscale.c:760-770), so a linear H sum is at most
//   8193*521985 < 2^32; compressed sums at most 32770*65408 < 2^31.
//   V sums add normalised values <= 0xffff over at most 32770 rows < 2^31.
//   acc*span_mul < 2^32 * 2^21 (span_mul ~ 2^24 / span, span > 8).
//   Byte offsets are 64-bit: 8 x 4096^2 x 4 bytes is 512 MiB, larger inputs
//   pass 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixels.cuh"

// Launch parameters; the field order and the all-int64 layout match the
// ctypes Structure in ops/deep.py.
struct DeepParams {
  int64_t batch, h_in, w_in, h_out, w_out;
  int64_t row0, n_rows;            // output rows [row0, row0 + n_rows)
  int64_t span_mul_x, span_mul_y;  // box normalisation
  int64_t work_mask, out_mask;     // M and N above
  int64_t mode;                    // Mode
  int64_t warps;                   // warps per block, 1..16
  int64_t nb_in, nb_out;
  int64_t alpha_ch;                // work channel holding alpha: 0 or 3
  int64_t unassoc_in, unassoc_out;
  int64_t pack24_direct;           // plan.pack24_linear_direct
  int64_t src[4];                  // output byte k <- work channel src[k]
};

namespace {

constexpr int kMaxWarps = 16;
constexpr int kUnroll = 4;

// One entry of an axis's six-row box table (ops/bilinear.axis_table).
struct Span {
  int64_t first, mid, mid_end, last;
  uint32_t w_first, w_last;
};

__device__ __forceinline__ Span load_span(const int32_t* __restrict__ tab,
                                          int64_t len, int64_t j) {
  Span s;
  s.first = __ldg(tab + j);
  s.w_first = static_cast<uint32_t>(__ldg(tab + len + j));
  s.mid = __ldg(tab + 2 * len + j);
  s.mid_end = s.mid + __ldg(tab + 3 * len + j);
  s.last = __ldg(tab + 4 * len + j);
  s.w_last = static_cast<uint32_t>(__ldg(tab + 5 * len + j));
  return s;
}

// Sums of 4 channels over the warp, transposed: lane L returns the sum of
// channel 2*bit4(L) + bit3(L) over all 32 lanes.
__device__ __forceinline__ uint32_t warp_sum_transposed(const uint32_t s[4], int lane) {
  const bool hi = lane & 16;
  uint32_t k0 = hi ? s[2] : s[0], k1 = hi ? s[3] : s[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? s[0] : s[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? s[1] : s[3], 16);
  const bool odd = lane & 8;
  uint32_t k = odd ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 8);
  k += __shfl_xor_sync(0xffffffffu, k, 4);
  k += __shfl_xor_sync(0xffffffffu, k, 2);
  k += __shfl_xor_sync(0xffffffffu, k, 1);
  return k;
}

template <int MODE, bool PACKED>
__global__ void __launch_bounds__(32 * kMaxWarps)
deep_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            const int32_t* __restrict__ luts, const int32_t* __restrict__ tab_x,
            const int32_t* __restrict__ tab_y, const DeepParams p) {
  constexpr bool kLinear = MODE == kP8Linear || MODE == kP16Linear;
  __shared__ int32_t s_lut[kLinear ? 512 : 1];
  __shared__ uint32_t s_acc[kMaxWarps][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (kLinear) load_unpack_luts(luts, s_lut);
  const Fmt f{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const uint32_t mask = static_cast<uint32_t>(p.work_mask);
  const uint32_t out_mask = static_cast<uint32_t>(p.out_mask);
  const int64_t row_bytes = p.w_in * p.nb_in;
  const int ch = ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
  const int64_t n_total = p.batch * p.n_rows * p.w_out;

  for (int64_t n = blockIdx.x; n < n_total; n += gridDim.x) {
    const int64_t j = n % p.w_out;
    const int64_t i = p.row0 + (n / p.w_out) % p.n_rows;
    const int64_t b = n / (p.w_out * p.n_rows);
    const Span sx = load_span(tab_x, p.w_out, j);
    const Span sy = load_span(tab_y, p.h_out, i);
    const int64_t r_end = max(sy.last + 1, sy.mid_end);
    const uint8_t* img = in + b * p.h_in * row_bytes;
    uint32_t acc = 0;  // V sum of channel `ch`
    for (int64_t r = sy.first + warp; r < r_end; r += n_warps) {
      const uint8_t* row = img + r * row_bytes;
      uint32_t s[4] = {0, 0, 0, 0};
      if (lane < 2) {  // the edge pixels, weighted on their own
        uint32_t v[4];
        unpack<MODE>(load_pixel<PACKED>(row, lane ? sx.last : sx.first, f), f, s_lut, v);
        const uint32_t w = lane ? sx.w_last : sx.w_first;
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = weigh(v[c], w, mask);
      }
      for (int64_t x0 = sx.mid + lane; x0 < sx.mid_end; x0 += 32 * kUnroll) {
        uint32_t px[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          px[u] = x0 + 32 * u < sx.mid_end ? load_pixel<PACKED>(row, x0 + 32 * u, f) : 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (x0 + 32 * u < sx.mid_end) {
            uint32_t v[4];
            unpack<MODE>(px[u], f, s_lut, v);
#pragma unroll
            for (int c = 0; c < 4; ++c) s[c] += v[c];
          }
        }
      }
      const uint32_t h = normalise(warp_sum_transposed(s, lane), p.span_mul_x, out_mask);
      if (r >= sy.mid && r < sy.mid_end) acc += h;
      if (r == sy.first) acc += weigh(h, sy.w_first, mask);
      if (r == sy.last) acc += weigh(h, sy.w_last, mask);
    }
    if ((lane & 7) == 0) s_acc[warp][ch] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t t = 0;
        for (int w = 0; w < n_warps; ++w) t += s_acc[w][c];
        o[c] = normalise(t, p.span_mul_y, out_mask);
      }
      pack_store<MODE>(o, p, luts, out + n * p.nb_out);
    }
    __syncthreads();
  }
}

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                         const int32_t*, const DeepParams&, unsigned, unsigned,
                         cudaStream_t);

template <int MODE, bool PACKED>
void launch(const uint8_t* in, uint8_t* out, const int32_t* luts, const int32_t* tab_x,
            const int32_t* tab_y, const DeepParams& p, unsigned blocks, unsigned threads,
            cudaStream_t s) {
  deep_kernel<MODE, PACKED><<<blocks, threads, 0, s>>>(in, out, luts, tab_x, tab_y, p);
}

template <int MODE>
Launcher pick(bool packed) {
  if (packed) return &launch<MODE, true>;
  return &launch<MODE, false>;
}

Launcher pick(int64_t mode, bool packed) {
  switch (mode) {
    case kP8Compressed: return pick<kP8Compressed>(packed);
    case kP8Linear: return pick<kP8Linear>(packed);
    case kP16Compressed: return pick<kP16Compressed>(packed);
    case kP16Linear: return pick<kP16Linear>(packed);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8, `out`
// is (batch, n_rows, w_out, nb_out) uint8, `luts` the int32 tables of
// ops/pixels.lut_table, `tab_x` and `tab_y` the axes' box tables.  The
// kernel runs on `stream` and is not waited for.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown mode or warp count.
extern "C" int smolscale_deep_scale(const uint8_t* in, uint8_t* out, const int32_t* luts,
                                    const int32_t* tab_x, const int32_t* tab_y,
                                    const DeepParams* params, void* stream) {
  const DeepParams p = *params;
  const int64_t n_total = p.batch * p.n_rows * p.w_out;
  if (n_total <= 0) return static_cast<int>(cudaSuccess);
  if (p.warps < 1 || p.warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const bool packed = p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const Launcher fn = pick(p.mode, packed);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = n_total < 0x7fffffff ? n_total : 0x7fffffff;
  fn(in, out, luts, tab_x, tab_y, p, static_cast<unsigned>(blocks),
     static_cast<unsigned>(32 * p.warps), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
