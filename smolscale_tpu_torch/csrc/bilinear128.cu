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
// What bounds it.  Not arithmetic per output pixel any more: the design
// spends none that the filter does not need --
//   - no division: a block of 256 threads covers a tile of 32 output
//     columns by 8 rows (tile_w = 1-16 columns by 256-16 rows where w_out is
//     narrower, so no thread idles on a 1-7 or 64 pixel wide output); block
//     (x, y, z) takes column tile x, row groups y, y + grid_y, ... of images
//     z, z + grid_z, ....  The host (ops/bilinear128.launch_shape) cuts
//     grid_y to about 16 blocks per SM, so each block copies the LUTs once
//     for several row groups, and keeps grid_y and grid_z below 2^16;
//   - 32-bit indices: columns, rows, table entries and offsets within a row;
//     only an image's and a row's base offset are 64-bit;
//   - no register array indexed at run time (nvcc would put it in local
//     memory): pixels.cuh's pack picks alpha with a select and swizzles the
//     output bytes with one __byte_perm; a 4-byte pixel is one word store;
//   - each X table word is loaded once per output pixel: a box column's six
//     words once per thread, and a V sample's two rows (r, r + 1) -- a V
//     box's edge rows, and its mid rows two by two -- go through one pass
//     of the H samples, which also keeps two rows' loads in flight;
//   - COPY x COPY, which has one load per output, takes two row groups per
//     turn with both loads first.
// Neighbouring threads take neighbouring output columns, so a warp's loads
// of one tap row fall into one contiguous stretch that L1 serves, and its
// stores into one 128-byte line.  What is left (PERF.md §6): the latency
// of each bilinear sample's table load before its pixel loads (rows 6, 7);
// linear light's table lookups, TO_SRGB gathered from global memory in the
// pack and FROM_SRGB from bank-conflicted shared memory in the unpack
// (a1-srgb-field); and on 3-byte pixels three byte loads and about 2.8
// unpacks per input pixel where bilinear pairs overlap (row 6b).
// Left out, measured: tiles up to 256 columns wide, a bilinear axis's
// samples held in registers with all loads of a sample pair issued first,
// and the pack's tables in shared memory made rows 6 and 7 faster but the
// COPY rows and row 6b slower.  Not built: staging a block's input rows in
// shared memory with 16-byte loads, unpacked once (PR 9 found one staged
// stretch per block slower than direct loads on ladders), and a split of
// one box span over several threads (a box axis of thousands to one beside
// a bilinear axis walks its span in one thread).
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
};

namespace {

// axis kinds, ops/bilinear.COPY, ONE, BILINEAR and BOX; kCopy is also the
// template kind of ONE (stride 0)
constexpr int kCopy = 0, kOne = 1, kBilinear = 2, kBox = 3;
constexpr uint32_t kWorkMask = 0xffffff, kNormMask = 0xffff;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t lerp(uint32_t p, uint32_t q, int32_t f) {
  // numpy_ref._lerp: (p - q)*f is negative when p < q; >> floors it
  const int32_t d = static_cast<int32_t>(p) - static_cast<int32_t>(q);
  return static_cast<uint32_t>(((d * f) >> 8) + static_cast<int32_t>(q)) & kWorkMask;
}

// The H filter of one output column j, with its X table words loaded once:
// the H-filtered values of N input rows (1 or 2) in one pass, so that the
// rows share those loads and their pixel loads are in flight together.
template <int KX, int MODE, bool PACKED>
struct Columns {
  Fmt f;
  const int32_t* lut;
  const int32_t* tab;  // kBilinear: column j's first table entry, j << n
  int len, n;          // kBilinear: table row length, halvings
  int x;               // kCopy: column j * stride (1 for COPY, 0 for ONE)
  int first, w_first, mid, n_mid, last, w_last;  // kBox: column j's table entries
  int64_t span_mul;

  __device__ __forceinline__ Columns(const Fmt& fmt, const int32_t* s_lut,
                                     const int32_t* __restrict__ tab_x,
                                     const Bilinear128Params& p, int j)
      : f(fmt), lut(s_lut), tab(tab_x), len(static_cast<int>(p.len_x)),
        n(static_cast<int>(p.halvings_x)), x(p.kind_x == kCopy ? j : 0), first(0),
        w_first(0), mid(0), n_mid(0), last(0), w_last(0), span_mul(p.span_mul_x) {
    if (KX == kBilinear) tab = tab_x + (j << n);
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
    unpack<MODE>(load_pixel<PACKED>(row, i, f), f, lut, v);
  }

  template <int N>
  __device__ __forceinline__ void operator()(const uint8_t* const (&rows)[N],
                                             uint32_t (&v)[N][4]) const {
    if constexpr (KX == kCopy) {
#pragma unroll
      for (int m = 0; m < N; ++m) pixel(rows[m], x, v[m]);
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

// Output row i of a V axis of kind KY over the H values of `h` on the rows
// of `img`: each V sample's pair of rows (r, r + 1) and a box's edge rows
// and mid rows two by two go through one pass of h.
template <int KY, class H>
__device__ __forceinline__ void vfilter(const H& h, const uint8_t* img, int row_bytes,
                                        const int32_t* __restrict__ tab,
                                        const Bilinear128Params& p, int i, uint32_t o[4]) {
  const auto row = [&](int r) { return img + static_cast<int64_t>(r) * row_bytes; };
  if constexpr (KY == kCopy) {
    const uint8_t* rows[1] = {row(p.kind_y == kCopy ? i : 0)};
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
      const uint8_t* rows[2] = {row(r), row(r + 1)};
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
      const uint8_t* rows[2] = {row(__ldg(t)), row(__ldg(t + 4 * len))};
      h(rows, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[c] = weigh(v[0][c], w_first, kWorkMask) + weigh(v[1][c], w_last, kWorkMask);
    }
    int r = mid;
    for (; r + 1 < mid_end; r += 2) {
      const uint8_t* rows[2] = {row(r), row(r + 1)};
      h(rows, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[0][c] + v[1][c];
    }
    if (r < mid_end) {
      const uint8_t* rows[1] = {row(r)};
      uint32_t v1[1][4];
      h(rows, v1);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v1[0][c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = normalise(acc[c], p.span_mul_y, kNormMask);
  }
}

// A block of kThreads threads covers a tile of tile_w consecutive output
// columns (thread t: column t % tile_w) by kThreads / tile_w consecutive
// output rows (row t / tile_w); block (x, y, z) takes column tile x, row
// groups y, y + grid_y, ... of images z, z + grid_z, ....  No division.
// COPY x COPY takes two row groups per turn, both loads first.
template <int KX, int KY, int MODE, bool PACKED>
__global__ void __launch_bounds__(kThreads)
bilinear128_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const int32_t* __restrict__ luts, const int32_t* __restrict__ tab_x,
                   const int32_t* __restrict__ tab_y, const Bilinear128Params p) {
  constexpr bool kLinear = MODE == kP8Linear || MODE == kP16Linear;
  constexpr int kTurn = KX == kCopy && KY == kCopy ? 2 : 1;
  __shared__ int32_t s_lut[kLinear ? 512 : 1];
  if (kLinear) load_unpack_luts(luts, s_lut);
  const int tile_w = static_cast<int>(p.tile_w), shift = __ffs(tile_w) - 1;
  const int j = static_cast<int>(blockIdx.x) * tile_w + (threadIdx.x & (tile_w - 1));
  const int w_out = static_cast<int>(p.w_out), n_rows = static_cast<int>(p.n_rows);
  if (j >= w_out) return;
  const Fmt f{static_cast<int>(p.nb_in), p.alpha_ch == 0, p.unassoc_in != 0};
  const Columns<KX, MODE, PACKED> h(f, s_lut, tab_x, p, j);
  const unsigned perm = out_perm(p);
  const int nb_out = static_cast<int>(p.nb_out);
  const int row_bytes = static_cast<int>(p.w_in * p.nb_in), out_row = w_out * nb_out;
  const int tile_h = kThreads >> shift, step = static_cast<int>(gridDim.y) * tile_h;
  for (int64_t b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const uint8_t* img = in + b * p.h_in * row_bytes;
    uint8_t* dst = out + b * n_rows * out_row + j * nb_out;
    for (int ir = static_cast<int>(blockIdx.y) * tile_h + (threadIdx.x >> shift);
         ir < n_rows; ir += kTurn * step) {
      uint32_t o[kTurn][4];
#pragma unroll
      for (int u = 0; u < kTurn; ++u)
        vfilter<KY>(h, img, row_bytes, tab_y, p, static_cast<int>(p.row0) +
                    min(ir + u * step, n_rows - 1), o[u]);
#pragma unroll
      for (int u = 0; u < kTurn; ++u)
        if (ir + u * step < n_rows)
          store_pixel(pack_word<MODE>(o[u], p, luts, perm), nb_out,
                      dst + static_cast<int64_t>(ir + u * step) * out_row);
    }
  }
}

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*, const int32_t*,
                         const int32_t*, const Bilinear128Params&, dim3, cudaStream_t);

template <int KX, int KY, int MODE, bool PACKED>
void launch(const uint8_t* in, uint8_t* out, const int32_t* luts, const int32_t* tab_x,
            const int32_t* tab_y, const Bilinear128Params& p, dim3 grid, cudaStream_t s) {
  bilinear128_kernel<KX, KY, MODE, PACKED><<<grid, kThreads, 0, s>>>(
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
// is (batch, n_rows, w_out, nb_out) uint8 and 4-byte aligned, `luts` the
// int32 tables of ops/pixels.lut_table, `tab_x` and `tab_y` the axes'
// tables; the grid is (ceil(w_out / tile_w), grid_y, grid_z)
// (ops/bilinear128.launch_shape).  The kernel runs on `stream` and is not
// waited for.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an axis kind or mode outside the class, or a
// tile width or grid outside the limits.
extern "C" int smolscale_bilinear128_scale(const uint8_t* in, uint8_t* out,
                                           const int32_t* luts, const int32_t* tab_x,
                                           const int32_t* tab_y,
                                           const Bilinear128Params* params, void* stream) {
  const Bilinear128Params p = *params;
  if (p.batch * p.n_rows * p.w_out <= 0) return static_cast<int>(cudaSuccess);
  if (p.tile_w < 1 || p.tile_w > kThreads || (p.tile_w & (p.tile_w - 1)) != 0 ||
      p.grid_y < 1 || p.grid_y > 65535 || p.grid_z < 1 || p.grid_z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool packed = p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const Launcher fn = pick(p.kind_x, p.kind_y, p.mode, packed);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.w_out + p.tile_w - 1) / p.tile_w),
                  static_cast<unsigned>(p.grid_y), static_cast<unsigned>(p.grid_z));
  fn(in, out, luts, tab_x, tab_y, p, grid, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
