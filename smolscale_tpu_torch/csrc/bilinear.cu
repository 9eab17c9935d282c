// The general 64bpp PREMUL8 scale for Hopper (sm_90a): per axis a bilinear
// 0h-6h halving ladder, a box with fractional edge weights, COPY or ONE;
// 3- or 4-byte pixels in and out.
//
// Replaces the Pallas TPU kernel smolscale_tpu/ops/pallas_bilinear.py
// `_make_kernel` at its three pallas_call sites: `_built` (:1732, the whole
// image), `_built_rows` (:1834, output row groups for the row API) and
// `_built_planes` (:1939, 24bpp input through u8 planes), together with the
// unpremultiply epilogue they apply for unassociated output, which is fused
// into the store here.  The TPU kernel's lerp and span matrices, row-group
// windows and u32 pixel view exist for the MXU and Mosaic; this kernel
// computes what backends/numpy_ref.py specifies for the class directly, one
// thread per output pixel (i, j):
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
// loaded: 24bpp input gets a constant alpha of 255 (this replaces the TPU's
// planes feed), unassociated input is premultiplied, ((v+1)*(a+1)-1) >> 8.
// `row0` is the first output row computed: the row API needs no sliced
// tables.
//
// What bounds it: loads.  Each thread loads every input pixel its output
// depends on, so pixels shared by neighbouring outputs (overlapping bilinear
// pairs, box edges, upscales) are loaded a few times per input byte, and the
// h values of a tap row are recomputed for every V tap and output row that
// uses them.  Neighbouring threads take neighbouring output columns, so a
// warp's loads of one tap row fall into one contiguous stretch that L1
// serves across the sample loop.  A later version could stage a block's
// h rows in shared memory, so each is computed once per block, and keep more
// loads in flight per thread.
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
  int64_t nb_in, nb_out;
  int64_t alpha_ch;                // work channel holding alpha (3 for 24bpp input)
  int64_t unassoc_in, unassoc_out;
  int64_t src[4];                  // output byte k <- work channel src[k]
};

enum AxisKind { kCopy = 0, kOne = 1, kBilinear = 2, kBox = 3 };

namespace {

// One axis's filter: its table (ops/bilinear.axis_table) and constants.
struct Axis {
  const int32_t* tab;
  int64_t len;
  int halvings;
  int64_t span_mul;
};

struct Unpack {
  int nb;
  int a_ch;
  bool unassoc;
};

template <bool PACKED>
__device__ __forceinline__ void load_pixel(const uint8_t* __restrict__ p,
                                           const Unpack& u, int v[4]) {
  if (PACKED) {
    const uint32_t px = __ldg(reinterpret_cast<const uint32_t*>(p));
    v[0] = px & 0xff;
    v[1] = (px >> 8) & 0xff;
    v[2] = (px >> 16) & 0xff;
    v[3] = px >> 24;
  } else {
    v[0] = __ldg(p);
    v[1] = __ldg(p + 1);
    v[2] = __ldg(p + 2);
    v[3] = u.nb == 4 ? __ldg(p + 3) : 255;
  }
  if (u.unassoc) {
    // premul_u_to_p8 (generic.c:238-244)
    const int a1 = v[u.a_ch] + 1;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c != u.a_ch) v[c] = (((v[c] + 1) * a1 - 1) >> 8) & 0xff;
  }
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
__device__ __forceinline__ void filter(const Fetch& fetch, const Axis& ax,
                                       int64_t j, int out[4]) {
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
__global__ void __launch_bounds__(256)
bilinear_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                const int32_t* __restrict__ inv_div_p8,
                const int32_t* __restrict__ tab_x,
                const int32_t* __restrict__ tab_y, const BilinearParams p) {
  const Unpack u{static_cast<int>(p.nb_in), static_cast<int>(p.alpha_ch),
                 p.unassoc_in != 0};
  const Axis ax{tab_x, p.len_x, static_cast<int>(p.halvings_x), p.span_mul_x};
  const Axis ay{tab_y, p.len_y, static_cast<int>(p.halvings_y), p.span_mul_y};
  const int64_t row_bytes = p.w_in * p.nb_in;
  const int64_t n_total = p.batch * p.n_rows * p.w_out;
  const int a_ch = u.a_ch;
  for (int64_t n = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       n < n_total; n += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t j = n % p.w_out;
    const int64_t i = p.row0 + (n / p.w_out) % p.n_rows;
    const int64_t b = n / (p.w_out * p.n_rows);
    const HValues<KX, PACKED> h{in + b * p.h_in * row_bytes, row_bytes, u, ax, j};
    int o[4];
    filter<KY>(h, ay, i, o);
    if (p.unassoc_out) {
      // unpremul_p8_to_u (generic.c:227-236), INVERTED_DIV_SHIFT_P8 = 13
      const int64_t inv = __ldg(inv_div_p8 + o[a_ch]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c != a_ch) o[c] = static_cast<int>((o[c] * inv) >> 13) & 0xff;
    }
    uint8_t* dst = out + n * p.nb_out;
    if (p.nb_out == 4) {
      *reinterpret_cast<uint32_t*>(dst) =
          static_cast<uint32_t>(o[p.src[0]]) |
          (static_cast<uint32_t>(o[p.src[1]]) << 8) |
          (static_cast<uint32_t>(o[p.src[2]]) << 16) |
          (static_cast<uint32_t>(o[p.src[3]]) << 24);
    } else {
      dst[0] = static_cast<uint8_t>(o[p.src[0]]);
      dst[1] = static_cast<uint8_t>(o[p.src[1]]);
      dst[2] = static_cast<uint8_t>(o[p.src[2]]);
    }
  }
}

typedef void (*Launcher)(const uint8_t*, uint8_t*, const int32_t*,
                         const int32_t*, const int32_t*, const BilinearParams&,
                         unsigned, cudaStream_t);

template <int KX, int KY, bool PACKED>
void launch(const uint8_t* in, uint8_t* out, const int32_t* inv_div_p8,
            const int32_t* tab_x, const int32_t* tab_y,
            const BilinearParams& p, unsigned blocks, cudaStream_t s) {
  bilinear_kernel<KX, KY, PACKED><<<blocks, 256, 0, s>>>(
      in, out, inv_div_p8, tab_x, tab_y, p);
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

Launcher pick(int64_t kx, int64_t ky, bool packed) {
  switch (kx) {
    case kCopy: return pick<kCopy>(ky, packed);
    case kOne: return pick<kOne>(ky, packed);
    case kBilinear: return pick<kBilinear>(ky, packed);
    case kBox: return pick<kBox>(ky, packed);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, h_in, w_in, nb_in) uint8,
// `out` is (batch, n_rows, w_out, nb_out) uint8 and 4-byte aligned,
// `inv_div_p8` holds 256 int32 (read only for unassociated output), `tab_x`
// and `tab_y` the axes' tables (unused for COPY and ONE).  The kernel runs
// on `stream` and is not waited for.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an unknown axis kind.
extern "C" int smolscale_bilinear_scale(const uint8_t* in, uint8_t* out,
                                        const int32_t* inv_div_p8,
                                        const int32_t* tab_x,
                                        const int32_t* tab_y,
                                        const BilinearParams* params,
                                        void* stream) {
  const BilinearParams p = *params;
  const int64_t n_total = p.batch * p.n_rows * p.w_out;
  if (n_total <= 0) return static_cast<int>(cudaSuccess);
  const bool packed =
      p.nb_in == 4 && (reinterpret_cast<uintptr_t>(in) & 3) == 0;
  const Launcher fn = pick(p.kind_x, p.kind_y, packed);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n_total + 255) / 256;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  fn(in, out, inv_div_p8, tab_x, tab_y, p, static_cast<unsigned>(blocks),
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
