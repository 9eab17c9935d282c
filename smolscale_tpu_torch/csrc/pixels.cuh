// Pixel unpack and pack for every (internal alpha, gamma) pair, shared by the
// kernels that run at the plan's own alpha and gamma (deep.cu,
// bilinear128.cu): the device form of ops/pixels.py `unpack` and `pack`, as
// backends/numpy_ref.py specifies them.
//
// Bounds: unpacked values are at most 255 (PREMUL8), 2047 (PREMUL8 linear),
// 65408 (PREMUL16, alpha (255 << 8) | 0x80) and 2047*255 = 521985 (PREMUL16
// linear), all below 2^24; the pack multiplies them by an inv_div entry in
// 64 bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// (internal alpha, gamma), as ops/deep.py
enum Mode { kP8Compressed = 0, kP8Linear = 1, kP16Compressed = 2, kP16Linear = 3 };

namespace {

// offsets into the LUT block, ops/pixels.LUT_NAMES in order
constexpr int kFromSrgb = 0, kToSrgb = 256, kInvDivP8 = 2304, kInvDivP8L = 2560,
              kInvDivP16 = 2816, kInvDivP16L = 3072;

__device__ __forceinline__ uint32_t weigh(uint32_t v, uint32_t w, uint32_t mask) {
  return ((v * w) >> 8) & mask;  // v <= 521985, w <= 256: < 2^27
}

__device__ __forceinline__ uint32_t normalise(uint32_t acc, int64_t span_mul,
                                              uint32_t out_mask) {
  return static_cast<uint32_t>(
             (static_cast<uint64_t>(acc) * static_cast<uint64_t>(span_mul) +
              (uint64_t{1} << 23)) >> 24) & out_mask;
}

struct Fmt {
  int nb;
  bool alpha_first;  // alpha in work channel 0, else 3
  bool unassoc;
};

// Pixel x of a row as four bytes, byte k in bits 8k; 24bpp gets alpha 255.
// The offset x * nb is computed in the caller's index type: 32 bits hold it
// (a row is at most 65535 pixels), but deep.cu's unrolled span loop keeps
// 64-bit indices, whose addresses the compiler steps without a conversion.
template <bool PACKED, class Index>
__device__ __forceinline__ uint32_t load_pixel(const uint8_t* __restrict__ row,
                                               Index x, const Fmt& f) {
  if (PACKED) return __ldg(reinterpret_cast<const uint32_t*>(row) + x);
  const uint8_t* p = row + x * f.nb;
  return static_cast<uint32_t>(__ldg(p)) | (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
         (static_cast<uint32_t>(f.nb == 4 ? __ldg(p + 3) : 255) << 24);
}

// The work channels of a pixel at the plan's (alpha, gamma): numpy_ref.unpack.
// `lut` is the shared copy of FROM_SRGB (256) then INV_DIV_P8 (256).
template <int MODE>
__device__ __forceinline__ void unpack(uint32_t px, const Fmt& f,
                                       const int32_t* lut, uint32_t v[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = (px >> (8 * c)) & 0xff;
  const uint32_t a = f.alpha_first ? v[0] : v[3];
  const int a_ch = f.alpha_first ? 0 : 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c == a_ch) {
      if (MODE == kP16Compressed || MODE == kP16Linear) v[c] = (a << 8) | 0x80;
      continue;
    }
    if (MODE == kP8Compressed) {
      // premul_u_to_p8 (generic.c:238-244)
      if (f.unassoc) v[c] = (((v[c] + 1) * (a + 1) - 1) >> 8) & 0xff;
    } else if (MODE == kP8Linear) {
      uint32_t u = v[c];
      // unpremul_p8 (generic.c:227-236): 255 * 1581055 < 2^29
      if (!f.unassoc) u = ((u * static_cast<uint32_t>(lut[256 + a])) >> 13) & 0xff;
      const uint32_t l = static_cast<uint32_t>(lut[u]);
      // premul_ul_to_p8l (generic.c:261-269)
      v[c] = (((l + 1) * ((a << 3) + 1) - 1) >> 11) & 0x7ff;
    } else if (MODE == kP16Compressed) {
      v[c] = v[c] * a;  // generic.c:616-634
    } else {
      v[c] = static_cast<uint32_t>(lut[v[c]]) * a;  // generic.c:636-660
    }
  }
}

// The work channels of a 3-byte pixel at internal PREMUL8 (MODE
// kP8Compressed or kP8Linear; alpha in work channel 3): alpha is the constant
// 255, so each colour byte's unpack is a fixed function of the byte, one
// entry of `fold` (ops/pixels.unpack24_table) in linear light and the byte
// itself at compressed gamma.  Three byte loads, and no load for alpha.
template <int MODE>
__device__ __forceinline__ void unpack24(const uint8_t* __restrict__ p, const int32_t* fold,
                                         uint32_t v[4]) {
  static_assert(MODE == kP8Compressed || MODE == kP8Linear, "3-byte pixels are PREMUL8");
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t b = __ldg(p + c);
    v[c] = MODE == kP8Linear ? static_cast<uint32_t>(fold[b]) : b;
  }
  v[3] = 255;
}

// Pixels o and o + 1 of a 3-byte row at `p` (pixel o's first byte), as
// unpack24 gives them, from the aligned words that hold their six bytes: two
// words, or three where the pair starts at a word's last byte.  Each word
// loaded holds a byte of the pair, so it lies in the same mapped page as
// that byte; the bytes outside the pair are dropped.
template <int MODE>
__device__ __forceinline__ void unpack24_pair(const uint8_t* __restrict__ p,
                                              const int32_t* fold, uint32_t a[4],
                                              uint32_t b[4]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{3});
  const unsigned sh = static_cast<unsigned>(addr & 3) * 8;
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = sh == 24 ? __ldg(w + 2) : 0;
  const uint32_t lo = __funnelshift_r(w0, w1, sh);  // the pair's bytes 0-3
  const uint32_t hi = __funnelshift_r(w1, w2, sh);  // its bytes 4-5 in bits 0-15
  const uint32_t bytes[6] = {lo & 0xff, (lo >> 8) & 0xff, (lo >> 16) & 0xff, lo >> 24,
                             hi & 0xff, (hi >> 8) & 0xff};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = MODE == kP8Linear ? static_cast<uint32_t>(fold[bytes[c]]) : bytes[c];
    b[c] = MODE == kP8Linear ? static_cast<uint32_t>(fold[bytes[3 + c]]) : bytes[3 + c];
  }
  a[3] = b[3] = 255;
}

// Copies the 256 entries of unpack24's `fold` into the block's shared
// `s_fold`.
__device__ __forceinline__ void load_unpack24_lut(const int32_t* __restrict__ fold,
                                                  int32_t* s_fold) {
  for (int k = threadIdx.x; k < 256; k += blockDim.x) s_fold[k] = __ldg(fold + k);
  __syncthreads();
}

// Copies FROM_SRGB then INV_DIV_P8 from the LUT block into the block's
// shared `s_lut` (512 entries), for unpack<MODE> in linear light.
__device__ __forceinline__ void load_unpack_luts(const int32_t* __restrict__ luts,
                                                 int32_t* s_lut) {
  for (int k = threadIdx.x; k < 512; k += blockDim.x)
    s_lut[k] = __ldg(luts + (k < 256 ? kFromSrgb + k : kInvDivP8 + k - 256));
  __syncthreads();
}

__device__ __forceinline__ uint32_t lut_at(const int32_t* __restrict__ luts, int off,
                                           uint32_t idx) {
  return static_cast<uint32_t>(__ldg(luts + off + idx));
}

// Channel c of four is alpha: a select, so that no register array is
// indexed at run time (nvcc puts such arrays in local memory).
__device__ __forceinline__ bool is_alpha(int c, bool alpha_first) {
  return alpha_first ? c == 0 : c == 3;
}

// The __byte_perm selector that puts work channel src[k] into output byte k.
template <class Params>
__device__ __forceinline__ unsigned out_perm(const Params& p) {
  return static_cast<unsigned>(p.src[0] | (p.src[1] << 4) | (p.src[2] << 8) |
                               (p.src[3] << 12));
}

// numpy_ref.pack for one output pixel of normalised work channels `o`: the
// output bytes in one word, byte k in bits 8k (byte 3 unused for 3-byte
// pixels), swizzled by `perm` (out_perm).  `Params` has the pixel-format
// fields of ops/pixels.kernel_fields and `pack24_direct`.  The
// unpremultiply's inv_div entry is read once per pixel.
template <int MODE, class Params>
__device__ __forceinline__ uint32_t pack_word(const uint32_t o[4], const Params& p,
                                              const int32_t* __restrict__ luts,
                                              unsigned perm) {
  constexpr bool k16 = MODE == kP16Compressed || MODE == kP16Linear;
  const bool alpha_first = p.alpha_ch == 0;
  const uint32_t a = ((alpha_first ? o[0] : o[3]) >> (k16 ? 8 : 0)) & 0xff;
  const bool out_premul = !p.unassoc_out;
  const bool direct = MODE == kP8Linear && out_premul && p.pack24_direct;
  uint64_t inv = 0;
  if (MODE == kP8Compressed && !out_premul) inv = lut_at(luts, kInvDivP8, a);
  if (MODE == kP8Linear && !direct) inv = lut_at(luts, kInvDivP8L, a);
  if (MODE == kP16Compressed) inv = lut_at(luts, kInvDivP16, a);
  if (MODE == kP16Linear) inv = lut_at(luts, kInvDivP16L, a);
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t r = a;
    if (!is_alpha(c, alpha_first)) {
      const uint64_t v = o[c];
      if (MODE == kP8Compressed) {
        // unpremul_p8 (generic.c:227-236)
        r = out_premul ? o[c] : static_cast<uint32_t>((v * inv) >> 13);
      } else if (MODE == kP8Linear) {
        if (direct) {
          // to_srgb of the premultiplied linear value (generic.c:922-935)
          r = lut_at(luts, kToSrgb, o[c] & 0x7ff);
        } else {
          // unpremul_p8l (generic.c:271-280), to_srgb
          r = lut_at(luts, kToSrgb, static_cast<uint32_t>((v * inv) >> 10) & 0x7ff);
          if (out_premul && p.nb_out == 4) r = (((r + 1) * (a + 1) - 1) >> 8) & 0xff;
        }
      } else if (MODE == kP16Compressed) {
        // unpremul_p16 (generic.c:290-299)
        r = static_cast<uint32_t>((v * inv) >> 16);
      } else {
        // unpremul_p16l (generic.c:309-318), to_srgb
        r = lut_at(luts, kToSrgb, static_cast<uint32_t>((v * inv) >> 19) & 0x7ff);
      }
    }
    w |= (r & 0xff) << (8 * c);
  }
  return __byte_perm(w, 0, perm);
}

// Stores an output pixel packed by pack_word: one 32-bit store for 4-byte
// pixels (pixel n of an output from torch.empty lies at byte 4n, aligned),
// three byte stores for 3-byte pixels.
__device__ __forceinline__ void store_pixel(uint32_t w, int nb_out, uint8_t* dst) {
  if (nb_out == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
    dst[0] = static_cast<uint8_t>(w);
    dst[1] = static_cast<uint8_t>(w >> 8);
    dst[2] = static_cast<uint8_t>(w >> 16);
  }
}

// numpy_ref.pack for one output pixel, stored at `dst`.
template <int MODE, class Params>
__device__ __forceinline__ void pack_store(const uint32_t o[4], const Params& p,
                                           const int32_t* __restrict__ luts,
                                           uint8_t* dst) {
  store_pixel(pack_word<MODE>(o, p, luts, out_perm(p)), static_cast<int>(p.nb_out), dst);
}

}  // namespace
