// Every level of a thumbnail pyramid from one read of each image, for Hopper
// (sm_90a): S64 storage, internal PREMUL8, compressed gamma; 4-byte pixels in
// and out (unassociated alpha on at most one side) or 3-byte pixels in and
// out; every axis of every level a uniform bilinear ladder with f = 128.
//
// Replaces the Pallas TPU kernel smolscale_tpu/ops/pallas_pyramid.py `_built`
// (pallas_call at :445, body `kernel` :276) with the per-level
// `_unpremul_epilogue` it applies for unassociated output, fused into the
// store here, and the 24bpp planes feed of `pyramid_dispatch` (:489), whose
// place 3-byte pixels read directly take.  The TPU kernel's count matmuls
// (`_h_tables`, `_v_tables`, `_chunk_slices`) exist for the MXU; this kernel
// sums in integer registers.
//
// The arithmetic is backends/numpy_ref.py's for each level on its own
// (generic.c:1290-1361).  On a class axis sample i of every level is the
// floor average of input pixels 2i and 2i+1 (lerp with f = 128), and output
// j of a level with n halvings is (sum of samples [j*2^n, (j+1)*2^n)) >> n:
//
//   H: s(r, i) = floor((px(r, 2i) + px(r, 2i+1)) / 2) per channel, then
//      hb_n(r, j) = (sum_k s(r, j*2^n + k)) >> n, rounded per input row and
//      per level;
//   V: v(i, j) = floor((hb(2i, j) + hb(2i+1, j)) / 2) on that level's own
//      hb, then out(J, j) = (sum_k v(J*2^m + k, j)) >> m.
//
// Partial sums before a shift are shared between levels (the sum over 2^(n+1)
// samples is the sum of two sums over 2^n); rounded values are not, since a
// level computed from a coarser level's bytes gives other bytes.
//
// Geometry: with NX, NY the largest halvings over the levels, a cell of
// 2^(NX+1) x 2^(NY+1) input pixels yields whole output pixels of every level
// (2^(NX-n) x 2^(NY-m) of the level with halvings (n, m)), so the input is
// an exact grid of cells and no cell needs its neighbours.  One thread per
// cell: it loads the cell's rows once, with 16-byte loads where the rows
// allow (neighbouring threads take neighbouring cells, so a warp reads one
// contiguous stretch of each row), keeps the pixels in registers, and
// writes every level's pixels of the cell, a run of up to four per output
// row, with one vector store for 4-byte pixels.  Pixels are held packed
// (channel k in byte k) and filtered four channels at a time: the floor
// average per byte is (a & b) + (((a ^ b) >> 1) & 0x7f7f7f7f), and sums run
// in two words of 16-bit lanes (even and odd bytes), which hold 255 * 4.
// No register array is indexed at run time: every loop has a constant trip
// count and is unrolled.
//
// What bounds it: device memory.  Each input byte is read once and each
// output byte written once; the work per input pixel is a few integer
// operations.  Unassociated input is premultiplied where it is loaded
// (unpack<kP8Compressed> of pixels.cuh, ((v+1)*(a+1)-1) >> 8); 24bpp input
// gets alpha 255.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixels.cuh"

constexpr int kMaxHalvings = 2;
constexpr int kSlots = (kMaxHalvings + 1) * (kMaxHalvings + 1);

// Launch parameters; the field order and layout match the ctypes Structure in
// ops/pyramid.py.  out[3*m + n] is the level with n halvings in x and m in y,
// or null.
struct PyramidParams {
  int64_t batch, cells_x, cells_y;  // input is cells_y * 2^(ny+1) rows
  int64_t nx, ny;                   // largest halvings over the levels
  int64_t nb;                       // bytes per pixel, in and out
  int64_t alpha_ch;                 // work channel holding alpha
  int64_t unassoc_in, unassoc_out;
  int64_t perm;                     // __byte_perm selector: output byte k <- channel src[k]
  uint8_t* out[kSlots];
};

namespace {

constexpr uint32_t kLanes = 0x00ff00ffu;

// per byte floor((a + b) / 2): numpy_ref's lerp with f = 128
__device__ __forceinline__ uint32_t avg_floor(uint32_t a, uint32_t b) {
  return (a & b) + (((a ^ b) >> 1) & 0x7f7f7f7fu);
}

// the even and the odd bytes of a packed pixel, as 16-bit lanes
struct Lanes {
  uint32_t e, o;
};

__device__ __forceinline__ Lanes split(uint32_t v) { return {v & kLanes, (v >> 8) & kLanes}; }

__device__ __forceinline__ Lanes add(Lanes a, Lanes b) { return {a.e + b.e, a.o + b.o}; }

// each lane >> n, back to bytes (lanes hold at most 255 << n, n <= 8)
__device__ __forceinline__ uint32_t shift_join(Lanes s, int n) {
  return ((s.e >> n) & kLanes) | (((s.o >> n) & kLanes) << 8);
}

// The CW pixels of one cell row, channel k in byte k (24bpp: alpha 255),
// loaded as V-byte words (V = 1: pixel by pixel).
template <int NB, int V, int CW>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ src, const Fmt& f,
                                         uint32_t (&px)[CW]) {
  static_assert(V == 1 || (CW * NB) % V == 0, "cell rows are whole words");
  if constexpr (V == 1) {
#pragma unroll
    for (int i = 0; i < CW; ++i) px[i] = load_pixel<false>(src, i, f);
  } else {
    constexpr int NW = CW * NB / 4;
    uint32_t w[NW];
    if constexpr (V == 16) {
#pragma unroll
      for (int k = 0; k < NW / 4; ++k) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + k);
        w[4 * k] = u.x;
        w[4 * k + 1] = u.y;
        w[4 * k + 2] = u.z;
        w[4 * k + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = __ldg(reinterpret_cast<const uint32_t*>(src) + k);
    }
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      if constexpr (NB == 4) {
        px[i] = w[i];
      } else {
        // bytes 3i .. 3i+2 lie in words q and q+1
        const int q = 3 * i / 4, sh = 3 * i % 4;
        const uint32_t hi = q + 1 < NW ? w[q + 1] : 0u;
        px[i] = (__byte_perm(w[q], hi, sh | (sh + 1) << 4 | (sh + 2) << 8) & 0xffffffu) |
                0xff000000u;
      }
    }
  }
}

__device__ __forceinline__ uint32_t premultiply(uint32_t px, const Fmt& f) {
  uint32_t v[4];
  unpack<kP8Compressed>(px, f, nullptr, v);
  return v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
}

// The output bytes of a premultiplied pixel: unassociated output is
// unpremultiplied (unpremul_p8_to_u, generic.c:227-236, as
// pack_store<kP8Compressed> does byte by byte), then byte k takes channel
// src[k].
__device__ __forceinline__ uint32_t finish(uint32_t v, const PyramidParams& p,
                                           const int32_t* __restrict__ inv_div_p8) {
  if (p.unassoc_out) {
    const int a_sh = 8 * static_cast<int>(p.alpha_ch);
    const uint32_t a = (v >> a_sh) & 0xff;
    const uint32_t inv = static_cast<uint32_t>(__ldg(inv_div_p8 + a));  // 255 * inv < 2^29
    uint32_t r = a << a_sh;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (8 * c != a_sh) r |= ((((v >> (8 * c)) & 0xff) * inv >> 13) & 0xff) << (8 * c);
    v = r;
  }
  return __byte_perm(v, 0, static_cast<unsigned>(p.perm));
}

// A run of R <= 4 output pixels of one row; `dst` is aligned to R pixels.
template <int NB>
__device__ __forceinline__ void store_run(uint8_t* dst, const uint32_t (&o)[4], int R) {
  if (NB == 4) {
    if (R == 4)
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    else if (R == 2)
      *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
    else
      *reinterpret_cast<uint32_t*>(dst) = o[0];
  } else if (R == 4) {
    // 12 bytes at a multiple of 12: three words
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = __byte_perm(o[0], o[1], 0x4210);
    d[1] = __byte_perm(o[1], o[2], 0x5421);
    d[2] = __byte_perm(o[2], o[3], 0x6542);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i < R) {
        dst[3 * i] = static_cast<uint8_t>(o[i]);
        dst[3 * i + 1] = static_cast<uint8_t>(o[i] >> 8);
        dst[3 * i + 2] = static_cast<uint8_t>(o[i] >> 16);
      }
    }
  }
}

template <int NX, int NY, int NB, int V>
__global__ void __launch_bounds__(256)
pyramid_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ inv_div_p8,
               const PyramidParams p) {
  constexpr int CW = 2 << NX, CH = 2 << NY, NS = 1 << NX;
  const Fmt f{NB, p.alpha_ch == 0, p.unassoc_in != 0};
  const int64_t w_in = p.cells_x * CW, h_in = p.cells_y * CH;
  const int64_t n_cells = p.batch * p.cells_y * p.cells_x;
  for (int64_t n = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; n < n_cells;
       n += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t cx = n % p.cells_x;
    const int64_t cy = (n / p.cells_x) % p.cells_y;
    const int64_t b = n / (p.cells_x * p.cells_y);
    const uint8_t* src = in + ((b * h_in + cy * CH) * w_in + cx * CW) * NB;

    uint32_t px[CH][CW];
#pragma unroll
    for (int r = 0; r < CH; ++r) load_row<NB, V, CW>(src + r * w_in * NB, f, px[r]);
    if (f.unassoc) {
#pragma unroll
      for (int r = 0; r < CH; ++r)
#pragma unroll
        for (int i = 0; i < CW; ++i) px[r][i] = premultiply(px[r][i], f);
    }

    Lanes acc[NX + 1][NY + 1][NS];  // V sums of level (n, m), outputs j < NS >> n
#pragma unroll
    for (int q = 0; q < (1 << NY); ++q) {  // V sample q: rows 2q, 2q+1 of the cell
      uint32_t hb[2][NX + 1][NS];          // H value of rows 2q+t, level n, output j
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        Lanes s[NX + 1][NS];               // sums over 2^n samples, before the shift
#pragma unroll
        for (int i = 0; i < NS; ++i)
          s[0][i] = split(avg_floor(px[2 * q + t][2 * i], px[2 * q + t][2 * i + 1]));
#pragma unroll
        for (int h = 1; h <= NX; ++h)
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (j < (NS >> h)) s[h][j] = add(s[h - 1][2 * j], s[h - 1][2 * j + 1]);
#pragma unroll
        for (int h = 0; h <= NX; ++h)
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (j < (NS >> h)) hb[t][h][j] = shift_join(s[h][j], h);
      }
#pragma unroll
      for (int h = 0; h <= NX; ++h) {
        const int R = NS >> h;  // this level's output pixels per cell row
#pragma unroll
        for (int m = 0; m <= NY; ++m) {
          uint8_t* const out = p.out[(kMaxHalvings + 1) * m + h];
          if (out == nullptr) continue;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            if (j >= R) continue;
            const Lanes v = split(avg_floor(hb[0][h][j], hb[1][h][j]));
            acc[h][m][j] = (q & ((1 << m) - 1)) == 0 ? v : add(acc[h][m][j], v);
          }
          if (((q + 1) & ((1 << m) - 1)) != 0) continue;
          uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (j < R) o[j] = finish(shift_join(acc[h][m][j], m), p, inv_div_p8);
          const int64_t w_l = p.cells_x * R, h_l = p.cells_y << (NY - m);
          const int64_t row = (cy << (NY - m)) + (q >> m);
          store_run<NB>(out + ((b * h_l + row) * w_l + cx * R) * NB, o, R);
        }
      }
    }
  }
}

typedef void (*Launcher)(const uint8_t*, const int32_t*, const PyramidParams&, unsigned,
                         cudaStream_t);

template <int NX, int NY, int NB, int V>
void launch(const uint8_t* in, const int32_t* inv_div_p8, const PyramidParams& p,
            unsigned blocks, cudaStream_t s) {
  pyramid_kernel<NX, NY, NB, V><<<blocks, 256, 0, s>>>(in, inv_div_p8, p);
}

// the widest load that every cell row allows: `vec` divides the row bytes
// and the input's address
template <int NX, int NY, int NB>
Launcher pick(int vec) {
  constexpr int row = (2 << NX) * NB;
  if constexpr (row % 16 == 0) {
    if (vec == 16) return &launch<NX, NY, NB, 16>;
  }
  if constexpr (row % 4 == 0) {
    if (vec >= 4) return &launch<NX, NY, NB, 4>;
  }
  return &launch<NX, NY, NB, 1>;
}

template <int NX, int NY>
Launcher pick(int64_t nb, int vec) {
  if (nb == 3) return pick<NX, NY, 3>(vec);
  if (nb == 4) return pick<NX, NY, 4>(vec);
  return nullptr;
}

template <int NX>
Launcher pick(int64_t ny, int64_t nb, int vec) {
  switch (ny) {
    case 0: return pick<NX, 0>(nb, vec);
    case 1: return pick<NX, 1>(nb, vec);
    case 2: return pick<NX, 2>(nb, vec);
  }
  return nullptr;
}

Launcher pick(int64_t nx, int64_t ny, int64_t nb, int vec) {
  switch (nx) {
    case 0: return pick<0>(ny, nb, vec);
    case 1: return pick<1>(ny, nb, vec);
    case 2: return pick<2>(ny, nb, vec);
  }
  return nullptr;
}

}  // namespace

// C entry point for ctypes.  `in` is (batch, cells_y * 2^(ny+1), cells_x *
// 2^(nx+1), nb) uint8; each non-null `out` slot is a (batch, h, w, nb) uint8
// level allocated by the caller (aligned to 16 bytes), `inv_div_p8` holds 256
// int32 (read only for unassociated output).  One launch computes every
// level of every image; it runs on `stream` and is not waited for.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// halvings or a pixel size outside the kernel's instances.
extern "C" int smolscale_pyramid_scale(const uint8_t* in, const int32_t* inv_div_p8,
                                       const PyramidParams* params, void* stream) {
  const PyramidParams p = *params;
  const int64_t n_cells = p.batch * p.cells_y * p.cells_x;
  if (n_cells <= 0) return static_cast<int>(cudaSuccess);
  // every cell row starts at a multiple of its own size from `in`
  const int64_t row = (int64_t{2} << p.nx) * p.nb;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(in);
  const int vec = row % 16 == 0 && addr % 16 == 0 ? 16 : row % 4 == 0 && addr % 4 == 0 ? 4 : 1;
  const Launcher fn = pick(p.nx, p.ny, p.nb, vec);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n_cells + 255) / 256;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  fn(in, inv_div_p8, p, static_cast<unsigned>(blocks), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
