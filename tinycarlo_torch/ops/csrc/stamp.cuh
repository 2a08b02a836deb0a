// stamp.cuh -- what the port's kernels share: the frame geometry, the
// band-word decode, the fast stroke's bundle and `window_hit` stamp, and a
// copy's box. One copy, so the kernels cannot drift apart. masks.cu,
// rank.cu and exact.cu read the production bundles at 16-row bands,
// env_soa.cu and env_seg.cu the older env-merged and segment bundles at 8-
// or 16-row bands, one block per env (env_block.cuh); frame_soa.cu the
// per-frame bundle, one block per 128-lane tile of a frame (`Tile`,
// `stamp_tile`, `soa_tile` below).
//
// Bundles (ops/rasterize_kernels.py). Both compactions give counts (4+L, B)
// int32 rows [live, one-band, short, dropped, per-layer...], an idx (B, kp)
// int32 slot->copy map and per copy on the (B, LE) copy axis a band word
// bw = ((frame*n_bands + b0) << 9) | nb, with the stacked frame index
// frame = l*nxb + xb. A copy stamps the `win`-row window at band b0 and,
// when nb > win/16 (a tall copy), the 16-row tail bands up to b0 + nb: the
// rows the TPU's tiers stamp (tinycarlo_tpu/ops/rasterize_pallas.py
// `_tier_loops`, `_tier_loops_exact`), rows [rowband*16, rowband*16 +
// max(nb, win/16)*16) of the stacked strip, rowband = frame*n_bands + b0.
// `compact_env_idx_soa(pre=False)` (masks.cu, rank.cu) carries SoA ax, ay,
// abx, aby, inv (B, LE) float32 beside bw, its ay shifted by the frame's
// row offset frame*hp; `compact_env_exact_soa` (exact.cu) 30 int32 fields,
// the last of which is bw.
//
// Arithmetic. `window_hit` is `_window_hit` (rasterize_pallas.py:134)
// operation for operation: the window-relative `ay - y0` in float, apx = x
// - ax, apy = ys - (ay - y0), the split stroke's tu / clip / d2 chain at t
// >= 2, the closed-form Bresenham with its residual-corrected floor at t =
// 1. All coordinates are integer-valued floats below 2^24, and with
// -fmad=false no multiply-add is contracted, so the kernels agree bit for
// bit with their plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tc {

constexpr int kNbShift = 9;    // rasterize_pallas._NB_SHIFT
constexpr int kNbMask = 511;   // rasterize_pallas._NB_PACK - 1
constexpr int kXB = 128;       // rasterize_pallas._XB
constexpr int kGran = 16;      // rows per band (rasterize_kernels._GRAN)

// A bundle's frame geometry and sizes.
struct Geometry {
  int B, L, h, w, hp, win, nxb, wb, kp, le, n_bands;
};

// As rasterize_kernels._frame_geometry: `gran`-row bands (16 unless
// given), a two-band window, and, when `split`, 128-lane blocks when w
// exceeds one block.
inline void set_geometry(Geometry& g, int B, int L, int h, int w, int kp,
                         int le, int gran = kGran, bool split = true) {
  g.B = B;
  g.L = L;
  g.h = h;
  g.w = w;
  g.kp = kp;
  g.le = le;
  g.n_bands = (h + gran - 1) / gran;
  g.hp = g.n_bands * gran;
  g.win = g.hp < 2 * gran ? g.hp : 2 * gran;
  g.nxb = split && w > kXB ? (w + kXB - 1) / kXB : 1;
  g.wb = g.nxb > 1 ? kXB : w;
}

// The fast stroke's bundle (compact_env_idx_soa).
struct Params : Geometry {
  const int32_t* counts;  // (4 + L, B)
  const int32_t* idx;     // (B, kp)
  const float* ax;        // (B, le) each
  const float* ay;
  const float* abx;
  const float* aby;
  const float* inv;
  const int32_t* bw;      // (B, le)
  int bres;               // 1: thickness-1 Bresenham stamp, 0: split stroke
  float lat2, cap2;
};

// A band word's stacked frame index, and whether the copy draws at all.
__device__ __forceinline__ int word_frame(int word, const Geometry& g) {
  return (word >> kNbShift) / g.n_bands;
}
__device__ __forceinline__ bool word_live(int word) {
  return (word & kNbMask) > 0;
}

// `p` carries the stroke: bres, lat2, cap2 (a Params).
template <typename Stroke>
__device__ __forceinline__ bool window_hit(float apx, float apy, float abx,
                                           float aby, float inv,
                                           const Stroke& p) {
  if (p.bres) {
    float ady = fabsf(aby);
    float sy = aby >= 0.f ? 1.f : -1.f;
    bool xmaj = abx >= ady;
    float maj = fmaxf(abx, ady);
    float mino = fminf(abx, ady);
    float step = xmaj ? apx : sy * apy;
    float num = 2.f * mino * step + (maj - 1.f);
    float q = floorf(num * inv);
    float r = num - q * (2.f * maj);
    q = q + (r >= 2.f * maj ? 1.f : 0.f) - (r < 0.f ? 1.f : 0.f);
    float probe = xmaj ? apy : apx;
    float target = xmaj ? sy * q : q;
    if (maj == 0.f) return (apx == 0.f) && (apy == 0.f);
    return (step >= 0.f) && (step <= maj) && (probe == target);
  }
  float tu = (apx * abx + apy * aby) * inv;
  float t = fminf(fmaxf(tu, 0.f), 1.f);
  float dx = apx - t * abx;
  float dy = apy - t * aby;
  float d2 = dx * dx + dy * dy;
  float r2 = (tu >= 0.f && tu <= 1.f) ? p.lat2 : p.cap2;
  return d2 <= r2;
}

// ---- The box-clipped stamps of masks.cu, rank.cu and exact.cu ----
//
// The pixels a fast-stroke copy can light: its segment's bounding box,
// widened by `pad` (the stroke's reach, sqrt(max(lat2, cap2)), 0 for the
// thickness-1 Bresenham, plus kBoxMargin), clipped to the rows it stamps
// (its window and tail bands of Gran rows, rows [b0*Gran, b0*Gran +
// max(nb, win/Gran)*Gran) of its frame, and [0, h)) and to the lanes of
// its lane block that the
// frame has ([0, min(wb, w - xb*128)) block-local). A lit pixel lies
// within the reach of the segment: `window_hit`'s clamped t keeps t*ab
// between 0 and ab, and d2 <= r2 bounds |dx| and |dy| by the reach; the
// Bresenham's step and probe stay within [0, ab]. Float rounding moves
// a computed distance by far less than the margin (below 0.3 px at the
// compaction's 1e6 px clamp). rasterize_kernels.copy_box is the same rule
// in PyTorch, and tests/test_torch_masks_box.py (masks, rank) and
// test_torch_soa_box.py (env, segment) check that no lit pixel of the
// plain versions falls outside it. The exact stroke's box
// (exact.cu) is the same rule over the segment between its cap centres,
// padded by the stroke's extent (rasterize_kernels.exact_copy_box;
// tests/test_torch_exact_box.py).
constexpr float kBoxMargin = 1.f;

struct CopyBox {
  int x0, x1;  // block-local lanes [x0, x1)
  int y0, y1;  // frame rows [y0, y1)
  int xoff;    // the lane block's first output lane, xb*128
  int wrow0;   // the window's first frame row, b0*Gran
  int y0s;     // the window's first stacked strip row, rowband*Gran
};

// The box of a copy with band word `word` and payload (ax, ay, abx, aby)
// at Gran-row bands: empty (x1 <= x0 or y1 <= y0) when it lights nothing
// here.
template <int Gran = kGran>
__device__ __forceinline__ CopyBox copy_box(const Geometry& g, int word,
                                            float ax, float ay, float abx,
                                            float aby, float pad) {
  CopyBox b;
  const int nb = word & kNbMask;
  const int rowband = word >> kNbShift;
  const int frame = rowband / g.n_bands;
  b.wrow0 = (rowband - frame * g.n_bands) * Gran;
  b.y0s = rowband * Gran;
  b.xoff = (frame % g.nxb) * kXB;
  const int rows = max(nb, g.win / Gran) * Gran;
  // the segment in block-local lanes and frame rows
  const float ayf = ay - (float)(frame * g.hp);
  const float bx = ax + abx, by = ayf + aby;
  const float x0 = fmaxf(ceilf(fminf(ax, bx) - pad), 0.f);
  const float x1 = fminf(floorf(fmaxf(ax, bx) + pad) + 1.f,
                         (float)min(g.wb, g.w - b.xoff));
  const float y0 = fmaxf(ceilf(fminf(ayf, by) - pad), (float)b.wrow0);
  const float y1 = fminf(floorf(fmaxf(ayf, by) + pad) + 1.f,
                         (float)min(b.wrow0 + rows, g.h));
  b.x0 = (int)x0;
  b.x1 = x1 > x0 ? (int)x1 : b.x0;
  b.y0 = (int)y0;
  b.y1 = y1 > y0 ? (int)y1 : b.y0;
  return b;
}

// How a strip byte becomes an output element: a mask's 0/255.
struct MaskU8 {
  using T = uint8_t;
  using V = uchar4;
  __device__ static T one(uint8_t s) { return s ? 255 : 0; }
  __device__ static V four(uint8_t a, uint8_t b, uint8_t c, uint8_t d) {
    return make_uchar4(one(a), one(b), one(c), one(d));
  }
};
// Write `cols` lanes of rows [0, h) of the strip, whose rows are `stride`
// bytes apart (zeros when strip is null), to dst, whose rows are `w`
// elements apart, in 4-wide stores when `vec`.
template <typename Conv>
__device__ void store_rows(typename Conv::T* dst, const uint8_t* strip,
                           int stride, const Geometry& g, int cols,
                           bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < g.h * c4; i += blockDim.x) {
      const int r = i / c4;
      const int x = (i - r * c4) * 4;
      typename Conv::V v = Conv::four(0, 0, 0, 0);
      if (strip) {
        const uint8_t* s = strip + r * stride + x;
        v = Conv::four(s[0], s[1], s[2], s[3]);
      }
      *reinterpret_cast<typename Conv::V*>(dst + (size_t)r * g.w + x) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < g.h * cols; i += blockDim.x) {
    const int r = i / cols;
    const int x = i - r * cols;
    dst[(size_t)r * g.w + x] = Conv::one(strip ? strip[r * stride + x] : 0);
  }
}

// ---- The per-frame bundle: one block per 128-lane tile of a frame ----
//
// Only frame_soa.cu (K6) still runs this design, and its redesign on
// env_block.cuh deletes it: `Tile`, `block_tile`, `touches`, `stamp_tile`,
// `soa_tile`, `tile_smem`, `launch_tiles`, `store_rows` and `MaskU8`. A
// block keeps a tile of a frame in shared memory, at most 128 lanes wide:
// block (env, l, T) owns the output lanes [T*128, min(w, T*128 + 128)) of
// layer l, T < ceil(w/128) (frame_soa.cu's bundle is never lane-split:
// its slots carry frame lanes).
struct Tile {
  int env, l;
  int x0;     // its first lane
  int cols;   // its lanes
  int tw;     // the strip's row stride, min(w, 128)
};

__host__ __device__ inline int n_tiles(int w) { return (w + kXB - 1) / kXB; }

// The tile of block blockIdx.x = (env*L + l)*n_tiles(w) + T.
__device__ __forceinline__ Tile block_tile(const Geometry& g) {
  const int nt = n_tiles(g.w);
  const int f = blockIdx.x / nt;  // env*L + l
  const int T = blockIdx.x - f * nt;
  Tile t;
  t.env = f / g.L;
  t.l = f - t.env * g.L;
  t.x0 = T * kXB;
  t.cols = min(kXB, g.w - t.x0);
  t.tw = min(g.w, kXB);
  return t;
}

// Whether a slot whose segment spans the lanes [ax, ax + abx] can light a
// lane of the tile: that range widened by `pad`, the stroke's reach plus a
// margin, meets the tile's. A pixel farther than the reach from the range
// is never lit (|dx| alone exceeds it), so skipping the slot changes no
// output.
__device__ __forceinline__ bool touches(float ax, float abx, float pad,
                                        const Tile& t) {
  const float bx = ax + abx;
  return fmaxf(ax, bx) + pad >= (float)t.x0 &&
         fminf(ax, bx) - pad <= (float)(t.x0 + t.cols - 1);
}

// Stamp one fast-stroke slot into a tile's strip with all threads: the
// window at row band `rowband` of the slot's stacked strip and, when nb >
// win/Gran, the tail bands through band nb of the window, over the
// tile's lanes; row rr from the window start lands on strip row b0*Gran +
// rr, b0 the band within the frame. The pixel row is taken as `_kernel`
// takes it, apy = (rr + y0) - ay (exact: integer-valued floats below
// 2^24). Rows outside the strip's [0, hp) are never written: a
// compaction's own bands always fit, but the bundle does not carry its
// band height, and one compacted at another gran would reach past the
// strip. No barrier: stores of 1 are idempotent.
template <int Gran, typename Stroke>
__device__ __forceinline__ void stamp_tile(const Geometry& g,
                                           const Stroke& s, const Tile& t,
                                           float ax, float ay, float abx,
                                           float aby, float inv, int rowband,
                                           int nb, int b0, uint8_t* strip) {
  const int rows = b0 < 0 ? 0
                          : min(max(nb, g.win / Gran) * Gran,
                                g.hp - b0 * Gran);
  const int y0 = rowband * Gran;
  uint8_t* base = strip + b0 * Gran * t.tw;
  for (int i = threadIdx.x; i < rows * t.cols; i += blockDim.x) {
    const int rr = i / t.cols;
    const int x = i - rr * t.cols;
    const float apy = ((float)rr + (float)y0) - ay;
    if (window_hit((float)(t.x0 + x) - ax, apy, abx, aby, inv, s)) {
      base[rr * t.tw + x] = 1;
    }
  }
}

// One block's tile of a (B, L, h, w) uint8 0/255 masks output. Zeros
// unless n > 0; otherwise the block zeroes its [hp][tw] strip
// (dynamic shared memory `smem`, the slot list after its `strip_bytes`),
// lists the slots s < n for which pick(s) holds, stamps each listed slot
// with stamp(s, strip), and writes rows [0, h) of its lanes out.
template <typename Pick, typename Stamp>
__device__ void soa_tile(const Geometry& g, const Tile& t, int n,
                         uint8_t* out, uint8_t* smem, int strip_bytes,
                         Pick pick, Stamp stamp) {
  __shared__ int n_list;
  uint8_t* dst = out + ((size_t)t.env * g.L + t.l) * g.h * g.w + t.x0;
  const bool vec = (g.w % 4 == 0) && (t.cols % 4 == 0);
  if (n <= 0) {
    store_rows<MaskU8>(dst, nullptr, t.tw, g, t.cols, vec);
    return;
  }
  uint8_t* strip = smem;
  int* list = reinterpret_cast<int*>(smem + strip_bytes);
  for (int i = threadIdx.x; i < g.hp * t.tw; i += blockDim.x) strip[i] = 0;
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    if (pick(s)) list[atomicAdd(&n_list, 1)] = s;
  }
  __syncthreads();
  const int m = n_list;
  for (int j = 0; j < m; ++j) stamp(list[j], strip);
  __syncthreads();
  store_rows<MaskU8>(dst, strip, t.tw, g, t.cols, vec);
}

// Dynamic shared memory of a tile's [hp][min(w, 128)] strip and a
// `list`-entry int list: sets *strip_bytes (the strip rounded to 16) and
// *total, and allows `kernel` that much.
template <typename K>
inline cudaError_t tile_smem(const Geometry& g, int list, K kernel,
                            int* strip_bytes, int* total) {
  const int tw = g.w < kXB ? g.w : kXB;
  *strip_bytes = (g.hp * tw + 15) / 16 * 16;
  *total = *strip_bytes + list * (int)sizeof(int);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *total);
}

// The launch of a tile kernel kernel(p, out, strip_bytes, pad) over
// B*L*n_tiles(w) blocks of `threads`, with a `list`-entry slot list; pad is
// the stroke's reach plus two lanes (`touches`). Returns the CUDA error.
template <typename K>
inline int launch_tiles(const Params& p, K kernel, uint8_t* out, int list,
                        int threads, cudaStream_t stream) {
  int strip_bytes, smem;
  cudaError_t err = tile_smem(p, list, kernel, &strip_bytes, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.B * p.L * n_tiles(p.w);
  const float pad = sqrtf(p.lat2 > p.cap2 ? p.lat2 : p.cap2) + 2.f;
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(p, out, strip_bytes,
                                                        pad);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc
