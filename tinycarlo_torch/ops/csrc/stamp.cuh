// stamp.cuh -- what the masks, rank and exact kernels share: the frame
// geometry, the band-word decode, the window/tail walk, the list of a
// frame's slots, the frame store, and the fast stroke's bundle and
// `window_hit` stamp. One copy, so the kernels cannot drift apart.
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

// As rasterize_kernels._frame_geometry: 16-row bands, a two-band window,
// and 128-lane blocks when w exceeds one block.
inline void set_geometry(Geometry& g, int B, int L, int h, int w, int kp,
                         int le) {
  g.B = B;
  g.L = L;
  g.h = h;
  g.w = w;
  g.kp = kp;
  g.le = le;
  g.n_bands = (h + kGran - 1) / kGran;
  g.hp = g.n_bands * kGran;
  g.win = g.hp < 2 * kGran ? g.hp : 2 * kGran;
  g.nxb = w > kXB ? (w + kXB - 1) / kXB : 1;
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

// Walk the rows a copy with band word `word` stamps in stacked frame
// `frame`, with all threads of the block: hit(y0, rr, x) for rr in [0,
// rows) from the window start -- stacked strip row y0 = rowband*16 -- and
// lane x in [0, wb); store(row, x) where it holds, row in [0, hp) of the
// frame's strip. No barrier: the caller orders stamps that must not
// overlap.
template <typename Hit, typename Store>
__device__ __forceinline__ void walk_window(const Geometry& g, int word,
                                            int frame, Hit hit, Store store) {
  const int nb = word & kNbMask;
  const int rowband = word >> kNbShift;  // frame * n_bands + b0 (stacked)
  const int b0 = rowband - frame * g.n_bands;
  // the window's bands, plus a tall copy's tail bands
  const int rows = max(nb, g.win / kGran) * kGran;
  const int y0 = rowband * kGran;
  for (int i = threadIdx.x; i < rows * g.wb; i += blockDim.x) {
    const int rr = i / g.wb;
    const int x = i - rr * g.wb;
    if (hit(y0, rr, x)) store(b0 * kGran + rr, x);
  }
}

__device__ __forceinline__ bool window_hit(float apx, float apy, float abx,
                                           float aby, float inv,
                                           const Params& p) {
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

// Stamp fast-stroke copy `o` (offset into the SoA arrays) of stacked frame
// `frame`: store(row, x) for every lit pixel. A tail band is stamped in
// its own kGran-row window at its band row, as `_tier_loops` does.
template <typename Store>
__device__ __forceinline__ void stamp_copy(const Params& p, size_t o,
                                           int frame, Store store) {
  const float ax = p.ax[o], ay = p.ay[o];
  const float abx = p.abx[o], aby = p.aby[o], inv = p.inv[o];
  walk_window(p, p.bw[o], frame, [&](int y0, int rr, int x) {
    float ys, ay_rel;
    if (rr < p.win) {
      ys = (float)rr;
      ay_rel = ay - (float)y0;
    } else {
      const int band_row = (rr / kGran) * kGran;
      ys = (float)(rr - band_row);
      ay_rel = ay - (float)(y0 + band_row);
    }
    return window_hit((float)x - ax, ys - ay_rel, abx, aby, inv, p);
  }, store);
}

// Collect into `list` the copies of the env's live slots (s < counts[0,
// env]) whose band word belongs to stacked frame `frame`, in any order;
// returns their number after a barrier. `n_list` is a shared counter.
__device__ __forceinline__ int list_frame_slots(const Geometry& g,
                                                const int32_t* idx,
                                                const int32_t* bw, int env,
                                                int n, int frame, int* list,
                                                int* n_list) {
  if (threadIdx.x == 0) *n_list = 0;
  __syncthreads();
  const int32_t* ei = idx + (size_t)env * g.kp;
  const int32_t* eb = bw + (size_t)env * g.le;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int e = ei[s];
    const int word = eb[e];
    if (word_live(word) && word_frame(word, g) == frame) {
      list[atomicAdd(n_list, 1)] = e;
    }
  }
  __syncthreads();
  return *n_list;
}

// How a strip byte becomes an output element: a mask's 0/255 or 0/1, or
// the raw byte (a rank).
struct MaskU8 {
  using T = uint8_t;
  using V = uchar4;
  __device__ static T one(uint8_t s) { return s ? 255 : 0; }
  __device__ static V four(uint8_t a, uint8_t b, uint8_t c, uint8_t d) {
    return make_uchar4(one(a), one(b), one(c), one(d));
  }
};
struct MaskF32 {
  using T = float;
  using V = float4;
  __device__ static T one(uint8_t s) { return s ? 1.f : 0.f; }
  __device__ static V four(uint8_t a, uint8_t b, uint8_t c, uint8_t d) {
    return make_float4(one(a), one(b), one(c), one(d));
  }
};
struct RawU8 {
  using T = uint8_t;
  using V = uchar4;
  __device__ static T one(uint8_t s) { return s; }
  __device__ static V four(uint8_t a, uint8_t b, uint8_t c, uint8_t d) {
    return make_uchar4(a, b, c, d);
  }
};

// Write `cols` lanes of rows [0, h) of the strip (zeros when strip is
// null) to dst, whose rows are `w` elements apart, in 4-wide stores when
// `vec`.
template <typename Conv>
__device__ void store_strip(typename Conv::T* dst, const uint8_t* strip,
                            const Geometry& g, int cols, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < g.h * c4; i += blockDim.x) {
      const int r = i / c4;
      const int x = (i - r * c4) * 4;
      typename Conv::V v = Conv::four(0, 0, 0, 0);
      if (strip) {
        const uint8_t* s = strip + r * g.wb + x;
        v = Conv::four(s[0], s[1], s[2], s[3]);
      }
      *reinterpret_cast<typename Conv::V*>(dst + (size_t)r * g.w + x) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < g.h * cols; i += blockDim.x) {
    const int r = i / cols;
    const int x = i - r * cols;
    dst[(size_t)r * g.w + x] = Conv::one(strip ? strip[r * g.wb + x] : 0);
  }
}

// One thread block's frame of a masks output (B, L, h, w), the block
// (env, frame) with frame = l*nxb + xb: B*L*nxb blocks. The frame is a
// uint8 [hp][wb] strip in dynamic shared memory (`smem`; the slot list
// follows the strip's `strip_bytes`); stamp(env, frame, strip, list, m)
// sets its lit bytes to 1 from the m listed copies, with all threads.
// Rows [0, h) and lanes [xb*128, min(w, xb*128 + 128)) are written out;
// layers with counts[4+l] == 0 and envs with no live slot as zeros.
template <typename Conv, typename Stamp>
__device__ void masks_frame(const Geometry& g, const int32_t* counts,
                            const int32_t* idx, const int32_t* bw,
                            typename Conv::T* out, uint8_t* smem,
                            int strip_bytes, Stamp stamp) {
  __shared__ int n_list;
  const int n_frames = g.L * g.nxb;
  const int env = blockIdx.x / n_frames;
  const int frame = blockIdx.x - env * n_frames;
  const int l = frame / g.nxb;
  const int x0 = (frame - l * g.nxb) * kXB;
  const int cols = min(g.w - x0, g.wb);
  const bool vec = (g.w % 4 == 0) && (cols % 4 == 0);
  typename Conv::T* dst = out + ((size_t)env * g.L + l) * g.h * g.w + x0;

  const int n = counts[env];
  if (n <= 0 || counts[(4 + l) * g.B + env] <= 0) {
    store_strip<Conv>(dst, nullptr, g, cols, vec);
    return;
  }
  uint8_t* strip = smem;
  int* list = reinterpret_cast<int*>(smem + strip_bytes);
  for (int i = threadIdx.x; i < g.hp * g.wb; i += blockDim.x) strip[i] = 0;
  // (the barriers in list_frame_slots order the zeroing before the stamps)
  const int m = list_frame_slots(g, idx, bw, env, n, frame, list, &n_list);
  stamp(env, frame, strip, list, m);
  __syncthreads();
  store_strip<Conv>(dst, strip, g, cols, vec);
}

// Dynamic shared memory of a block's strip and `lists` kp-entry int
// lists: sets *strip_bytes (the strip rounded to 16) and *total, and
// allows `kernel` that much (above the default 48 KB where needed).
template <typename K>
inline cudaError_t strip_smem(const Geometry& g, int lists, K kernel,
                              int* strip_bytes, int* total) {
  *strip_bytes = (g.hp * g.wb + 15) / 16 * 16;
  *total = *strip_bytes + lists * g.kp * (int)sizeof(int);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *total);
}

}  // namespace tc
