// stamp.cuh -- what the port's kernels share: the frame geometry, the
// band-word decode, the fast stroke's bundle and `window_hit` stamp, and a
// copy's box. One copy, so the kernels cannot drift apart. masks.cu,
// rank.cu and exact.cu read the production bundles at 16-row bands;
// env_soa.cu, env_seg.cu and frame_soa.cu the older env-merged, segment
// and per-frame bundles at 8- or 16-row bands. All of them run one block
// per env (a per-frame bundle's frame is a one-layer env) on
// env_block.cuh's skeleton.
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

// ---- The box-clipped stamps of every kernel on env_block.cuh ----
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
// test_torch_soa_box.py (env, segment, frame) check that no lit pixel of the
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

}  // namespace tc
