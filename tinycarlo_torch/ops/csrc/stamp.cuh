// stamp.cuh -- what the masks and rank kernels share: the compaction
// bundle's layout, the frame geometry, the band-word decode and the
// `window_hit` stamp. One copy, so the two kernels cannot drift apart.
//
// The bundle is that of `compact_env_idx_soa(pre=False)` (ops/
// rasterize_kernels.py): counts (4+L, B) int32 rows [live, one-band, short,
// dropped, per-layer...], idx (B, kp) int32 slot->copy map, SoA ax, ay,
// abx, aby, inv (B, LE) float32 and band words bw (B, LE) int32. A copy's
// band word is ((frame*n_bands + b0) << 9) | nb with the stacked frame
// index frame = l*nxb + xb; its ay carries the frame's row offset
// frame*hp. It stamps the `win`-row window at band b0 and, when nb >
// win/16 (a tall copy), the 16-row tail bands up to b0 + nb: the rows the
// TPU's tiers stamp (tinycarlo_tpu/ops/rasterize_pallas.py `_tier_loops`).
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

struct Params {
  const int32_t* counts;  // (4 + L, B)
  const int32_t* idx;     // (B, kp)
  const float* ax;        // (B, le) each
  const float* ay;
  const float* abx;
  const float* aby;
  const float* inv;
  const int32_t* bw;      // (B, le)
  int B, L, h, w, hp, win, nxb, wb, kp, le, n_bands;
  int bres;               // 1: thickness-1 Bresenham stamp, 0: split stroke
  float lat2, cap2;
};

// Frame geometry as rasterize_kernels._frame_geometry: 16-row bands, a
// two-band window, and 128-lane blocks when w exceeds one block.
inline void set_geometry(Params& p, int h, int w) {
  p.h = h;
  p.w = w;
  p.n_bands = (h + kGran - 1) / kGran;
  p.hp = p.n_bands * kGran;
  p.win = p.hp < 2 * kGran ? p.hp : 2 * kGran;
  p.nxb = w > kXB ? (w + kXB - 1) / kXB : 1;
  p.wb = p.nxb > 1 ? kXB : w;
}

// A band word's stacked frame index, and whether the copy draws at all.
__device__ __forceinline__ int word_frame(int word, const Params& p) {
  return (word >> kNbShift) / p.n_bands;
}
__device__ __forceinline__ bool word_live(int word) {
  return (word & kNbMask) > 0;
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

// Stamp copy `o` (offset into the SoA arrays) of stacked frame `frame`
// with all threads of the block: hit(row, x) for every lit pixel, row in
// [0, hp) of the frame's strip and x in [0, wb). No barrier: the caller
// orders stamps that must not overlap.
template <typename Hit>
__device__ __forceinline__ void stamp_copy(const Params& p, size_t o,
                                           int frame, Hit hit) {
  const float ax = p.ax[o], ay = p.ay[o];
  const float abx = p.abx[o], aby = p.aby[o], inv = p.inv[o];
  const int word = p.bw[o];
  const int nb = word & kNbMask;
  const int rowband = word >> kNbShift;  // frame * n_bands + b0 (stacked)
  const int b0 = rowband - frame * p.n_bands;
  // the window's bands, plus a tall copy's tail bands
  const int rows = max(nb, p.win / kGran) * kGran;
  const int y0 = rowband * kGran;  // stacked row of the window start
  const float ayw = ay - (float)y0;
  for (int i = threadIdx.x; i < rows * p.wb; i += blockDim.x) {
    const int rr = i / p.wb;
    const int x = i - rr * p.wb;
    float ys, ay_rel;
    if (rr < p.win) {
      ys = (float)rr;
      ay_rel = ayw;
    } else {
      // tail band: its own kGran-row window at y0 + band_row
      const int band_row = (rr / kGran) * kGran;
      ys = (float)(rr - band_row);
      ay_rel = ay - (float)(y0 + band_row);
    }
    const float apx = (float)x - ax;
    const float apy = ys - ay_rel;
    if (window_hit(apx, apy, abx, aby, inv, p)) hit(b0 * kGran + rr, x);
  }
}

}  // namespace tc
