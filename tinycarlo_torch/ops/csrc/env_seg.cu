// env_seg.cu -- per-layer class masks from the segment-axis bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, EnvSegKernel).
//
// Replaces the Pallas kernel tinycarlo_tpu/ops/rasterize_pallas.py
// `_kernel_env_seg` (:1345, `pallas_call` :1481) with `_tier_loops_seg`
// (:1275), a measured-slower alternate of the production masks kernel
// that the rasterizer benchmark (tinycarlo_torch.benchmarks.rasterize_bench,
// mode `seg`) times.
//
// Function. For the bundle of `compact_env_seg` at band granularity 8 or
// 16 (one slot per segment: idx (B, kp) slot -> segment, per segment ax,
// ay, abx, aby, inv float32 and bw int32 on the (B, le) segment axis, ay
// pre-shifted by its layer's strip base lay*nxb*hp; counts (4+L, B) rows
// [live, one-band, short, dropped, per-layer...]), a live slot s <
// counts[0, env] decodes its word: touch bits = bw & (2^nxb - 1), nb =
// (bw >> nxb) & 511, enc = (bw >> nxb) >> 9 = lay*nxb*n_bands + b0c. For
// each set bit xb it stamps stacked frame lay*nxb + xb: the window at band
// enc + xb*n_bands and, when tall, the tail bands [win/gran, nb) after it,
// with ax - xb*128 and ay + xb*hp and `_tier_loops_seg`'s window-relative
// pixel rows (stamp.cuh `stamp_tile`). Layers with counts[4+l] == 0, and
// envs with no live slot, are zeros.
//
// Design. One thread block per 128-lane tile of a frame, B*L*ceil(w/128)
// blocks (stamp.cuh `soa_tile`); in the split layout a tile is lane block
// xb. The block zeroes a uint8 [hp][min(w, 128)] strip, lists the env's
// live slots of its layer whose bit xb is set and whose x-range, widened
// by the stroke, meets its lanes, stamps them with all threads, and
// writes rows [0, h) out. Never past counts[0] (the idx's 7 pad slots
// serve the TPU's unrolled loops, not this kernel), never a slot with nb
// == 0.
//
// Bound on the H100 at the benchmark's shape (B=4096, L=5, 128x160, t=2,
// gran 16, k=128 segments per env): the uint8 output, 419 MB, written
// once, plus the counts, the live slots' idx entries and their segments'
// SoA entries: ~0.126 ms at 3.35 TB/s; the stamp's float32 operations
// over the segments' bounding boxes are well under that, so bytes bound
// it (computed from the run's bundle by the benchmark and chip_smoke.py).
// The design evaluates whole windows over the tile's lanes; later work.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

template <int Gran>
__global__ void __launch_bounds__(kThreads)
env_seg_kernel(Params p, uint8_t* __restrict__ out, int strip_bytes,
               float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile t = block_tile(p);
  const int32_t* seg = p.idx + (size_t)t.env * p.kp;  // slot -> segment
  const size_t o = (size_t)t.env * p.le;              // the env's segments
  const int layer_base = t.l * p.nxb * p.n_bands;     // lay*nxb*n_bands
  const float xshift = (float)(t.xb * kXB);
  const float yshift = (float)(t.xb * p.hp);
  soa_tile(
      p, t, p.counts[(4 + t.l) * p.B + t.env] > 0, p.counts[t.env], out,
      smem, strip_bytes,
      [&](int s) {
        const size_t q = o + seg[s];
        const int word = p.bw[q];
        const int rest = word >> p.nxb;
        const int enc = rest >> kNbShift;
        return (rest & kNbMask) > 0 && (word >> t.xb & 1) &&
               enc / (p.nxb * p.n_bands) == t.l &&
               touches(p.ax[q] - xshift, p.abx[q], pad, t);
      },
      [&](int s, uint8_t* strip) {
        const size_t q = o + seg[s];
        const int rest = p.bw[q] >> p.nxb;
        const int enc = rest >> kNbShift;
        stamp_tile<Gran, false>(p, p, t, p.ax[q] - xshift, p.ay[q] + yshift,
                                p.abx[q], p.aby[q], p.inv[q],
                                enc + t.xb * p.n_bands, rest & kNbMask,
                                enc - layer_base, strip);
      });
}

}  // namespace

extern "C" int tc_env_seg_launch(
    const int32_t* counts, const int32_t* idx, const float* ax,
    const float* ay, const float* abx, const float* aby, const float* inv,
    const int32_t* bw, uint8_t* out, int B, int L, int h, int w, int kp,
    int le, int split, int gran, int bres, float lat2, float cap2,
    void* stream) {
  tc::Params p;
  tc::set_geometry(p, B, L, h, w, kp, le, gran, split != 0);
  p.counts = counts;
  p.idx = idx;
  p.ax = ax;
  p.ay = ay;
  p.abx = abx;
  p.aby = aby;
  p.inv = inv;
  p.bw = bw;
  p.bres = bres;
  p.lat2 = lat2;
  p.cap2 = cap2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gran == 8) {
    return tc::launch_tiles(p, env_seg_kernel<8>, out, kp, kThreads, s);
  }
  if (gran == 16) {
    return tc::launch_tiles(p, env_seg_kernel<16>, out, kp, kThreads, s);
  }
  return (int)cudaErrorInvalidValue;
}
