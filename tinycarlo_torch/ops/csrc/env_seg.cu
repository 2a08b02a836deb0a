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
// pixel rows, a tail band in its own gran-row window (env_block.cuh
// `FastCopies`). Layers with counts[4+l] == 0, and envs with no live slot,
// are zeros.
//
// Design. The one-block-per-env skeleton of env_block.cuh, shared with
// masks.cu (see there): one block of 128 threads per env buckets by layer
// one copy per (slot, touched lane block) (`SegSlots`, copy number
// e*nxb + xb for segment e), with the band word of that block, so that a
// copy is what `rasterize_env_seg_plain` stamps; it stamps only each
// copy's box (stamp.cuh `copy_box` at Gran-row bands, of the shifted
// payload: `SegCopies`) into whole-width row chunks in shared memory, and
// drains each chunk through store.cuh's 16-byte streaming stores; an empty
// env or layer is a register fill of zeros. The buckets hold (kp - 7)*nxb
// records (the idx's 7 pad slots serve the TPU's unrolled loops, not this
// kernel). Never past counts[0], never a copy with nb == 0 or one whose
// frame lies past L*nxb (a bundle compacted at the other band height).
//
// Bound on the H100 at the benchmark's shape (B=4096, L=5, 128x160, t=2,
// gran 16, k=128 segments per env): the uint8 output, 419 MB, written
// once, plus the counts, the live slots' idx entries and their segments'
// SoA entries: ~0.126 ms at 3.35 TB/s; the stamp's float32 operations
// over the segments' bounding boxes are well under that, so bytes bound
// it (computed from the run's bundle by the benchmark and chip_smoke.py).
// The design writes each output byte once, 16 bytes a store, and tests
// only the boxes' pixels.
#include "env_block.cuh"

namespace {

using namespace tc;

// The band word of lane block xb of a segment with band word `word`:
// ((enc + xb*n_bands) << 9) | nb.
__device__ __forceinline__ int block_word(const Geometry& g, int word,
                                          int xb) {
  return (word >> g.nxb) + ((xb * g.n_bands) << kNbShift);
}

// compact_env_seg's slots: counts and idx as the production bundles'
// (IdxSlots), but slot s of an env reads segment e = idx[env, s] and gives
// one copy per set touch bit xb, numbered e*nxb + xb, with its block's
// band word.
struct SegSlots : IdxSlots {
  template <typename F>
  __device__ __forceinline__ void copies(int env, int s, F f) const {
    const int e = idx[(size_t)env * g.kp + s];
    const int word = bw[(size_t)env * g.le + e];
    for (int xb = 0; xb < g.nxb; ++xb) {
      if (!(word >> xb & 1)) continue;
      const int wx = block_word(g, word, xb);
      const int l = word_layer(g, wx);
      if (l >= 0) f(l, e * g.nxb + xb, wx);
    }
  }
};

// The copies of SegSlots: segment e's payload moved into lane block xb's
// lanes and stacked strip rows, ax - xb*128 and ay + xb*hp, as the plain
// version shifts it.
template <int Gran>
struct SegCopies {
  FastCopies<Gran, false> f;

  __device__ __forceinline__ Units units(int env, int c, int word) const {
    const Params& p = f.p;
    const int e = c / p.nxb, xb = c - e * p.nxb;
    const size_t o = (size_t)env * p.le + e;
    return f.box_units(word, p.ax[o] - (float)(xb * kXB),
                       p.ay[o] + (float)(xb * p.hp), p.abx[o], p.aby[o]);
  }

  template <typename T>
  __device__ __forceinline__ void stamp(int env, int c, int uy, int rows,
                                        int cy0, int cy1, T* chunk,
                                        T value) const {
    const Params& p = f.p;
    const int e = c / p.nxb, xb = c - e * p.nxb;
    const size_t o = (size_t)env * p.le + e;
    f.stamp_copy(block_word(p, p.bw[o], xb), p.ax[o] - (float)(xb * kXB),
                 p.ay[o] + (float)(xb * p.hp), p.abx[o], p.aby[o], p.inv[o],
                 uy, rows, cy0, cy1, chunk, value);
  }
};

template <int Gran>
__global__ void __launch_bounds__(kEnvThreads)
env_seg_kernel(Params p, uint8_t* __restrict__ out, Chunks q, float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  env_frames<false>(SegSlots{{p, p.counts, p.idx, p.bw}},
                    SegCopies<Gran>{{p, pad}}, p, out, q,
                    One<uint8_t>::value(), smem);
}

template <int Gran>
int launch(const Params& p, uint8_t* out, cudaStream_t stream) {
  if ((long long)p.B * p.L * p.h * p.w == 0) return (int)cudaGetLastError();
  const Chunks q = plan_chunks(p, 1, max(p.kp - kPadSlots, 0) * p.nxb);
  const size_t smem = env_smem(q, p);
  cudaError_t err = cudaFuncSetAttribute(
      env_seg_kernel<Gran>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  env_seg_kernel<Gran><<<p.B, kEnvThreads, smem, stream>>>(p, out, q,
                                                           fast_pad(p));
  return (int)cudaGetLastError();
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
  if (gran == 8) return launch<8>(p, out, s);
  if (gran == 16) return launch<16>(p, out, s);
  return (int)cudaErrorInvalidValue;
}
