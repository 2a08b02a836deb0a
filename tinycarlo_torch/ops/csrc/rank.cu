// rank.cu -- the paint-order layer-rank map from the compaction bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, RankKernel).
//
// Replaces the Pallas kernel tinycarlo_tpu/ops/rasterize_pallas.py
// `_kernel_env_rank` (:1493), which runs `_tier_loops` (:1664) with its
// `rank_decode` branch (:1776-1791) over the `_window_hit` stamp (:134).
// It renders the rgb, rgb_planar and rank observation formats: the map is
// composited to rgb by ops/rasterize.py `rgb_from_rank`.
//
// Function. For the bundle of `compact_env_idx_soa(pre=False)` (layout,
// band words and stamp arithmetic in stamp.cuh, shared with masks.cu),
// out[env, y, x] = 1 + the highest layer l such that some live slot s <
// counts[0, env] whose band word decodes to frame l*nxb + x/128 stamps
// (y, x), and 0 where none does. cv2 paints the layers in index order,
// later over earlier (reference renderer.py:41-43), so this is the layer
// painted last. Envs with no live slot are written as zeros. It equals
// rank_from_masks of the masks kernel's output on the same bundle.
//
// Design. The one-block-per-env skeleton of env_block.cuh, shared with
// masks.cu, exact.cu, env_soa.cu and env_seg.cu, in its rank shape: one
// block of 128 threads per env buckets the env's live copies by layer
// once, with masks.cu's boxes and
// units (`FastCopies`), and walks the env's (h, w) map in whole-width
// row chunks in shared memory (the whole 20 KB map at 128x160; 48-row chunks
// at 480x640). Into each chunk it stamps layer 0's units, then, after a
// barrier, layer 1's, and so on, each store a plain l + 1 -- cv2's paint
// order, so the last store at a pixel is 1 + its highest layer. A max from
// threads of different layers would race, and this needs no atomics: within a
// layer every store writes the same value. A layer with no unit is skipped
// without a barrier, and a chunk with none is a register fill of zeros. The
// chunk leaves through store.cuh's 16-byte streaming stores.
//
// Bound on the H100 at the serving shape (B=4096, L=5, 128x160, t=2,
// ~32 live slots per env). Bytes: the uint8 map, 84 MB, written once,
// plus the counts, the live slots' idx entries and their copies' SoA
// entries, ~4 MB -- ~88 MB, 0.026 ms at 3.35 TB/s. Operations: the split
// stroke's 18 float32 operations per pixel, over each live copy's
// bounding box padded by the stroke radius, ~0.55 G -- 0.008 ms at 67
// TFLOP/s. So bytes bound it (chip_smoke.py computes both from each
// run's bundle). The design writes each output byte once, 16 bytes a
// store, and tests only the boxes' pixels (with a one-pixel margin).
#include "env_block.cuh"

namespace {

using namespace tc;

__global__ void __launch_bounds__(kEnvThreads)
rank_kernel(Params p, uint8_t* __restrict__ out, Chunks q, float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  env_frames<true>(IdxSlots{p, p.counts, p.idx, p.bw}, FastCopies<>{p, pad},
                   p, out, q, (uint8_t)0, smem);
}

int launch(const Params& p, uint8_t* out, cudaStream_t stream) {
  if ((long long)p.B * p.h * p.w == 0) return (int)cudaGetLastError();
  const Chunks q = plan_chunks(p, 1, p.kp);
  const size_t smem = env_smem(q, p);
  cudaError_t err = cudaFuncSetAttribute(
      rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rank_kernel<<<p.B, kEnvThreads, smem, stream>>>(p, out, q, fast_pad(p));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tc_rank_launch(
    const int32_t* counts, const int32_t* idx, const float* ax,
    const float* ay, const float* abx, const float* aby, const float* inv,
    const int32_t* bw, void* out, int B, int L, int h, int w, int kp, int le,
    int bres, float lat2, float cap2, void* stream) {
  tc::Params p;
  tc::set_geometry(p, B, L, h, w, kp, le);
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
  return launch(p, static_cast<uint8_t*>(out),
                static_cast<cudaStream_t>(stream));
}
