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
// Design. One thread block per (env, lane block xb): B*nxb blocks. The
// block keeps its lane block as a uint8 [hp][wb] strip of ranks in shared
// memory (16 KB at 128 rows, 61 KB at 480 rows), zeroes it, collects the
// env's live slots of this lane block (any layer) into a shared list with
// each slot's layer, stamps them with all threads, then writes rows [0, h)
// and lanes [xb*128, min(w, xb*128 + 128)) to out[env] in 4-wide stores
// when the width allows.
//
// The max. masks.cu lets threads store 1 into overlapping pixels with no
// barrier between slots, which is safe only because storing 1 twice is
// idempotent. max(strip, l+1) from threads of different slots is a race:
// a lower layer's store could land after a higher one's. The block
// therefore stamps layer by layer in ascending order, with a barrier
// after each layer, and stores l+1 plainly: within one layer every store
// writes the same value, and a later layer overwrites an earlier one --
// cv2's own paint order, so the last store at a pixel is its maximum.
// This keeps the strip at one byte per pixel (an int32 strip with
// atomicMax would need 240 KB at 480x128 rows, more than a block has) and
// costs L barriers per block; layers with counts[4+l] == 0, or with no
// slot in this lane block, are skipped without walking their stamps.
//
// Bound on the H100 at the serving shape (B=4096, L=5, 128x160, t=2,
// ~32 live slots per env). Bytes: the uint8 map, 84 MB, written once,
// plus the counts, the live slots' idx entries and their copies' SoA
// entries, ~4 MB -- ~88 MB, 0.026 ms at 3.35 TB/s. Operations: the split
// stroke's 18 float32 operations per pixel, over each live copy's
// bounding box padded by the stroke radius, ~0.55 G -- 0.008 ms at 67
// TFLOP/s. So bytes bound it (chip_smoke.py computes both from each
// run's bundle). The design writes each output byte once but evaluates
// each live slot's whole window, ~20x the bounding boxes' pixels; like
// masks.cu it does not yet shrink the window to the segment's extent.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rank_kernel(Params p, uint8_t* __restrict__ out, int strip_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_list;
  const int env = blockIdx.x / p.nxb;
  const int xb = blockIdx.x - env * p.nxb;
  const int x0 = xb * kXB;
  const int cols = min(p.w - x0, p.wb);
  const bool vec = (p.w % 4 == 0) && (cols % 4 == 0);
  uint8_t* dst = out + (size_t)env * p.h * p.w + x0;

  const int n = p.counts[env];
  if (n <= 0) {
    store_strip<RawU8>(dst, nullptr, p, cols, vec);
    return;
  }

  uint8_t* strip = smem;
  int* list = reinterpret_cast<int*>(smem + strip_bytes);
  int* lays = list + p.kp;
  for (int i = threadIdx.x; i < p.hp * p.wb; i += blockDim.x) strip[i] = 0;
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();

  // This lane block's live slots, of every layer, in any order.
  const int32_t* idx = p.idx + (size_t)env * p.kp;
  const int32_t* bw = p.bw + (size_t)env * p.le;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    int e = idx[s];
    int word = bw[e];
    int frame = word_frame(word, p);
    if (word_live(word) && frame % p.nxb == xb) {
      int k = atomicAdd(&n_list, 1);
      list[k] = e;
      lays[k] = frame / p.nxb;
    }
  }
  __syncthreads();

  // Layers in paint order, a barrier after each: see "The max" above.
  const int m = n_list;
  for (int l = 0; l < p.L; ++l) {
    if (p.counts[(4 + l) * p.B + env] <= 0) continue;
    const uint8_t rank = (uint8_t)(l + 1);
    bool stamped = false;
    for (int j = 0; j < m; ++j) {
      if (lays[j] != l) continue;
      stamp_copy(p, (size_t)env * p.le + list[j], l * p.nxb + xb,
                 [&](int row, int x) { strip[row * p.wb + x] = rank; });
      stamped = true;
    }
    // `stamped` is the same in every thread: lays and m are shared
    if (stamped) __syncthreads();
  }
  __syncthreads();
  store_strip<RawU8>(dst, strip, p, cols, vec);
}

int launch(const Params& p, uint8_t* out, cudaStream_t stream) {
  int strip_bytes, smem;
  cudaError_t err = strip_smem(p, 2, rank_kernel, &strip_bytes, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.B * p.nxb;
  if (blocks > 0) {
    rank_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, out,
                                                              strip_bytes);
  }
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
