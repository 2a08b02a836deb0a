// masks.cu -- per-layer class masks from the compaction bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, MasksKernel).
//
// Replaces the two Pallas kernels of the JAX package's main path, which
// compute the same masks and differ only in how a frame leaves VMEM:
//   tinycarlo_tpu/ops/rasterize_pallas.py `_kernel_env_idx` (:1931, blocked
//   output; uint8 0/255 or float 0/1) and `_kernel_env_dma` (:2107, uint8
//   staged through multi-buffered DMA). Both run `_tier_loops` (:1664) over
//   the `_window_hit` stamp (:134).
//
// Function. For the bundle of `compact_env_idx_soa(pre=False)` (layout,
// band words and stamp arithmetic in stamp.cuh, shared with rank.cu),
// pixel (env, l, y, x) is lit iff some slot s < counts[0, env] whose band
// word decodes to frame l*nxb + x/128 stamps (y, x). Rows [h, hp) are
// never written out; layers with counts[4+l] == 0 and envs with no live
// slot are written as zeros.
//
// Design. One thread block per (env, frame), frame = l*nxb + xb: B*L*nxb
// blocks. The block keeps its frame as a uint8 [hp][wb] strip in shared
// memory (16 KB at 128 rows, 61 KB at 480 rows), zeroes it, collects the
// env's slots that belong to its frame into a shared list, stamps each
// listed slot's rows x wb lanes with all threads (stores of 1 are
// idempotent, so overlapping slots need no atomics), then writes rows
// [0, h) and lanes [xb*128, min(w, xb*128 + 128)) to out[env, l] in
// row-contiguous, 4-wide stores when the width allows.
//
// Bound on the H100 at the bench shape (B=4096, L=5, 128x160, LE=528,
// kp=263). Bytes: the uint8 output, 419 MB, written once, plus the
// counts, the live slots' idx entries and their copies' SoA entries,
// ~4 MB -- ~423 MB, 0.126 ms at 3.35 TB/s. Operations: the split stroke
// costs 18 float operations per pixel, and only the pixels of each live
// copy's bounding box, padded by the stroke radius, can be lit: ~0.56 G,
// 0.008 ms at 67 TFLOP/s. So bytes bound it (chip_smoke.py computes both
// from each run's bundle). The design writes each output byte once, with
// row-contiguous stores, but evaluates win*128 = 4096 pixels per short
// slot (more for talls), ~17x the bounding boxes' pixels; it does not yet
// shrink the window to the segment's extent, bit-pack the strip, or keep
// blocks resident across envs -- later work.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

template <typename OutT>
struct Pack4;

template <>
struct Pack4<uint8_t> {
  using V = uchar4;
  __device__ static V make(bool a, bool b, bool c, bool d) {
    return make_uchar4(a ? 255 : 0, b ? 255 : 0, c ? 255 : 0, d ? 255 : 0);
  }
  __device__ static uint8_t one() { return 255; }
};

template <>
struct Pack4<float> {
  using V = float4;
  __device__ static V make(bool a, bool b, bool c, bool d) {
    return make_float4(a ? 1.f : 0.f, b ? 1.f : 0.f, c ? 1.f : 0.f,
                       d ? 1.f : 0.f);
  }
  __device__ static float one() { return 1.f; }
};

// Write `cols` lanes of rows [0, h) from the strip (or zeros when strip is
// null) to dst, whose rows are `w` elements apart.
template <typename OutT>
__device__ void store_frame(OutT* dst, const uint8_t* strip, const Params& p,
                            int cols, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < p.h * c4; i += blockDim.x) {
      int r = i / c4;
      int x = (i - r * c4) * 4;
      typename Pack4<OutT>::V v;
      if (strip) {
        const uint8_t* s = strip + r * p.wb + x;
        v = Pack4<OutT>::make(s[0], s[1], s[2], s[3]);
      } else {
        v = Pack4<OutT>::make(false, false, false, false);
      }
      *reinterpret_cast<typename Pack4<OutT>::V*>(dst + (size_t)r * p.w + x) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < p.h * cols; i += blockDim.x) {
    int r = i / cols;
    int x = i - r * cols;
    bool lit = strip && strip[r * p.wb + x];
    dst[(size_t)r * p.w + x] = lit ? Pack4<OutT>::one() : OutT(0);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
masks_kernel(Params p, OutT* __restrict__ out, int strip_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_list;
  const int n_frames = p.L * p.nxb;
  const int env = blockIdx.x / n_frames;
  const int frame = blockIdx.x - env * n_frames;
  const int l = frame / p.nxb;
  const int x0 = (frame - l * p.nxb) * kXB;
  const int cols = min(p.w - x0, p.wb);
  const bool vec = (p.w % 4 == 0) && (cols % 4 == 0);
  OutT* dst = out + ((size_t)env * p.L + l) * p.h * p.w + x0;

  const int n = p.counts[env];
  if (n <= 0 || p.counts[(4 + l) * p.B + env] <= 0) {
    store_frame<OutT>(dst, nullptr, p, cols, vec);
    return;
  }

  uint8_t* strip = smem;
  int* list = reinterpret_cast<int*>(smem + strip_bytes);
  for (int i = threadIdx.x; i < p.hp * p.wb; i += blockDim.x) strip[i] = 0;
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();

  // This frame's live slots, in any order (the masks are an OR).
  const int32_t* idx = p.idx + (size_t)env * p.kp;
  const int32_t* bw = p.bw + (size_t)env * p.le;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    int e = idx[s];
    int word = bw[e];
    if (word_live(word) && word_frame(word, p) == frame) {
      list[atomicAdd(&n_list, 1)] = e;
    }
  }
  __syncthreads();

  const int m = n_list;
  for (int j = 0; j < m; ++j) {
    stamp_copy(p, (size_t)env * p.le + list[j], frame,
               [&](int row, int x) { strip[row * p.wb + x] = 1; });
  }
  __syncthreads();
  store_frame<OutT>(dst, strip, p, cols, vec);
}

template <typename OutT>
int launch(const Params& p, OutT* out, cudaStream_t stream) {
  const int strip_bytes = (p.hp * p.wb + 15) / 16 * 16;
  const int smem = strip_bytes + p.kp * (int)sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masks_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)p.B * p.L * p.nxb;
  if (blocks > 0) {
    masks_kernel<OutT><<<(unsigned)blocks, kThreads, smem, stream>>>(
        p, out, strip_bytes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tc_masks_launch(
    const int32_t* counts, const int32_t* idx, const float* ax,
    const float* ay, const float* abx, const float* aby, const float* inv,
    const int32_t* bw, void* out, int out_float, int B, int L, int h, int w,
    int kp, int le, int bres, float lat2, float cap2, void* stream) {
  tc::Params p;
  p.counts = counts;
  p.idx = idx;
  p.ax = ax;
  p.ay = ay;
  p.abx = abx;
  p.aby = aby;
  p.inv = inv;
  p.bw = bw;
  p.B = B;
  p.L = L;
  tc::set_geometry(p, h, w);
  p.kp = kp;
  p.le = le;
  p.bres = bres;
  p.lat2 = lat2;
  p.cap2 = cap2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_float) return launch<float>(p, static_cast<float*>(out), s);
  return launch<uint8_t>(p, static_cast<uint8_t*>(out), s);
}
