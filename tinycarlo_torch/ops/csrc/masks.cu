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
// Design. One block per env walks the env's work items (layer, row chunk)
// in order: all w lanes of as many rows as fit kChunkBytes (the whole
// frame at 128x160 uint8, 20 KB; 48-row chunks at 480x640 uint8 or
// 128x160 float32), so a chunk is one contiguous range of out[env, l].
// The block reads the env's live slots once and buckets their copies by
// layer in shared memory (a count, a prefix and a scatter), each copy with
// its number of work units: its box (stamp.cuh `copy_box`: the segment's
// bounding box padded by the stroke's reach, clipped to the copy's bands
// and lanes) cut into slabs of about kUnitPixels pixels. A prefix sum over
// the units lets the block's 4 warps take a layer's units round robin
// (a binary search finds a unit's copy); a warp walks its slab's pixels
// with lanes on neighbouring columns, stepping (row, column) without a
// division, and writes the output value (255, or 1.0f) straight into a
// zeroed chunk buffer laid out at the destination's 16-byte phase, so
// only pixels of a box are tested, and only output lanes. `window_hit` is
// called with the same apx/apy floats as the plain version (integer
// valued, exact), so the masks stay bit-equal. The chunk then leaves
// through store.cuh's 16-byte streaming stores (`drain_span`, the fill
// probe's path), which zero the buffer behind them; an item with no unit
// (empty env or layer, or no box in it) is a register fill of zeros
// (`fill_span`) and touches no shared memory. One buffer is enough:
// stores retire without holding the threads, and the other resident
// blocks stamp while one stores: 128 threads a block, so that many envs
// are in flight on an SM (256 and 512 measured slower, as did 64). Envs
// differ in their work, and a grid of one block per env lets the card
// start the next env wherever one ends;
// a persistent grid of resident blocks, each walking a fixed run of
// (env, layer, chunk) items, measured slower on the H100, and so did one
// dealing the items round robin (each block then buckets an env for
// every item).
//
// Bound on the H100 at the bench shape (B=4096, L=5, 128x160, LE=528,
// kp=263). Bytes: the uint8 output, 419 MB, written once, plus the
// counts, the live slots' idx entries and their copies' SoA entries,
// ~4 MB -- ~423 MB, 0.126 ms at 3.35 TB/s. Operations: the split stroke
// costs 18 float operations per pixel, and only the pixels of each live
// copy's bounding box, padded by the stroke radius, can be lit: ~0.56 G,
// 0.008 ms at 67 TFLOP/s. So bytes bound it (chip_smoke.py computes both
// from each run's bundle). The design writes each output byte once,
// 16 bytes a store, and tests only the boxes' pixels (with a one-pixel
// margin around the reach).
#include "stamp.cuh"
#include "store.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the largest chunk of output rows a block stages in shared memory
constexpr int kChunkBytes = 32768;
// pixels of a box a warp takes at a time
constexpr int kUnitPixels = 1024;
// the bundle's idx carries 7 pad slots after its k slots
constexpr int kPadSlots = 7;

// A launch's row chunks and box padding.
struct Plan {
  int chunk_rows, n_chunks;  // rows per chunk, chunks per frame
  int buf_bytes;             // the chunk buffer, with 16 bytes of slack
  float pad;                 // the boxes' padding: the reach + kBoxMargin
};

template <typename T> struct One;
template <> struct One<uint8_t> { static constexpr uint8_t value = 255; };
template <> struct One<float> { static constexpr float value = 1.f; };

// The box of copy o (offset into the SoA arrays) and its work units.
__device__ __forceinline__ int copy_units(const Params& p, size_t o,
                                          int word, float pad) {
  const CopyBox b = copy_box(p, word, p.ax[o], p.ay[o], p.abx[o], p.aby[o],
                             pad);
  const int nx = b.x1 - b.x0, ny = b.y1 - b.y0;
  if (nx <= 0 || ny <= 0) return 0;
  const int rows = max(1, kUnitPixels / nx);
  return (ny + rows - 1) / rows;
}

// The layer of a live band word, or -1.
__device__ __forceinline__ int word_layer(const Params& p, int word) {
  if (!word_live(word) || word < 0) return -1;
  const int l = word_frame(word, p) / p.nxb;
  return l < p.L ? l : -1;
}

// In-place inclusive prefix sum of a[0, m) by the block; ends with a
// barrier.
__device__ void block_scan(int* a, int m, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + threadIdx.x;
    int v = i < m ? a[i] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane == 31) part[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int s = lane < kWarps ? part[lane] : 0;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      if (lane < kWarps) part[lane] = s;
    }
    __syncthreads();
    v += carry + (warp > 0 ? part[warp - 1] : 0);
    if (i < m) a[i] = v;
    carry += part[kWarps - 1];
    __syncthreads();
  }
}

// Env `env`'s live copies bucketed by layer: layer l's are rec_e[off[l],
// off[l+1]), and rec_p holds the running total of their work units over
// all layers (inclusive). Called by the whole block.
__device__ void bucket(const Params& p, const Plan& q, int env, int* rec_e,
                       int* rec_p, int* off, int* cur, int* part) {
  const int n = min(p.counts[env], max(p.kp - kPadSlots, 0));
  const int32_t* ei = p.idx + (size_t)env * p.kp;
  const int32_t* eb = p.bw + (size_t)env * p.le;
  for (int l = threadIdx.x; l < p.L; l += kThreads) cur[l] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const int l = word_layer(p, eb[ei[s]]);
    if (l >= 0) atomicAdd(&cur[l], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int l = 0; l < p.L; ++l) {
      off[l] = acc;
      acc += cur[l];
      cur[l] = off[l];
    }
    off[p.L] = acc;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const int e = ei[s];
    const int word = eb[e];
    const int l = word_layer(p, word);
    if (l < 0) continue;
    const int pos = atomicAdd(&cur[l], 1);
    rec_e[pos] = e;
    rec_p[pos] = copy_units(p, (size_t)env * p.le + e, word, q.pad);
  }
  __syncthreads();
  block_scan(rec_p, off[p.L], part);
}

// Stamp the work units [ub, ue) of layer l's copies (records [jb, je))
// into the chunk of frame rows [cy0, cy1), each warp a unit at a time.
template <typename T>
__device__ void stamp_units(const Params& p, const Plan& q, int env,
                            const int* rec_e, const int* rec_p, int jb,
                            int je, int ub, int ue, int cy0, int cy1,
                            T* chunk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = ub + warp; u < ue; u += kWarps) {
    // the unit's copy: the first record whose running total exceeds u
    int lo = jb, hi = je - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rec_p[mid] > u) hi = mid; else lo = mid + 1;
    }
    const int first = lo > 0 ? rec_p[lo - 1] : 0;
    const size_t o = (size_t)env * p.le + rec_e[lo];
    const int word = p.bw[o];
    const float ax = p.ax[o], ay = p.ay[o];
    const float abx = p.abx[o], aby = p.aby[o], inv = p.inv[o];
    const CopyBox b = copy_box(p, word, ax, ay, abx, aby, q.pad);
    const int nx = b.x1 - b.x0;
    const int slab = max(1, kUnitPixels / nx);
    const int y0 = max(b.y0 + (u - first) * slab, cy0);
    const int y1 = min(min(b.y1, b.y0 + (u - first + 1) * slab), cy1);
    if (y0 >= y1) continue;
    // window rows: apy = rr - (ay - y0s), as stamp_copy takes it
    const float ayw = ay - (float)b.y0s;
    T* base = chunk + b.xoff;
    const int total = nx * (y1 - y0);
    int r = lane / nx, c = lane - r * nx;
    const int dr = 32 / nx, dc = 32 - dr * nx;
    for (int i = lane; i < total; i += 32) {
      const int y = y0 + r, x = b.x0 + c;
      const int rr = y - b.wrow0;
      float apy;
      if (rr < p.win) {
        apy = (float)rr - ayw;
      } else {  // a tail band, in its own 16-row window
        const int band_row = rr & ~(kGran - 1);
        apy = (float)(rr - band_row) - (ay - (float)(b.y0s + band_row));
      }
      if (window_hit((float)x - ax, apy, abx, aby, inv, p)) {
        base[(y - cy0) * p.w + x] = One<T>::value;
      }
      c += dc;
      r += dr;
      if (c >= nx) {
        c -= nx;
        ++r;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masks_kernel(Params p, T* __restrict__ out, Plan q) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* buf = smem;
  int* rec_e = reinterpret_cast<int*>(smem + q.buf_bytes);
  int* rec_p = rec_e + p.kp;  // the records: kp entries each
  int* off = rec_p + p.kp;     // L + 1
  int* cur = off + p.L + 1;    // L
  int* part = cur + p.L;       // kWarps
  const int env = blockIdx.x;
  const bool env_live = p.counts[env] > 0;
  if (env_live) {
    for (int i = threadIdx.x; i < q.buf_bytes / 16; i += kThreads) {
      reinterpret_cast<uint4*>(buf)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    bucket(p, q, env, rec_e, rec_p, off, cur, part);
  }
  for (int it = 0; it < p.L * q.n_chunks; ++it) {
    const int l = it / q.n_chunks;
    const int cy0 = (it - l * q.n_chunks) * q.chunk_rows;
    const int cy1 = min(p.h, cy0 + q.chunk_rows);
    uint8_t* dst = reinterpret_cast<uint8_t*>(
        out + (((size_t)env * p.L + l) * p.h + cy0) * p.w);
    const long long bytes = (long long)(cy1 - cy0) * p.w * sizeof(T);
    const bool live = env_live && p.counts[(4 + l) * p.B + env] > 0;
    int jb = 0, je = 0, ub = 0, ue = 0;
    if (live) {
      jb = off[l];
      je = off[l + 1];
      ub = jb > 0 ? rec_p[jb - 1] : 0;
      ue = je > 0 ? rec_p[je - 1] : 0;
    }
    if (ub == ue) {  // nothing to stamp: zeros from registers
      fill_span(dst, 0, bytes, 0u, threadIdx.x, kThreads);
      continue;
    }
    // the chunk at dst's 16-byte phase, so the drain's vectors align
    uint8_t* chunk = buf + (reinterpret_cast<uintptr_t>(dst) & 15);
    stamp_units(p, q, env, rec_e, rec_p, jb, je, ub, ue, cy0, cy1,
                reinterpret_cast<T*>(chunk));
    __syncthreads();
    drain_span(dst, chunk, bytes, threadIdx.x, kThreads);
    __syncthreads();  // zeroed before the next item's stamps
  }
}

template <typename T>
int launch(const Params& p, T* out, cudaStream_t stream) {
  if ((long long)p.B * p.L * p.h * p.w == 0) return (int)cudaGetLastError();
  Plan q;
  const int row_bytes = p.w * (int)sizeof(T);
  int rows = p.h;
  if ((long long)rows * row_bytes > kChunkBytes) {
    rows = max(1, kChunkBytes / row_bytes);
    if (rows >= kGran) rows = rows / kGran * kGran;
  }
  q.chunk_rows = rows;
  q.n_chunks = (p.h + rows - 1) / rows;
  q.buf_bytes = (rows * row_bytes + 15) / 16 * 16 + 16;
  q.pad = sqrtf(p.lat2 > p.cap2 ? p.lat2 : p.cap2) + kBoxMargin;
  const size_t smem =
      q.buf_bytes + sizeof(int) * (2 * (size_t)p.kp + 2 * p.L + 1 + kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      masks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  masks_kernel<T><<<p.B, kThreads, smem, stream>>>(p, out, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tc_masks_launch(
    const int32_t* counts, const int32_t* idx, const float* ax,
    const float* ay, const float* abx, const float* aby, const float* inv,
    const int32_t* bw, void* out, int out_float, int B, int L, int h, int w,
    int kp, int le, int bres, float lat2, float cap2, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_float) return launch<float>(p, static_cast<float*>(out), s);
  return launch<uint8_t>(p, static_cast<uint8_t*>(out), s);
}
