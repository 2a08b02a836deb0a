// env_block.cuh -- the one-block-per-env skeleton that the masks (masks.cu,
// K1), rank (rank.cu, K3), exact (exact.cu, K4), env (env_soa.cu, K5),
// frame (frame_soa.cu, K6; its frames are one-layer envs) and segment
// (env_seg.cu, K7) kernels share, so that they cannot drift apart.
//
// One block of kEnvThreads threads per env walks the env's output in
// whole-width row chunks (`Chunks`: the whole frame where it fits
// kChunkBytes -- 128x160 uint8 -- else chunks of a multiple of 16 rows:
// 48 at 480x640 uint8 and at 128x160 float32), so a chunk is one
// contiguous range of the output; a chunk need not align with the
// bundle's bands. The block reads the env's live slots
// once and buckets their copies by layer in shared memory (`bucket`: a
// count, a prefix and a scatter), each copy with its number of work units,
// slabs of its box's rows; a prefix sum over the units (`block_scan`) lets
// the block's warps take a layer's units round robin (`stamp_units`; a
// binary search finds a unit's copy). A warp stamps its unit into a zeroed
// chunk buffer laid out at the destination's 16-byte phase, and the chunk
// leaves through store.cuh's 16-byte streaming stores (`drain_span`),
// which zero the buffer behind them; an item with no unit (an empty env or
// layer) is a register fill of zeros (`fill_span`) and uses no shared
// memory. `env_frames` is the chunk loop, in one of two shapes:
//   masks (B, L, h, w): items (layer, chunk), each layer's units stamped
//     with the value `one` (255, 1.0f or bfloat16's 1.0: `One`);
//   ranks (B, h, w) uint8: items (chunk), the layers' units stamped in
//     paint order, a barrier between two stamped layers, each store l + 1
//     -- cv2's order: the last store at a pixel is 1 + its highest layer,
//     with no atomics; a layer with no unit costs no barrier.
//
// A kernel gives its bundle's slots as a type S with
//   bool live(int env)           the env draws (counts[0, env] > 0);
//   int slots(int env)           the slots to read, s < slots(env);
//   void copies(int env, int s, F f)
//       f(l, c, word) for each copy of slot s that lies in a layer l of
//       [0, L): c its copy number (what the copy type reads it by), word
//       its band word ((frame*n_bands + b0) << 9 | nb, frame = l*nxb + xb;
//       a copy whose frame is past L*nxb, as in a bundle compacted at
//       another band height, is dropped: `word_layer`);
//   bool layer_live(int env, int l)
//       false where the bundle's per-layer counts say the layer draws
//       nothing (true where it has none: the empty bucket skips it);
// and its copies as a type C with
//   Units units(int env, int c, int word)
//       the work units of copy c of the env with band word `word`: n units
//       of `rows` frame rows each from row y0 (n = 0 when it lights
//       nothing);
//   void stamp(int env, int c, int uy, int rows, int cy0, int cy1,
//              T* chunk, T value)
//       by one whole warp: chunk[(y - cy0) * w + x] = value for every lit
//       pixel (y, x) of the unit of `rows` rows from row uy, with y in
//       [cy0, cy1) and x an output lane.
// Stores of one value are idempotent, so the warps of a layer need no
// ordering among themselves. The exact kernel's units have at most 32
// rows, one a lane, and `row_spans` walks the pixels of per-row spans
// with the warp's lanes on consecutive pixels, so that its stamp visits
// its rows' spans, not its whole box.
#pragma once

#include <cuda_bf16.h>

#include "stamp.cuh"
#include "store.cuh"

namespace tc {

constexpr int kEnvThreads = 128;
constexpr int kEnvWarps = kEnvThreads / 32;
// the largest chunk of output rows a block stages in shared memory
constexpr int kChunkBytes = 32768;
// pixels of a box a warp takes at a time
constexpr int kUnitPixels = 1024;
// the bundle's idx carries 7 pad slots after its k slots
constexpr int kPadSlots = 7;

// The output types of the masks and exact launches (`out_kind`; the
// wrappers' `_OUT_KINDS` in ops/rasterize_kernels.py).
enum OutKind { kOutUint8 = 0, kOutFloat32 = 1, kOutBfloat16 = 2 };

// A copy's work units: n slabs of `rows` frame rows from row y0.
struct Units {
  int n, y0, rows;
};

// The value a lit pixel of a mask stores: 255, 1.0f, or bfloat16's 1.0,
// set from its bits (0x3F80), with no conversion from float.
template <typename T> struct One;
template <> struct One<uint8_t> {
  static __device__ __forceinline__ uint8_t value() { return 255; }
};
template <> struct One<float> {
  static __device__ __forceinline__ float value() { return 1.f; }
};
template <> struct One<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 value() {
    return __ushort_as_bfloat16((unsigned short)0x3F80);
  }
};

// A launch's row chunks and bucket records.
struct Chunks {
  int rows, n;    // rows per chunk, chunks per frame
  int buf_bytes;  // the chunk buffer, with 16 bytes of slack for the phase
  int copies;     // the most copies an env's slots give
};

inline Chunks plan_chunks(const Geometry& g, int elem_bytes, int copies) {
  Chunks q;
  const int row_bytes = g.w * elem_bytes;
  int rows = g.h;
  if ((long long)rows * row_bytes > kChunkBytes) {
    rows = kChunkBytes / row_bytes > 1 ? kChunkBytes / row_bytes : 1;
    if (rows >= kGran) rows = rows / kGran * kGran;
  }
  q.rows = rows;
  q.n = (g.h + rows - 1) / rows;
  q.buf_bytes = (rows * row_bytes + 15) / 16 * 16 + 16;
  q.copies = copies;
  return q;
}

// Dynamic shared memory of `env_frames`: the chunk buffer, then the
// buckets' records (q.copies entries each of three arrays), the layer
// offsets and counters and the scan's per-warp sums.
inline size_t env_smem(const Chunks& q, const Geometry& g) {
  return q.buf_bytes +
         sizeof(int) * (3 * (size_t)q.copies + 2 * g.L + 1 + kEnvWarps);
}

struct EnvShared {
  uint8_t* buf;
  int* rec_e;  // the bucketed copies' numbers, layer l's [off[l], off[l+1])
  int* rec_p;  // the running total of their units (inclusive)
  int* rec_y;  // their units' first row y0 | rows per unit << 16
  int* off;    // L + 1
  int* cur;    // L
  int* part;   // kEnvWarps
};

__device__ __forceinline__ EnvShared carve(uint8_t* smem, const Chunks& q,
                                           const Geometry& g) {
  EnvShared s;
  s.buf = smem;
  s.rec_e = reinterpret_cast<int*>(smem + q.buf_bytes);
  s.rec_p = s.rec_e + q.copies;
  s.rec_y = s.rec_p + q.copies;
  s.off = s.rec_y + q.copies;
  s.cur = s.off + g.L + 1;
  s.part = s.cur + g.L;
  return s;
}

// The layer of a live band word, or -1.
__device__ __forceinline__ int word_layer(const Geometry& g, int word) {
  if (!word_live(word) || word < 0) return -1;
  const int l = word_frame(word, g) / g.nxb;
  return l < g.L ? l : -1;
}

// In-place inclusive prefix sum of a[0, m) by the block; ends with a
// barrier.
__device__ void block_scan(int* a, int m, int* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += kEnvThreads) {
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
      int s = lane < kEnvWarps ? part[lane] : 0;
#pragma unroll
      for (int d = 1; d < kEnvWarps; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      if (lane < kEnvWarps) part[lane] = s;
    }
    __syncthreads();
    v += carry + (warp > 0 ? part[warp - 1] : 0);
    if (i < m) a[i] = v;
    carry += part[kEnvWarps - 1];
    __syncthreads();
  }
}

// Env `env`'s live copies (sl.copies) bucketed by layer, each with its
// units (c.units). Called by the whole block; ends with a barrier.
template <typename S, typename C>
__device__ void bucket(const S& sl, const C& c, const Geometry& g, int env,
                       const EnvShared& sh) {
  const int n = sl.slots(env);
  for (int l = threadIdx.x; l < g.L; l += kEnvThreads) sh.cur[l] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += kEnvThreads) {
    sl.copies(env, s, [&](int l, int, int) { atomicAdd(&sh.cur[l], 1); });
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int l = 0; l < g.L; ++l) {
      sh.off[l] = acc;
      acc += sh.cur[l];
      sh.cur[l] = sh.off[l];
    }
    sh.off[g.L] = acc;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += kEnvThreads) {
    sl.copies(env, s, [&](int l, int e, int word) {
      const int pos = atomicAdd(&sh.cur[l], 1);
      const Units u = c.units(env, e, word);
      sh.rec_e[pos] = e;
      sh.rec_p[pos] = u.n;
      sh.rec_y[pos] = u.y0 | (u.rows << 16);
    });
  }
  __syncthreads();
  block_scan(sh.rec_p, sh.off[g.L], sh.part);
}

// Stamp the work units [ub, ue) of the records [jb, je) into the chunk of
// frame rows [cy0, cy1), each warp a unit at a time; where a frame has
// more than one chunk (`chunked`), a unit whose rows miss the chunk is
// skipped.
template <typename T, typename C>
__device__ void stamp_units(const C& c, const Geometry& g, int env,
                            const EnvShared& sh, int jb, int je, int ub,
                            int ue, bool chunked, int cy0, int cy1, T* chunk,
                            T value) {
  const int warp = threadIdx.x >> 5;
  for (int u = ub + warp; u < ue; u += kEnvWarps) {
    // the unit's copy: the first record whose running total exceeds u
    int lo = jb, hi = je - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sh.rec_p[mid] > u) hi = mid; else lo = mid + 1;
    }
    const int first = lo > 0 ? sh.rec_p[lo - 1] : 0;
    const int ry = sh.rec_y[lo], rows = ry >> 16;
    const int y = (ry & 0xFFFF) + (u - first) * rows;
    if (chunked && (y >= cy1 || y + rows <= cy0)) continue;
    c.stamp(env, sh.rec_e[lo], y, rows, cy0, cy1, chunk, value);
  }
}

// The rows that `row_spans` takes: at most 32, one a lane.
constexpr int kUnitRows = 32;
constexpr unsigned kAllLanes = 0xffffffffu;

// By a whole warp: f(active, r, j) for every pixel j in [0, n_r) of every
// lane r's span of n_r pixels, the warp's lanes on consecutive (r, j)
// pairs (an exclusive scan of the counts, then a binary search of each
// pair's lane by shuffles). Every lane calls f the same number of times,
// so f may shuffle; `active` is false for a lane past the last pixel.
template <typename F>
__device__ __forceinline__ void row_spans(int n, F f) {
  const int lane = threadIdx.x & 31;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, incl, d);
    if (lane >= d) incl += y;
  }
  const int excl = incl - n;
  const int total = __shfl_sync(kAllLanes, incl, 31);
  for (int i0 = 0; i0 < total; i0 += 32) {
    const int i = i0 + lane;
    // the last lane whose span starts at or before pixel i
    int r = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      if (__shfl_sync(kAllLanes, excl, r + s) <= i) r += s;
    }
    f(i < total, r, i - __shfl_sync(kAllLanes, excl, r));
  }
}

// The block's env (blockIdx.x): masks, or with kRank ranks, as the header
// says, of slots `sl` and copies `c`. `smem` holds env_smem(q, g) bytes.
template <bool kRank, typename S, typename C, typename T>
__device__ __forceinline__ void env_frames(const S& sl, const C& c,
                                           const Geometry& g, T* out,
                                           const Chunks& q, T one,
                                           uint8_t* smem) {
  const EnvShared sh = carve(smem, q, g);
  const int env = blockIdx.x;
  const bool env_live = sl.live(env);
  if (env_live) {
    for (int i = threadIdx.x; i < q.buf_bytes / 16; i += kEnvThreads) {
      reinterpret_cast<uint4*>(sh.buf)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    bucket(sl, c, g, env, sh);
  }
  const int frames = kRank ? 1 : g.L;
  for (int it = 0; it < frames * q.n; ++it) {
    const int f = it / q.n;
    const int cy0 = (it - f * q.n) * q.rows;
    const int cy1 = min(g.h, cy0 + q.rows);
    uint8_t* dst = reinterpret_cast<uint8_t*>(
        out + (((size_t)env * frames + f) * g.h + cy0) * g.w);
    const long long bytes = (long long)(cy1 - cy0) * g.w * sizeof(T);
    // the chunk at dst's 16-byte phase, so the drain's vectors align
    T* chunk = reinterpret_cast<T*>(sh.buf +
                                    (reinterpret_cast<uintptr_t>(dst) & 15));
    // the layers of this item: all of them, in paint order, for ranks
    const int l0 = kRank ? 0 : f, l1 = kRank ? g.L : f + 1;
    bool stamped = false;  // the same in every thread: shared values only
    for (int l = l0; l < l1; ++l) {
      if (!env_live || !sl.layer_live(env, l)) continue;
      const int jb = sh.off[l], je = sh.off[l + 1];
      const int ub = jb > 0 ? sh.rec_p[jb - 1] : 0;
      const int ue = je > 0 ? sh.rec_p[je - 1] : 0;
      if (ub == ue) continue;
      if (kRank && stamped) __syncthreads();  // the lower layer lands first
      T value = one;
      if constexpr (kRank) value = (T)(l + 1);
      stamp_units(c, g, env, sh, jb, je, ub, ue, q.n > 1, cy0, cy1, chunk,
                  value);
      stamped = true;
    }
    if (!stamped) {  // nothing to stamp: zeros from registers
      fill_span(dst, 0, bytes, 0u, threadIdx.x, kEnvThreads);
      continue;
    }
    __syncthreads();
    drain_span(dst, reinterpret_cast<uint8_t*>(chunk), bytes, threadIdx.x,
               kEnvThreads);
    __syncthreads();  // zeroed before the next item's stamps
  }
}

// The slots of the production bundles (`compact_env_idx_soa`, K1 and K3;
// `compact_env_exact_soa`, K4): counts (4+L, B) rows [live, one-band,
// short, dropped, per-layer...], idx (B, kp) slot -> copy on the (B, le)
// copy axis, its last kPadSlots slots the TPU's loop padding, and a band
// word per copy in `bw`. A copy's number is its place on the copy axis.
struct IdxSlots {
  const Geometry& g;
  const int32_t* counts;
  const int32_t* idx;
  const int32_t* bw;

  __device__ __forceinline__ bool live(int env) const {
    return counts[env] > 0;
  }
  __device__ __forceinline__ int slots(int env) const {
    return min(counts[env], max(g.kp - kPadSlots, 0));
  }
  template <typename F>
  __device__ __forceinline__ void copies(int env, int s, F f) const {
    const int e = idx[(size_t)env * g.kp + s];
    const int word = bw[(size_t)env * g.le + e];
    const int l = word_layer(g, word);
    if (l >= 0) f(l, e, word);
  }
  __device__ __forceinline__ bool layer_live(int env, int l) const {
    return counts[(4 + l) * g.B + env] > 0;
  }
};

// The slots of the older SoA bundles (`compact_env_soa`, K5; and
// `compact_soa`, K6, whose (B, L) frames are B*L one-layer envs): slot s
// of an env is copy s, entry env*le + s of the SoA arrays (le = k),
// counts (3, B) with no per-layer rows.
struct DirectSlots {
  const Geometry& g;
  const int32_t* counts;
  const int32_t* bw;

  __device__ __forceinline__ bool live(int env) const {
    return counts[env] > 0;
  }
  __device__ __forceinline__ int slots(int env) const {
    return min(counts[env], g.le);
  }
  template <typename F>
  __device__ __forceinline__ void copies(int env, int s, F f) const {
    const int word = bw[(size_t)env * g.le + s];
    const int l = word_layer(g, word);
    if (l >= 0) f(l, s, word);
  }
  __device__ __forceinline__ bool layer_live(int, int) const { return true; }
};

// The fast stroke's copies at `Gran`-row bands (masks.cu, rank.cu at 16;
// env_soa.cu, frame_soa.cu, env_seg.cu at 8 or 16): each copy's box
// (stamp.cuh `copy_box`, padded by `pad`: the stroke's reach +
// kBoxMargin) cut into units of about kUnitPixels pixels, walked with
// lanes on neighbouring columns, stepping (row, column) without a
// division; each pixel is tested with `window_hit` on the plain version's
// apx / apy floats (integer valued, exact). The pixel row is
// window-relative, a tail band in its own Gran-row window (`_tier_loops`,
// `_tier_loops_seg`), or with `Absolute` the stacked strip row minus ay
// (`_kernel_env`, `_kernel`): the two give the same bits. Copy c of an
// env is entry env*le + c of the SoA arrays; `box_units` and `stamp_copy`
// take a copy's payload as given, for bundles whose copies are not
// entries (env_seg.cu).
template <int Gran = kGran, bool Absolute = false>
struct FastCopies {
  const Params& p;
  float pad;

  __device__ __forceinline__ Units box_units(int word, float ax, float ay,
                                             float abx, float aby) const {
    const CopyBox b = copy_box<Gran>(p, word, ax, ay, abx, aby, pad);
    const int nx = b.x1 - b.x0, ny = b.y1 - b.y0;
    if (nx <= 0 || ny <= 0) return {0, 0, 1};
    const int rows = max(1, kUnitPixels / nx);
    return {(ny + rows - 1) / rows, b.y0, rows};
  }

  __device__ __forceinline__ Units units(int env, int c, int word) const {
    const size_t o = (size_t)env * p.le + c;
    return box_units(word, p.ax[o], p.ay[o], p.abx[o], p.aby[o]);
  }

  template <typename T>
  __device__ __forceinline__ void stamp_copy(int word, float ax, float ay,
                                             float abx, float aby, float inv,
                                             int uy, int rows, int cy0,
                                             int cy1, T* chunk,
                                             T value) const {
    const int lane = threadIdx.x & 31;
    const CopyBox b = copy_box<Gran>(p, word, ax, ay, abx, aby, pad);
    const int nx = b.x1 - b.x0;
    const int y0 = max(uy, cy0);
    const int y1 = min(min(b.y1, uy + rows), cy1);
    if (y0 >= y1) return;
    // window rows: apy = rr - (ay - y0s); a tail band in its own window
    const float ayw = ay - (float)b.y0s;
    T* base = chunk + b.xoff;
    const int total = nx * (y1 - y0);
    int r = lane / nx, c = lane - r * nx;
    const int dr = 32 / nx, dc = 32 - dr * nx;
    for (int i = lane; i < total; i += 32) {
      const int y = y0 + r, x = b.x0 + c;
      const int rr = y - b.wrow0;
      float apy;
      if (Absolute) {  // the stacked strip row y0s + rr, minus ay
        apy = ((float)rr + (float)b.y0s) - ay;
      } else if (rr < p.win) {
        apy = (float)rr - ayw;
      } else {  // a tail band, in its own Gran-row window
        const int band_row = rr & ~(Gran - 1);
        apy = (float)(rr - band_row) - (ay - (float)(b.y0s + band_row));
      }
      if (window_hit((float)x - ax, apy, abx, aby, inv, p)) {
        base[(y - cy0) * p.w + x] = value;
      }
      c += dc;
      r += dr;
      if (c >= nx) {
        c -= nx;
        ++r;
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void stamp(int env, int c, int uy, int rows,
                                        int cy0, int cy1, T* chunk,
                                        T value) const {
    const size_t o = (size_t)env * p.le + c;
    stamp_copy(p.bw[o], p.ax[o], p.ay[o], p.abx[o], p.aby[o], p.inv[o], uy,
               rows, cy0, cy1, chunk, value);
  }
};

// The boxes' padding of the fast stroke: its reach + kBoxMargin.
inline float fast_pad(const Params& p) {
  return sqrtf(p.lat2 > p.cap2 ? p.lat2 : p.cap2) + kBoxMargin;
}

// The uint8 masks of a bundle whose slot s is copy s (`DirectSlots`), with
// absolute pixel rows (`_kernel_env`, `_kernel`) at Gran-row bands:
// env_soa.cu's `compact_env_soa` envs (K5) and frame_soa.cu's
// `compact_soa` frames as one-layer envs (K6), one block each.
template <int Gran>
__global__ void __launch_bounds__(kEnvThreads)
direct_soa_kernel(Params p, uint8_t* __restrict__ out, Chunks q, float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  env_frames<false>(DirectSlots{p, p.counts, p.bw},
                    FastCopies<Gran, true>{p, pad}, p, out, q,
                    One<uint8_t>::value(), smem);
}

// Launches `direct_soa_kernel<Gran>` over p.B blocks. Returns the CUDA
// error.
template <int Gran>
int launch_direct_soa(const Params& p, uint8_t* out, cudaStream_t stream) {
  if ((long long)p.B * p.L * p.h * p.w == 0) return (int)cudaGetLastError();
  const Chunks q = plan_chunks(p, 1, p.le);
  const size_t smem = env_smem(q, p);
  cudaError_t err = cudaFuncSetAttribute(
      direct_soa_kernel<Gran>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  direct_soa_kernel<Gran><<<p.B, kEnvThreads, smem, stream>>>(p, out, q,
                                                              fast_pad(p));
  return (int)cudaGetLastError();
}

}  // namespace tc
