// exact.cu -- cv2's ThickLine class masks (stroke "exact", t >= 2) from the
// exact compaction bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, ExactKernel).
//
// Replaces the Pallas kernel tinycarlo_tpu/ops/rasterize_pallas.py
// `_kernel_env_exact` (:2904), which runs `_tier_loops_exact` (:2796) over
// the bundle of `compact_env_exact_soa` (:2569). The JAX package renders
// `camera.stroke: exact` with it: the bit-exact replica of cv2.polylines'
// thick stroke (tinycarlo_tpu/ops/cv2_stroke.py), which lets a policy
// trained on the reference's cv2 frames see the same frames here.
//
// Function. For the bundle of `compact_env_exact_soa` (counts, idx and 30
// int32 fields per copy; band words and the window walk in stamp.cuh),
// pixel (env, l, y, x) is lit iff some live slot s < counts[0, env] whose
// band word decodes to frame l*nxb + x/128 lights it -- at stacked strip
// row yi = frame*hp + y and block-local lane xi = x - 128*(x/128), within
// the copy's window rows (2 bands, then a tall copy's tail bands) -- by
//   - the fill span: flags&1, ymin <= yi <= ystop, lo <= xi <= hi, lo and
//     hi the rounded min / max of the two chains' fixed-point x at yi;
//   - or an accepted ring edge's Line2 DDA pixel (0 <= k < n, the minor
//     coordinate (v0 + k*st) >> 16) or its normalized-far dot;
//   - or a cap row: |xi - cx| <= the cap table's half-width at |yi - cy|.
// All fields arrive shifted into block-local lanes / stacked strip rows.
// uint8 output is 0/255, float32 and bfloat16 0/1; the Pallas kernel
// stores 255 into its float scratch and emits 0/255 for a float output
// (ROADMAP F0), which this kernel does not copy. Dead layers and envs with
// no live slot are written as zeros.
//
// Arithmetic. int32 throughout, as the plain version's torch int32 ops:
// the products and sums that can leave the int32 range on pixels outside
// a stamp's span wrap (two's complement, done in unsigned arithmetic here
// so the wrap is defined), and `>>` is arithmetic. So the kernel equals
// `rasterize_masks_exact_env_plain` bit for bit by construction.
//
// Design. The one-block-per-env skeleton of env_block.cuh, shared with
// masks.cu, rank.cu, env_soa.cu and env_seg.cu: one block of 128 threads
// per env buckets the env's live copies by layer once and walks the items
// (layer, row chunk)
// -- the whole 128x160 uint8 frame, 48-row chunks at 480x640 and for
// float32 -- stamping into a chunk buffer in shared memory that leaves
// through store.cuh's 16-byte streaming stores. A copy's box
// (`ExactCopies::box`) is the bounding box of its two cap centres (fields
// 22/23), padded by the stroke's extent (cv2_stroke.stroke_y_extent, t/2
// + 2, taken at the cap radius (t + 1) // 2 >= t/2, which the cap table
// gives: equal at even t) plus kBoxMargin, and clipped as masks.cu's
// boxes are (stamp.cuh `copy_box`; rasterize_kernels.exact_copy_box is
// the same rule, and tests/test_torch_exact_box.py checks that no lit
// pixel of the plain version falls outside it). Its rows are cut into
// units of up to 32 rows. A warp takes a unit: lane i loads field i of
// the copy and shuffles broadcast the 30 fields; then lane r works out
// what depends only on row r -- the fill span lo..hi from the two
// chains, each cap's span from its half-width, each y-major ring edge's
// one pixel and each far dot's row -- and stores the single pixels; the
// x-major ring edges light one pixel a column, which lane c computes and
// stores; and the warp paints the rows' three spans with its lanes on
// consecutive pixels (env_block.cuh `row_spans`). So no dark pixel of a
// box is visited. The int32 wrap arithmetic and `>>` are those of the
// per-pixel predicate, operation for operation, and the stamp paints
// exactly the pixels at which the predicate holds, so the masks stay
// bit-equal. A unit's stores all write one value, so they need no order.
//
// Bound on the H100 at the bench shape (B=4096, L=5, 128x160, nxb=2,
// LE=528, kp=263, t=2). Bytes: the uint8 output, 419 MB, written once, plus
// the counts, the live slots' idx entries and their copies' 30 fields,
// ~120 B a copy -- ~0.13 ms at 3.35 TB/s. Operations: the int32 work of
// the stamp over each live copy's segment bounding box, padded by the
// stroke's extent, each operation counted once per box row, per box
// column or per copy, where it depends (a lit pixel of the fill, a cap, a
// y-major edge or a far dot follows from its row's values, one of an
// x-major edge from its column's) -- far under the bytes' time at
// Hopper's int32 rate (64 lanes per SM per clock, half its float32
// lanes). chip_smoke.py computes both from each run's bundle
// (EXACT_ROW_OPS, EXACT_COLUMN_OPS, EXACT_COPY_OPS) and says which binds.
// The design writes each output byte once, 16 bytes a store, evaluates
// row-only work once per row and visits only the pixels it lights (and
// the x-major edges' columns).
#include "env_block.cuh"

namespace {

using namespace tc;

constexpr int kFields = 30;  // rasterize_kernels.EXACT_FIELDS
constexpr int kMaxCap = 64;  // rasterize_kernels._MAX_CAP
constexpr int kXBias = 4096; // rasterize_kernels._XBIAS
// a span of no lane: lo 0xFFFF, hi 0
constexpr int kEmptySpan = 0xFFFF;

struct ExactParams : Geometry {
  const int32_t* counts;         // (4 + L, B)
  const int32_t* idx;            // (B, kp)
  const int32_t* f[kFields];     // (B, le) each; f[29] is the band word
  int ncap;                      // cap table entries
  int cap[kMaxCap];              // half-width per |row offset| of the cap
  float pad;                     // the boxes' padding
};

// One copy's fields, unpacked.
struct Slot {
  int ymin, ystop, brka, brkb;
  int xs1a, dx1a, xs2a, dx2a, xs1b, dx1b, xs2b, dx2b;
  int m0[4], n[4], v0[4], st[4], fdx[4], fdy[4];
  int cx[2], cy[2];
  int flags, word;
};

__device__ __forceinline__ int lo16(int p) { return (p & 0xFFFF) - kXBias; }
__device__ __forceinline__ int hi16(int p) { return (p >> 16) - kXBias; }

// int32 arithmetic that wraps as torch's int32 tensors do
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// The copy's fields, field i read as fld(i).
template <typename Get>
__device__ __forceinline__ Slot decode(Get fld) {
  Slot s;
  int v = fld(0);
  s.ymin = lo16(v);
  s.ystop = hi16(v);
  v = fld(1);
  s.brka = lo16(v);
  s.brkb = hi16(v);
  s.xs1a = fld(2);
  s.dx1a = fld(3);
  s.xs2a = fld(4);
  s.dx2a = fld(5);
  s.xs1b = fld(6);
  s.dx1b = fld(7);
  s.xs2b = fld(8);
  s.dx2b = fld(9);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v = fld(10 + i);
    s.m0[i] = lo16(v);
    s.n[i] = hi16(v);
    s.v0[i] = fld(14 + i);
    s.st[i] = fld(18 + i);
    v = fld(24 + i);
    s.fdx[i] = lo16(v);
    s.fdy[i] = hi16(v);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    v = fld(22 + c);
    s.cx[c] = lo16(v);
    s.cy[c] = hi16(v);
  }
  s.flags = fld(28);
  s.word = fld(29);
  return s;
}

// Lanes [lo, hi] within the box's [x0, x1), packed lo | hi << 16, or
// kEmptySpan.
__device__ __forceinline__ int span(int lo, int hi, const CopyBox& b) {
  lo = max(lo, b.x0);
  hi = min(hi, b.x1 - 1);
  return lo <= hi ? lo | (hi << 16) : kEmptySpan;
}
__device__ __forceinline__ int span_len(int sp) {
  return max((sp >> 16) - (sp & 0xFFFF) + 1, 0);
}

// The exact compaction's copies: `_tier_loops_exact`'s stamp
// (rasterize_pallas.py:2818-2861) over each copy's box. At stacked strip
// row yi and block-local lane xi a live copy lights
//   - the fill span: flags&1, ymin <= yi <= ystop, lo <= xi <= hi;
//   - accepted ring edge i's DDA pixel: 0 <= k < n and the minor
//     coordinate (v0 + k*st) >> 16, k counted along the major axis from
//     m0 -- one pixel a column (x-major) or a row (y-major) -- or its far
//     dot (fdx, fdy);
//   - a cap row: |xi - cx| <= the cap table's half-width at |yi - cy|.
struct ExactCopies {
  const ExactParams& p;
  const int32_t* const* f;  // the fields' pointers, in shared memory
  const int* cap;           // the cap table, in shared memory

  // The box of a copy with band word `word` and cap centres (cx0, cy0),
  // (cx1, cy1) (block-local lanes, stacked strip rows): copy_box of the
  // segment between them (integer-valued floats, exact), padded by p.pad.
  __device__ __forceinline__ CopyBox box(int word, int cx0, int cy0,
                                         int cx1, int cy1) const {
    return copy_box(p, word, (float)cx0, (float)cy0, (float)(cx1 - cx0),
                    (float)(cy1 - cy0), p.pad);
  }

  __device__ __forceinline__ Units units(int env, int e, int word) const {
    const size_t o = (size_t)env * p.le + e;
    const int c0 = f[22][o], c1 = f[23][o];
    const CopyBox b = box(word, lo16(c0), hi16(c0), lo16(c1), hi16(c1));
    const int nx = b.x1 - b.x0, ny = b.y1 - b.y0;
    if (nx <= 0 || ny <= 0) return {0, 0, kUnitRows};
    return {(ny + kUnitRows - 1) / kUnitRows, b.y0, kUnitRows};
  }

  template <typename T>
  __device__ __forceinline__ void stamp(int env, int e, int uy, int rows,
                                        int cy0, int cy1, T* chunk,
                                        T value) const {
    const size_t o = (size_t)env * p.le + e;
    const int lane = threadIdx.x & 31;
    // field i in lane i, broadcast
    const int mine = lane < kFields ? f[lane][o] : 0;
    const Slot s =
        decode([&](int i) { return __shfl_sync(kAllLanes, mine, i); });
    const CopyBox b = box(s.word, s.cx[0], s.cy[0], s.cx[1], s.cy[1]);
    const int nx = b.x1 - b.x0;
    const int y0 = max(uy, cy0);
    const int y1 = min(min(b.y1, uy + rows), cy1);
    if (y0 >= y1) return;
    const int yoff = b.y0s - b.wrow0;  // the frame's first stacked row
    T* base = chunk + b.xoff;
    const int w = p.w;
    auto at = [&](int y, int x) { base[(y - cy0) * w + x] = value; };

    // Lane r: row y0 + r (a unit has at most 32 rows). Its fill span, from
    // the chains at the row, and its two cap spans.
    const int y = y0 + lane, yi = y + yoff;
    const bool row = y < y1;
    int fill = kEmptySpan;
    if ((s.flags & 1) && yi >= s.ymin && yi <= s.ystop) {
      const int ya = wsub(yi, s.ymin);
      const int x_a = yi < s.brka
                          ? wadd(s.xs1a, wmul(s.dx1a, ya))
                          : wadd(s.xs2a, wmul(s.dx2a, wsub(yi, s.brka)));
      const int x_b = yi < s.brkb
                          ? wadd(s.xs1b, wmul(s.dx1b, ya))
                          : wadd(s.xs2b, wmul(s.dx2b, wsub(yi, s.brkb)));
      fill = span(wadd(min(x_a, x_b), 1 << 15) >> 16,
                  wadd(max(x_a, x_b), 1 << 15) >> 16, b);
    }
    int caps[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = abs(yi - s.cy[c]);
      const int hw = m < p.ncap ? cap[m] : -1;
      caps[c] = span(s.cx[c] - hw, s.cx[c] + hw, b);
    }
    // The accepted ring edges (the flags are the warp's: no divergence).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!((s.flags >> (1 + i)) & 1)) continue;
      const int fdx = s.fdx[i];
      if (row && yi == s.fdy[i] && fdx >= b.x0 && fdx < b.x1) at(y, fdx);
      if ((s.flags >> (5 + i)) & 1) {  // x-major: a pixel a column
        for (int c = lane; c < nx; c += 32) {
          const int xi = b.x0 + c;
          const int k = wsub(xi, s.m0[i]);
          const int val = wadd(s.v0[i], wmul(k, s.st[i])) >> 16;
          if (k >= 0 && k < s.n[i] && val >= y0 + yoff && val < y1 + yoff) {
            at(val - yoff, xi);
          }
        }
      } else if (row) {  // y-major: a pixel a row
        const int k = wsub(yi, s.m0[i]);
        const int val = wadd(s.v0[i], wmul(k, s.st[i])) >> 16;
        if (k >= 0 && k < s.n[i] && val >= b.x0 && val < b.x1) at(y, val);
      }
    }
    // The spans' pixels, painted: the warp's lanes on consecutive pixels
    // of the rows' fill and cap spans.
    const int n = row ? span_len(fill) + span_len(caps[0]) +
                            span_len(caps[1])
                      : 0;
    row_spans(n, [&](bool active, int r, int j) {
      const int sf = __shfl_sync(kAllLanes, fill, r);
      const int s0 = __shfl_sync(kAllLanes, caps[0], r);
      const int s1 = __shfl_sync(kAllLanes, caps[1], r);
      int sp = sf;
      if (j >= span_len(sf)) {
        j -= span_len(sf);
        sp = s0;
        if (j >= span_len(s0)) {
          j -= span_len(s0);
          sp = s1;
        }
      }
      if (active) at(y0 + r, (sp & 0xFFFF) + j);
    });
  }
};

template <typename T>
__global__ void __launch_bounds__(kEnvThreads)
exact_kernel(ExactParams p, T* __restrict__ out, Chunks q) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ const int32_t* fields[kFields];
  __shared__ int cap[kMaxCap];
  for (int i = threadIdx.x; i < kFields; i += kEnvThreads) fields[i] = p.f[i];
  for (int i = threadIdx.x; i < kMaxCap; i += kEnvThreads) cap[i] = p.cap[i];
  __syncthreads();
  env_frames<false>(IdxSlots{p, p.counts, p.idx, p.f[kFields - 1]},
                    ExactCopies{p, fields, cap}, p, out, q, One<T>::value(),
                    smem);
}

template <typename T>
int launch(const ExactParams& p, T* out, cudaStream_t stream) {
  if ((long long)p.B * p.L * p.h * p.w == 0) return (int)cudaGetLastError();
  const Chunks q = plan_chunks(p, (int)sizeof(T), p.kp);
  const size_t smem = env_smem(q, p);
  cudaError_t err = cudaFuncSetAttribute(
      exact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  exact_kernel<T><<<p.B, kEnvThreads, smem, stream>>>(p, out, q);
  return (int)cudaGetLastError();
}

}  // namespace

// `fields` and `cap` are host arrays: the 30 device pointers of the
// bundle's fields, and the cap table's `ncap` half-widths.
extern "C" int tc_exact_launch(
    const int32_t* counts, const int32_t* idx, const int32_t* const* fields,
    void* out, int out_kind, int B, int L, int h, int w, int kp, int le,
    const int32_t* cap, int ncap, void* stream) {
  if (ncap < 1 || ncap > kMaxCap) return (int)cudaErrorInvalidValue;
  ExactParams p;
  tc::set_geometry(p, B, L, h, w, kp, le);
  p.counts = counts;
  p.idx = idx;
  for (int i = 0; i < kFields; ++i) p.f[i] = fields[i];
  p.ncap = ncap;
  for (int i = 0; i < kMaxCap; ++i) p.cap[i] = i < ncap ? cap[i] : -1;
  // the stroke's extent at the cap radius, ncap - 1, plus the margin
  p.pad = (float)(ncap - 1) + 2.f + kBoxMargin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case tc::kOutUint8:
      return launch<uint8_t>(p, static_cast<uint8_t*>(out), s);
    case tc::kOutFloat32:
      return launch<float>(p, static_cast<float*>(out), s);
    case tc::kOutBfloat16:
      return launch<__nv_bfloat16>(p, static_cast<__nv_bfloat16*>(out), s);
  }
  return (int)cudaErrorInvalidValue;
}
