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
// uint8 output is 0/255 and float32 0/1; the Pallas kernel stores 255 into
// its float scratch and emits 0/255 for a float output (ROADMAP F0), which
// this kernel does not copy. Dead layers and envs with no live slot are
// written as zeros.
//
// Arithmetic. int32 throughout, as the plain version's torch int32 ops:
// the products and sums that can leave the int32 range on pixels outside
// a stamp's span wrap (two's complement, done in unsigned arithmetic here
// so the wrap is defined), and `>>` is arithmetic. So the kernel equals
// `rasterize_masks_exact_env_plain` bit for bit by construction.
//
// Design. The block structure of masks.cu, through the same stamp.cuh
// `masks_frame`: one block per (env, frame), a uint8 [hp][wb] strip in
// shared memory, the env's slots of this frame listed in shared memory,
// stores of 1 (idempotent: no atomics). Each listed copy's 30 fields are
// decoded once -- up to kStage copies at a time, one thread per copy --
// into a shared `Slot` that all threads read (a broadcast), then every
// thread evaluates the predicate on its pixels of the copy's window.
//
// Bound on the H100 at the bench shape (B=4096, L=5, 128x160, nxb=2,
// LE=528, kp=263, t=2). Bytes: the uint8 output, 419 MB, written once, plus
// the counts, the live slots' idx entries and their copies' 30 fields,
// ~120 B a copy -- ~0.13 ms at 3.35 TB/s. Operations: the int32 work of
// the predicate over each live copy's segment bounding box, padded by the
// stroke's extent, each operation counted once per pixel, per box row or
// per copy, where it depends (~50 per pixel for a filled copy with four
// accepted edges) -- at Hopper's int32 rate (64 lanes per SM per clock,
// half its float32 lanes) a little under the bytes' time. chip_smoke.py
// computes both from each run's bundle (EXACT_PIXEL_OPS, EXACT_ROW_OPS,
// EXACT_COPY_OPS) and says which binds. The design evaluates whole windows,
// ~17x the bounding boxes' pixels, and recomputes each row's span per
// pixel: computing spans once per row, shrinking windows to the segment's
// extent and keeping blocks resident across envs are later work.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;
constexpr int kFields = 30;  // rasterize_kernels.EXACT_FIELDS
constexpr int kStage = 64;   // copies decoded into shared memory at a time
constexpr int kMaxCap = 64;  // rasterize_kernels._MAX_CAP
constexpr int kXBias = 4096; // rasterize_kernels._XBIAS

struct ExactParams : Geometry {
  const int32_t* counts;         // (4 + L, B)
  const int32_t* idx;            // (B, kp)
  const int32_t* f[kFields];     // (B, le) each; f[29] is the band word
  int ncap;                      // cap table entries
  int cap[kMaxCap];              // half-width per |row offset| of the cap
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

__device__ void decode(const ExactParams& p, size_t o, Slot& s) {
  int v = p.f[0][o];
  s.ymin = lo16(v);
  s.ystop = hi16(v);
  v = p.f[1][o];
  s.brka = lo16(v);
  s.brkb = hi16(v);
  s.xs1a = p.f[2][o];
  s.dx1a = p.f[3][o];
  s.xs2a = p.f[4][o];
  s.dx2a = p.f[5][o];
  s.xs1b = p.f[6][o];
  s.dx1b = p.f[7][o];
  s.xs2b = p.f[8][o];
  s.dx2b = p.f[9][o];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v = p.f[10 + i][o];
    s.m0[i] = lo16(v);
    s.n[i] = hi16(v);
    s.v0[i] = p.f[14 + i][o];
    s.st[i] = p.f[18 + i][o];
    v = p.f[24 + i][o];
    s.fdx[i] = lo16(v);
    s.fdy[i] = hi16(v);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    v = p.f[22 + c][o];
    s.cx[c] = lo16(v);
    s.cy[c] = hi16(v);
  }
  s.flags = p.f[28][o];
  s.word = p.f[29][o];
}

// `_tier_loops_exact`'s stamp (rasterize_pallas.py:2818-2861) at stacked
// strip row yi and block-local lane xi, for a live copy.
__device__ __forceinline__ bool exact_hit(const Slot& s, const int* cap,
                                          int ncap, int xi, int yi) {
  const int ya = wsub(yi, s.ymin);
  const int x_a = yi < s.brka ? wadd(s.xs1a, wmul(s.dx1a, ya))
                              : wadd(s.xs2a, wmul(s.dx2a, wsub(yi, s.brka)));
  const int x_b = yi < s.brkb ? wadd(s.xs1b, wmul(s.dx1b, ya))
                              : wadd(s.xs2b, wmul(s.dx2b, wsub(yi, s.brkb)));
  const int lo = wadd(min(x_a, x_b), 1 << 15) >> 16;
  const int hi = wadd(max(x_a, x_b), 1 << 15) >> 16;
  bool hit = (s.flags & 1) && yi >= s.ymin && yi <= s.ystop && xi >= lo &&
             xi <= hi;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool acc = (s.flags >> (1 + i)) & 1;
    const bool xmaj = (s.flags >> (5 + i)) & 1;
    const int k = wsub(xmaj ? xi : yi, s.m0[i]);
    const int mino = xmaj ? yi : xi;
    const int val = wadd(s.v0[i], wmul(k, s.st[i])) >> 16;
    hit = hit || (acc && k >= 0 && k < s.n[i] && mino == val);
    hit = hit || (acc && xi == s.fdx[i] && yi == s.fdy[i]);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int m = abs(yi - s.cy[c]);
    const int hw = m < ncap ? cap[m] : -1;
    hit = hit || abs(xi - s.cx[c]) <= hw;
  }
  return hit;
}

template <typename Conv>
__global__ void __launch_bounds__(kThreads)
exact_kernel(ExactParams p, typename Conv::T* __restrict__ out,
             int strip_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Slot slots[kStage];
  __shared__ int cap[kMaxCap];
  // (ordered before the stamps by masks_frame's barriers)
  for (int i = threadIdx.x; i < p.ncap; i += blockDim.x) cap[i] = p.cap[i];
  masks_frame<Conv>(
      p, p.counts, p.idx, p.f[kFields - 1], out, smem, strip_bytes,
      [&](int env, int frame, uint8_t* strip, const int* list, int m) {
        for (int base = 0; base < m; base += kStage) {
          const int count = min(kStage, m - base);
          if ((int)threadIdx.x < count) {
            decode(p, (size_t)env * p.le + list[base + threadIdx.x],
                   slots[threadIdx.x]);
          }
          __syncthreads();
          for (int j = 0; j < count; ++j) {
            const Slot& s = slots[j];
            walk_window(
                p, s.word, frame,
                [&](int y0, int rr, int x) {
                  return exact_hit(s, cap, p.ncap, x, y0 + rr);
                },
                [&](int row, int x) { strip[row * p.wb + x] = 1; });
          }
          __syncthreads();  // before the next stage overwrites `slots`
        }
      });
}

template <typename Conv>
int launch(const ExactParams& p, typename Conv::T* out,
           cudaStream_t stream) {
  int strip_bytes, smem;
  cudaError_t err = strip_smem(p, 1, exact_kernel<Conv>, &strip_bytes,
                               &smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.B * p.L * p.nxb;
  if (blocks > 0) {
    exact_kernel<Conv><<<(unsigned)blocks, kThreads, smem, stream>>>(
        p, out, strip_bytes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `fields` and `cap` are host arrays: the 30 device pointers of the
// bundle's fields, and the cap table's `ncap` half-widths.
extern "C" int tc_exact_launch(
    const int32_t* counts, const int32_t* idx, const int32_t* const* fields,
    void* out, int out_float, int B, int L, int h, int w, int kp, int le,
    const int32_t* cap, int ncap, void* stream) {
  if (ncap < 1 || ncap > kMaxCap) return (int)cudaErrorInvalidValue;
  ExactParams p;
  tc::set_geometry(p, B, L, h, w, kp, le);
  p.counts = counts;
  p.idx = idx;
  for (int i = 0; i < kFields; ++i) p.f[i] = fields[i];
  p.ncap = ncap;
  for (int i = 0; i < kMaxCap; ++i) p.cap[i] = i < ncap ? cap[i] : -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_float) {
    return launch<tc::MaskF32>(p, static_cast<float*>(out), s);
  }
  return launch<tc::MaskU8>(p, static_cast<uint8_t*>(out), s);
}
