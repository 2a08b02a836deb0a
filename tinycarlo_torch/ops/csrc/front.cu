// front.cu -- the render's front end: projection and compaction of the
// packed edge axis into the `compact_env_idx_soa` bundle, one launch.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, FrontKernel).
//
// Replaces no Pallas kernel. The JAX package leaves the projection
// (tinycarlo_tpu/camera.py `project_layers_batch_soa`) and the compaction
// (tinycarlo_tpu/ops/rasterize_pallas.py `compact_env_idx_soa` with
// pre=False, :886-1108) to XLA, which fuses them and routes the slots
// with `lax.top_k`. The port ran them as some 280 torch kernel launches a
// step, a `torch.topk` over every copy among them; this kernel computes
// the same bundle in one.
//
// Function. For env b and packed edge e: gather the edge's two nodes,
// transform them by the env's pose (B, 3, 4) (torch's E @ body product,
// computed outside), clip to the near plane and to max_range, project
// with a true divide and test the frame (camera.project_layers_batch_soa);
// then truncate the endpoints to int, at thickness 1 clip them as cv2's
// clipLine does and anchor them at the smaller x (`_clip_normalize_t1`),
// take the band count and first band (`_bands`), split the edge into nxb
// lane-block copies with their touch test, shift each into its stacked
// frame strip and write (ax, ay, abx, aby, inv, bw) at copy e*nxb + j
// (`compact_env_idx_soa`). Every operation is the torch code's, in its
// order and precision (float32, or float64 up to the int cast), each
// multiply and add rounded apart (-fmad=false), so the bundle is equal
// element for element, dead copies included.
//
// Routing without a sort. `_slot_order`'s key puts the eligible short
// copies (0 < nb <= win/gran) first, the eligible talls next and the rest
// last, each group in copy order: a stable three-way partition. A copy's
// slot is the count of its group's copies before it plus the sizes of the
// groups before its group. Pass 1 computes the copies, stores each one's
// group in shared memory and counts the groups and the eligible copies of
// each layer; pass 2 scans the groups chunk by chunk (block-wide prefix
// sums, carried across chunks) and writes idx[b, slot] = copy for the
// first kk = min(k, LE) slots, then the 7 pad columns (copies of the last
// slot's), and the counts rows [live, 0, short, dropped, per layer...].
//
// Design. One block per env; a block walks the env's LE copies in chunks
// of its threads, a thread per copy (a copy recomputes its edge's
// projection: nxb-fold work that costs far less than a divergent loop over
// the lane blocks, and keeps every store coalesced). The chunk size is
// derived from LE: ceil(LE / 512) chunks of equal size, rounded up to a
// warp, so 528 copies take two chunks of 288 and 3720 take eight of 480.
// Shared memory: LE bytes of groups and the layer counters.
//
// Bound on the H100 at the bench shape (B = 4096, LE = 528, kp = 263 + 7).
// Bytes: the bundle written once, 6 x 4 B x B x LE of payload (51.9 MB)
// plus idx (4.4 MB) and counts; the map (~5 KB) and the poses (0.2 MB)
// are read once into L2. ~56.4 MB, 0.0168 ms at 3.35 TB/s. Operations:
// ~150 a copy (projection of both ends, clipping, bands), 0.3 G, 0.005 ms
// at 67 TFLOP/s. Bytes bound it; every payload store of a warp is one
// contiguous 128-byte line. It reaches about a third of that bound (PERF.md's
// kernel table): a block's chunks run in series, each a chain of dependent
// loads, divides and three block-wide barriers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kXB = 128;       // lane-block width (rasterize_kernels._XB)
constexpr int kGran = 16;      // band rows (rasterize_kernels._GRAN)
constexpr int kNbPack = 512;   // band word packing (rasterize_kernels._NB_PACK)
constexpr int kPad = 7;        // idx pad columns (rasterize_kernels._route_slots)

struct Params {
  const void* nodes;          // (N, 2) T
  const int32_t* edges;       // (E, 2)
  const uint8_t* edge_mask;   // (E,) bool
  const int32_t* edge_layer;  // (E,)
  const void* pose;           // (B, 3, 4) T
  const void* K;              // (3, 3) T
  int32_t* idx;               // (B, kk + 7)
  float* ax;                  // (B, LE) each
  float* ay;
  float* abx;
  float* aby;
  float* inv;
  int32_t* bw;
  int32_t* counts;            // (4 + L, B)
  int B, L, h, w, nxb, le, k, kk;
  int n_bands, hp, b0max, tall_nb;
  int bres, has_range;
  double max_range;
  float rf;
};

template <typename T>
struct Pt {
  T x, y, z;
};

// camera.project_layers_batch_soa's clip_to: move `m` along the segment
// toward `keep` to depth `target`.
template <typename T>
__device__ __forceinline__ Pt<T> clip_to(Pt<T> m, Pt<T> keep, T target) {
  const T dz = keep.z - m.z;
  const T t = (target - m.z) / (dz == T(0) ? T(1) : dz);
  return {m.x + t * (keep.x - m.x), m.y + t * (keep.y - m.y), target};
}

// compact_env_idx_soa's icast: clamp to +-1e6 (NaN passes, as torch.clamp
// lets it), truncate to int32 (NaN to 0, as the card's cast does), float.
template <typename T>
__device__ __forceinline__ float icast(T x) {
  const T lim = T(1000000.0);
  const T c = isnan(x) ? x : (x < -lim ? -lim : (x > lim ? lim : x));
  return (float)(int)c;
}

__device__ __forceinline__ int out_code(float x, float y, float right,
                                        float bottom) {
  return (x < 0.f) + 2 * (x > right) + 4 * (y < 0.f) + 8 * (y > bottom);
}

__device__ __forceinline__ float tdiv(float num, float den) {
  return truncf(num / (den == 0.f ? 1.f : den));
}

// rasterize._clip_line_cv2: cv2 clipLine on integer-valued floats, pt1
// then pt2 against the rows, then against the columns; returns accept.
__device__ bool clip_line_cv2(int w, int h, float& x1, float& y1, float& x2,
                              float& y2) {
  const float right = (float)(w - 1);
  const float bottom = (float)(h - 1);
  int c1 = out_code(x1, y1, right, bottom);
  int c2 = out_code(x2, y2, right, bottom);
  bool active = ((c1 & c2) == 0) && ((c1 | c2) != 0);
  if (active && (c1 & 12)) {
    const float a = c1 < 8 ? 0.f : bottom;
    x1 = x1 + tdiv((a - y1) * (x2 - x1), y2 - y1);
    y1 = a;
    c1 = (x1 < 0.f) + 2 * (x1 > right);
  }
  if (active && (c2 & 12)) {
    const float a = c2 < 8 ? 0.f : bottom;
    x2 = x2 + tdiv((a - y2) * (x2 - x1), y2 - y1);
    y2 = a;
    c2 = (x2 < 0.f) + 2 * (x2 > right);
  }
  active = ((c1 & c2) == 0) && ((c1 | c2) != 0);
  if (active && c1 != 0) {
    const float a = c1 == 1 ? 0.f : right;
    y1 = y1 + tdiv((a - x1) * (y2 - y1), x2 - x1);
    x1 = a;
    c1 = 0;
  }
  if (active && c2 != 0) {
    const float a = c2 == 1 ? 0.f : right;
    y2 = y2 + tdiv((a - x2) * (y2 - y1), x2 - x1);
    x2 = a;
    c2 = 0;
  }
  return (c1 & c2) == 0;
}

// The projection of packed edge e by the env's pose `P` (row-major 3x4)
// and the intrinsics: pixel endpoints and the draw bit.
template <typename T>
__device__ bool project(const Params& p, const T* P, T fx, T fy, T cx,
                        T cy, T skew, int e, T& u0, T& v0, T& u1, T& v1) {
  const T* nodes = static_cast<const T*>(p.nodes);
  const int n0 = p.edges[2 * e], n1 = p.edges[2 * e + 1];
  const T x0 = nodes[2 * n0], y0 = nodes[2 * n0 + 1];
  const T x1 = nodes[2 * n1], y1 = nodes[2 * n1 + 1];
  Pt<T> a = {P[0] * x0 + P[1] * y0 + P[3], P[4] * x0 + P[5] * y0 + P[7],
             P[8] * x0 + P[9] * y0 + P[11]};
  Pt<T> b = {P[0] * x1 + P[1] * y1 + P[3], P[4] * x1 + P[5] * y1 + P[7],
             P[8] * x1 + P[9] * y1 + P[11]};
  bool front0 = a.z < T(0), front1 = b.z < T(0);
  const bool clip0 = !front0 && front1, clip1 = front0 && !front1;
  const T near = T(-1e-7);  // camera.NEAR_EPS
  if (clip0) a = clip_to(a, b, near);
  if (clip1) b = clip_to(b, a, near);
  front0 = front0 || clip0;
  front1 = front1 || clip1;
  bool in0 = true, in1 = true;
  if (p.has_range) {
    const T zmax = T(-p.max_range);
    in0 = a.z > zmax;
    in1 = b.z > zmax;
    const bool r0 = !in0 && in1, r1 = in0 && !in1;
    if (r0) a = clip_to(a, b, zmax);
    if (r1) b = clip_to(b, a, zmax);
    in0 = in0 || r0;
    in1 = in1 || r1;
  }
  // a true divide, as camera.py's proj
  const T zs0 = a.z == T(0) ? T(1) : a.z;
  const T zs1 = b.z == T(0) ? T(1) : b.z;
  u0 = (fx * a.x + skew * a.y + cx * a.z) / zs0;
  v0 = (fy * a.y + cy * a.z) / zs0;
  u1 = (fx * b.x + skew * b.y + cx * b.z) / zs1;
  v1 = (fy * b.y + cy * b.z) / zs1;
  const T W = T(p.w), H = T(p.h);
  const bool vis0 = u0 > T(0) && u0 < W && v0 > T(0) && v0 < H && front0 &&
                    in0;
  const bool vis1 = u1 > T(0) && u1 < W && v1 > T(0) && v1 < H && front1 &&
                    in1;
  return p.edge_mask[e] && (vis0 || vis1);
}

// Inclusive block-wide sum of `v` over the block's threads; `total` gets
// the block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += n;
    }
    if (lane < nwarps) s_warp[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += s_warp[warp - 1];
  total = s_warp[nwarps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) front_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_groups[2];  // eligible short copies, eligible talls
  int* s_layer = reinterpret_cast<int*>(smem);
  uint8_t* s_group = smem + 4 * ((p.L + 3) & ~3);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int l = tid; l < p.L; l += blockDim.x) s_layer[l] = 0;
  if (tid < 2) s_groups[tid] = 0;

  const T* pose = static_cast<const T*>(p.pose) + 12 * (size_t)b;
  T P[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] = pose[i];
  const T* K = static_cast<const T*>(p.K);
  const T fx = K[0], skew = K[1], cx = K[2], fy = K[4], cy = K[5];
  __syncthreads();

  const size_t row = (size_t)b * p.le;
  // pass 1: the copies, their groups and the counts
  for (int c0 = 0; c0 < p.le; c0 += blockDim.x) {
    const int c = c0 + tid;
    int group = 2;
    if (c < p.le) {
      const int e = c / p.nxb, j = c - e * p.nxb;
      T u0, v0, u1, v1;
      bool draw = project<T>(p, P, fx, fy, cx, cy, skew, e, u0, v0, u1, v1);
      float ax = icast(u0), ay = icast(v0), bx = icast(u1), by = icast(v1);
      if (p.bres) {
        draw = clip_line_cv2(p.w, p.h, ax, ay, bx, by) && draw;
        if (bx < ax) {  // anchor at the smaller x
          float t = ax; ax = bx; bx = t;
          t = ay; ay = by; by = t;
        }
      }
      // _bands
      const float ylo = fminf(ay, by) - p.rf, yhi = fmaxf(ay, by) + p.rf;
      const float top = (float)p.n_bands - 1.f;
      const float scale = 1.f / (float)kGran;
      const int b0 = (int)fminf(fmaxf(floorf(ylo * scale), 0.f), top);
      const int b1 = (int)fminf(fmaxf(floorf(yhi * scale), 0.f), top);
      const bool valid = yhi >= 0.f && ylo <= (float)p.h - 1.f && draw;
      int nb = valid ? b1 + 1 - b0 : 0;
      const int b0c = min(b0, p.b0max);
      const int lay = p.edge_layer[e];
      int frame = lay;
      if (p.nxb > 1) {
        const float xoff = (float)(j * kXB);
        const float xlo = fminf(ax, bx) - p.rf, xhi = fmaxf(ax, bx) + p.rf;
        const bool touch = xlo <= xoff + (float)(kXB - 1) && xhi >= xoff;
        ax = ax - xoff;
        bx = bx - xoff;
        nb = touch ? nb : 0;
        frame = lay * p.nxb + j;
      }
      const float roff = (float)(frame * p.hp);
      ay = ay + roff;
      by = by + roff;
      const float dx = bx - ax, dy = by - ay;
      float inv;
      if (p.bres) {
        const float maj = fmaxf(fabsf(dx), fabsf(dy));
        inv = 1.f / (maj == 0.f ? 1.f : 2.f * maj);
      } else {
        const float denom = dx * dx + dy * dy;
        inv = 1.f / (denom == 0.f ? 1.f : denom);
      }
      p.ax[row + c] = ax;
      p.ay[row + c] = ay;
      p.abx[row + c] = dx;
      p.aby[row + c] = dy;
      p.inv[row + c] = inv;
      p.bw[row + c] = (frame * p.n_bands + b0c) * kNbPack + nb;
      if (nb > 0) {
        group = nb <= p.tall_nb ? 0 : 1;
        atomicAdd(&s_layer[lay], 1);
      }
      s_group[c] = (uint8_t)group;
    }
    const unsigned shorts = __ballot_sync(0xffffffffu, group == 0);
    const unsigned talls = __ballot_sync(0xffffffffu, group == 1);
    if ((tid & 31) == 0) {
      if (shorts) atomicAdd(&s_groups[0], __popc(shorts));
      if (talls) atomicAdd(&s_groups[1], __popc(talls));
    }
  }
  __syncthreads();
  const int n_short = s_groups[0], n_tall = s_groups[1];

  // pass 2: the stable partition's slots
  const int kw = p.kk + kPad;
  int32_t* idx = p.idx + (size_t)b * kw;
  int carry_s = 0, carry_t = 0;
  for (int c0 = 0; c0 < p.le; c0 += blockDim.x) {
    const int c = c0 + tid;
    const int group = c < p.le ? s_group[c] : 3;
    // short and tall counts packed in 16 bits each (a chunk <= 512)
    const int v = (group == 0) | ((group == 1) << 16);
    int total;
    const int excl = block_scan(v, s_warp, total) - v;
    if (c < p.le) {
      const int es = excl & 0xffff, et = excl >> 16;
      int slot;
      if (group == 0) {
        slot = carry_s + es;
      } else if (group == 1) {
        slot = n_short + carry_t + et;
      } else {
        slot = n_short + n_tall + (c0 - carry_s - carry_t) + (tid - es - et);
      }
      if (slot < p.kk) {
        idx[slot] = c;
        if (slot == p.kk - 1) {
#pragma unroll
          for (int q = 0; q < kPad; ++q) idx[p.kk + q] = c;
        }
      }
    }
    carry_s += total & 0xffff;
    carry_t += total >> 16;
  }

  if (tid == 0) {
    const int n_elig = n_short + n_tall;
    const int n_all = min(n_elig, p.k);
    p.counts[b] = n_all;
    p.counts[p.B + b] = 0;
    p.counts[2 * p.B + b] = min(n_short, p.k);
    p.counts[3 * p.B + b] = n_elig - n_all;
  }
  for (int l = tid; l < p.L; l += blockDim.x) {
    p.counts[(size_t)(4 + l) * p.B + b] = s_layer[l];
  }
}

// Threads a block: LE cut into ceil(LE / 512) equal chunks, a warp multiple.
int block_threads(int le) {
  const int chunks = (le + kMaxThreads - 1) / kMaxThreads;
  const int per = (le + chunks - 1) / chunks;
  return (per + 31) / 32 * 32;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  if (p.B == 0) return (int)cudaGetLastError();
  const size_t smem = 4 * (size_t)((p.L + 3) & ~3) + (size_t)p.le;
  cudaError_t err = cudaFuncSetAttribute(
      front_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  front_kernel<T><<<p.B, block_threads(p.le), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tc_front_launch(
    const void* nodes, const int32_t* edges, const uint8_t* edge_mask,
    const int32_t* edge_layer, const void* pose, const void* K, int32_t* idx,
    float* ax, float* ay, float* abx, float* aby, float* inv, int32_t* bw,
    int32_t* counts, int f64, int B, int E, int L, int h, int w, int nxb,
    int k, int kk, int n_bands, int hp, int b0max, int tall_nb, int bres,
    int has_range, double max_range, float rf, void* stream) {
  Params p;
  p.nodes = nodes;
  p.edges = edges;
  p.edge_mask = edge_mask;
  p.edge_layer = edge_layer;
  p.pose = pose;
  p.K = K;
  p.idx = idx;
  p.ax = ax;
  p.ay = ay;
  p.abx = abx;
  p.aby = aby;
  p.inv = inv;
  p.bw = bw;
  p.counts = counts;
  p.B = B;
  p.L = L;
  p.h = h;
  p.w = w;
  p.nxb = nxb;
  p.le = E * nxb;
  p.k = k;
  p.kk = kk;
  p.n_bands = n_bands;
  p.hp = hp;
  p.b0max = b0max;
  p.tall_nb = tall_nb;
  p.bres = bres;
  p.has_range = has_range;
  p.max_range = max_range;
  p.rf = rf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(p, s) : launch<float>(p, s);
}
