// car.cu -- the env step's per-car work in one launch: the action clamp,
// bicycle kinematics, the local-path walk, car_info and the default shaping.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/car_kernel.py, CarKernel).
//
// Replaces no Pallas kernel. The JAX package leaves `env.step`'s car work
// (tinycarlo_tpu/car.py car_step, find_local_path, car_info; env.py's
// shaping) to XLA, which fuses it. The port ran it as some 600 torch kernel
// launches a step (tinycarlo_torch/car.py, geometry.py, env.py), most of
// them gathers and (B, E) float32 intermediates; this kernel computes the
// same outputs in one.
//
// Function, per env b (env.step's order):
//   1. clamp the action to [-1, 1]; car_step: velocity and steering scaled
//      and rate limited, the straight (|steering| < 1e-4) and arc branches,
//      the arc's single-correction yaw wrap, the front axle;
//   2. find_local_path: the desired direction (current edge + maneuver *
//      pi/2); on a u-turn entry (maneuver 2 after another) the re-snap to
//      the nearest edge within 30 degrees of it, else the one-hop walk to
//      the nearest connected edge; then 3 lookahead hops. A failed first
//      hop keeps the path, its length and last_maneuver; any failure
//      truncates;
//   3. car_info on the new state: cte and heading error on the path's
//      second edge, per laneline layer the nearest packed edge (first-wins
//      argmin of the summed endpoint distances over the layer's slice, edge
//      0 for an edgeless layer), then the perpendicular or node distance;
//      all zeroed for a path shorter than 2 edges;
//   4. the default reward and termination on the cte, or zeros when
//      `wrapped`.
// Every operation is the torch code's, in its order and in float32, each
// multiply and add rounded apart (-fmad=false); Python constants are
// rounded to float32 as torch rounds a scalar; the math functions are the
// ones torch's elementwise kernels call (sinf, cosf, tanf, atan2f, sqrtf,
// IEEE division); `scalar / tensor` is torch's reciprocal times the
// scalar; reductions are (value, index) minima with torch's NaN-first,
// first-index rule (argmin's LessOrNan), a total order, so any lane split
// gives torch's index. The outputs are equal bit for bit.
//
// The one place it does less work: the composition runs the re-snap scan
// over every lanepath edge for every car and selects its result for the
// u-turn entries alone; here only an entering car's warp scans, and the
// other cars never compute the discarded value. Per block, the count of
// scanning cars goes to `resnaps[block]` (the "car.resnaps" counter).
//
// Design. One warp per env, 4 envs a block. The kinematics and the path
// walk (a serial chain of a few atan2s a hop over adjacency rows of <= 3)
// run redundantly on every lane, so no lane waits on another and every
// load of the state and the map is one broadcast; the scans (the re-snap's
// lanepath edges, each laneline layer's packed edges) stride the lanes and
// reduce by shuffles; the per-layer distances run a layer a lane. The
// map's tables (~10 KB on the benchmark maps) are read through the
// read-only cache and stay in L1 across a block's envs.
//
// Bound on the H100 at B = 4096 (simple_layout). Bytes: state and action
// read once (72 B a car), state, info and shaping written once (146 B a
// car at 5 layers): 0.9 MB, 0.0003 ms at 3.35 TB/s. Operations: ~20 a
// packed edge (264 a car), ~100 a path hop: ~30 MFLOP, 0.0005 ms at 67
// TFLOP/s, the bound. The kernel is far from it (PERF.md's kernel table):
// its time is each env's chain of dependent loads and transcendental
// calls, which one launch of 4096 warps overlaps.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // envs a block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kLookahead = 3;  // car.LOOKAHEAD
constexpr int kPathLen = kLookahead + 1;
constexpr int kMaxLayers = 64;  // two a lane in the per-layer pass

// Python's constants as torch rounds a scalar to float32
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kHalfPi = static_cast<float>(1.5707963267948966);
constexpr float kStraight = static_cast<float>(0.0001);

// the argument arrays' order (ops/car_kernel.py _IN, _OUT, _INTS, _FLOATS)
enum In {
  kPosition, kRotation, kSteering, kVelocity, kLocalPath, kPathLenIn,
  kLastManeuver, kControl, kManeuver, kLpNodes, kLpEdges, kLpEdgeMask,
  kNextTable, kNextCount, kPrevTable, kPrevCount, kPkNodes, kPkEdges,
  kNumIn
};
enum Out {
  kOPosition, kOFront, kORotation, kOSteering, kORadius, kOVelocity,
  kOLocalPath, kOPathLen, kOLastManeuver, kOTruncated, kOCte, kOHeading,
  kOLaneDist, kOInfoPath, kOInfoPathLen, kOInfoVelocity, kOReward,
  kOTerminated, kOResnaps, kNumOut
};
enum Ints {
  kB, kMan64, kLpE, kDeg, kL, kHasAcc, kHasSteer, kWrapped, kBounds
};
enum Floats {
  kMaxVelocity, kMaxSteering, kDecDt, kAccDt, kSteerDt, kDt, kWheelbase,
  kDeg2Rad, kMargin, kNegInvTw, kTermCte, kNumFloats
};

struct Params {
  const float* position;      // (B, 2)
  const float* rotation;      // (B,)
  const float* steering;      // (B,)
  const float* velocity;      // (B,)
  const int2* local_path;     // (B, 4) edges
  const int32_t* path_len;    // (B,)
  const int32_t* last_maneuver;
  const float* control;       // (B, 2), unclamped
  const void* maneuver;       // (B,) int32 or int64
  const float2* lp_nodes;     // (N, 2)
  const int2* lp_edges;       // (E, 2)
  const uint8_t* lp_edge_mask;
  const int32_t* next_table;  // (N, deg)
  const int32_t* next_count;  // (N,)
  const int32_t* prev_table;
  const int32_t* prev_count;
  const float2* pk_nodes;     // (Np, 2)
  const int2* pk_edges;       // (Ep, 2)
  float2* o_position;
  float2* o_front;
  float* o_rotation;
  float* o_steering;
  float* o_radius;
  float* o_velocity;
  int2* o_local_path;
  int32_t* o_path_len;
  int32_t* o_last_maneuver;
  uint8_t* o_truncated;
  float* o_cte;
  float* o_heading;
  float* o_lane_dist;         // (B, L)
  float2* o_info_path;        // (B, 4)
  int32_t* o_info_path_len;
  float* o_info_velocity;
  float* o_reward;
  uint8_t* o_terminated;
  int32_t* o_resnaps;         // (blocks,)
  int B, man64, lp_e, deg, L, has_acc, has_steer, wrapped;
  int bounds[kMaxLayers + 1];
  float max_velocity, max_steering, dec_dt, acc_dt, steer_dt, dt, wheelbase,
      deg2rad, margin, neg_inv_tw, term_cte;
};

__device__ __forceinline__ float2 ld(const float2* p, int i) {
  return __ldg(p + i);
}
__device__ __forceinline__ int2 ld(const int2* p, int i) {
  return __ldg(p + i);
}

// helper.clip_angle: two conditional corrections each way
__device__ __forceinline__ float clip_angle(float a) {
  if (a > kPi) a = a - kTwoPi;
  if (a > kPi) a = a - kTwoPi;
  if (a < -kPi) a = a + kTwoPi;
  if (a < -kPi) a = a + kTwoPi;
  return a;
}

// geometry.distance
__device__ __forceinline__ float dist(float2 a, float2 b) {
  const float dx = a.x - b.x;
  const float dy = a.y - b.y;
  return sqrtf(dx * dx + dy * dy);
}

// torch.clamp(v, lo, hi) with tensor bounds (NaN first from v, lo, hi)
__device__ __forceinline__ float clamp3(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.clamp with scalar bounds
__device__ __forceinline__ float clamp_s(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// argmin's order (ATen LessOrNan): NaN first, ties to the lower index
struct Best {
  float v;
  int i;
};

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

__device__ __forceinline__ void take(Best& best, float v, int i) {
  if (before(v, i, best.v, best.i)) {
    best.v = v;
    best.i = i;
  }
}

__device__ __forceinline__ Best warp_min(Best best) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best.v, o);
    const int i = __shfl_xor_sync(0xffffffffu, best.i, o);
    take(best, v, i);
  }
  return best;
}

__device__ __forceinline__ Best no_best() { return {INFINITY, INT_MAX}; }

// geometry.edge_orientations
__device__ __forceinline__ float orientation(const float2* nodes, int2 e) {
  const float2 p0 = ld(nodes, e.x);
  const float2 p1 = ld(nodes, e.y);
  return atan2f(p1.y - p0.y, p1.x - p0.x);
}

// geometry.signed_distance_to_edge
__device__ __forceinline__ float signed_distance(const float2* nodes, int2 e,
                                                 float2 pos) {
  const float2 n1 = ld(nodes, e.x);
  const float2 n2 = ld(nodes, e.y);
  const float lvx = n2.x - n1.x;
  const float lvy = n2.y - n1.y;
  const float pvx = pos.x - n1.x;
  const float pvy = pos.y - n1.y;
  const bool vertical = lvx == 0.0f;
  const float vertical_d = lvy > 0.0f ? pos.x - n1.x : n1.x - pos.x;
  const float denom = sqrtf(lvx * lvx + lvy * lvy);
  const float safe = (vertical && lvy == 0.0f) ? 1.0f : denom;
  const float cross = pvx * lvy - pvy * lvx;
  return vertical ? vertical_d : cross / safe;
}

// geometry.within_edge_bounds (early True at the endpoints)
__device__ __forceinline__ bool within_edge_bounds(float2 n0, float2 n1,
                                                   float2 pos) {
  const float evx = n1.x - n0.x;
  const float evy = n1.y - n0.y;
  const float a0 = fabsf(clip_angle(atan2f(pos.y - n0.y, pos.x - n0.x) -
                                    atan2f(evy, evx)));
  const float a1 = fabsf(clip_angle(atan2f(pos.y - n1.y, pos.x - n1.x) -
                                    atan2f(-evy, -evx)));
  const bool at_n0 = pos.x == n0.x && pos.y == n0.y;
  const bool at_n1 = pos.x == n1.x && pos.y == n1.y;
  return at_n0 || at_n1 || (a0 <= kHalfPi && a1 <= kHalfPi);
}

// geometry.pick_node_given_orientation over adjacency row `node`
__device__ int pick_node(const Params& p, const int32_t* table,
                         const int32_t* count, int node, float orient) {
  const int cnt = __ldg(count + node);
  if (cnt == 0) return -1;
  const int32_t* row = table + static_cast<int64_t>(node) * p.deg;
  if (cnt == 1) return __ldg(row);
  const float2 n = ld(p.lp_nodes, node);
  Best best = no_best();
  for (int j = 0; j < p.deg; ++j) {
    const int c = __ldg(row + j);
    const float2 cp = ld(p.lp_nodes, c < 0 ? 0 : c);
    const float diff =
        fabsf(clip_angle(atan2f(cp.y - n.y, cp.x - n.x) - orient));
    take(best, c >= 0 ? diff : INFINITY, j);
  }
  return __ldg(row + best.i);
}

// geometry.nearest_edge_with_orientation_idx, lanes striding the edges;
// -1 when no edge qualifies
__device__ int resnap(const Params& p, int lane, float2 pos, float dir) {
  Best best = no_best();
  bool any = false;
  for (int k = lane; k < p.lp_e; k += 32) {
    const int2 e = ld(p.lp_edges, k);
    const bool within =
        fabsf(clip_angle(orientation(p.lp_nodes, e) - dir)) <= p.margin;
    const bool valid = within && __ldg(p.lp_edge_mask + k) != 0;
    // an invalid edge enters as +inf, as in the composition's masked argmin
    float d = INFINITY;
    if (valid) {
      any = true;
      d = fabsf(dist(pos, ld(p.lp_nodes, e.x)) +
                dist(pos, ld(p.lp_nodes, e.y)));
    }
    take(best, d, k);
  }
  best = warp_min(best);
  return __any_sync(0xffffffffu, any) ? best.i : -1;
}

__global__ void __launch_bounds__(kThreads) car_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  __shared__ int resnapped[kWarps];
  int entered = 0;
  if (b < p.B) {
    // -- car_step: action clamp, rate limits, kinematics -----------------
    const float2 pos = ld(reinterpret_cast<const float2*>(p.position), b);
    const float rot = __ldg(p.rotation + b);
    const float vel = __ldg(p.velocity + b);
    const float steer = __ldg(p.steering + b);
    const float c0 = clamp_s(__ldg(p.control + 2 * b), -1.0f, 1.0f);
    const float c1 = clamp_s(__ldg(p.control + 2 * b + 1), -1.0f, 1.0f);
    float nv = c0 * p.max_velocity;
    if (p.has_acc) nv = clamp3(nv, vel - p.dec_dt, vel + p.acc_dt);
    float ns = c1 * p.max_steering;
    if (p.has_steer) ns = clamp3(ns, steer - p.steer_dt, steer + p.steer_dt);

    const float vxn = cosf(rot);
    const float vyn = sinf(rot);
    const bool straight = fabsf(ns) < kStraight;
    // straight branch
    const float2 pos_s = {pos.x + nv * vxn * p.dt, pos.y + nv * vyn * p.dt};
    // arc branch; wheelbase / tan(...) is torch's reciprocal times it
    const float steer_safe = straight ? 1.0f : ns;
    const float radius = (1.0f / tanf(steer_safe * p.deg2rad)) * p.wheelbase;
    const float ang_vel = nv / radius;
    const float dyaw = ang_vel * p.dt;
    const float tx = vyn * radius;
    const float ty = -vxn * radius;
    const float c = cosf(dyaw);
    const float s = sinf(dyaw);
    const float rot_x = c * tx + (-s) * ty;
    const float rot_y = s * tx + c * ty;
    const float2 pos_a = {pos.x - tx + rot_x, pos.y - ty + rot_y};
    float rot_a = rot + dyaw;
    if (rot_a > kPi) rot_a = rot_a - kTwoPi;
    if (rot_a < -kPi) rot_a = rot_a + kTwoPi;

    const float new_rot = straight ? rot : rot_a;
    const float2 new_pos = straight ? pos_s : pos_a;
    const float2 front = {new_pos.x + p.wheelbase * cosf(new_rot),
                          new_pos.y + p.wheelbase * sinf(new_rot)};

    // -- find_local_path --------------------------------------------------
    const int m = p.man64
                      ? static_cast<int>(
                            static_cast<const int64_t*>(p.maneuver)[b])
                      : static_cast<const int32_t*>(p.maneuver)[b];
    const int last_m = __ldg(p.last_maneuver + b);
    const int2 cur_edge = ld(p.local_path, b * kPathLen);
    const float base_dir = clip_angle(orientation(p.lp_nodes, cur_edge) +
                                      static_cast<float>(m) * kHalfPi);
    const bool uturn = m == 2 && last_m != 2;

    int2 first;
    bool first_valid;
    if (uturn) {
      entered = 1;
      const int idx = resnap(p, lane, front, base_dir);
      first_valid = idx >= 0;
      first = ld(p.lp_edges, idx < 0 ? 0 : idx);
    } else {
      // geometry.nearest_connected_edge
      const int src = cur_edge.x;
      const int dst = cur_edge.y;
      const int next = pick_node(p, p.next_table, p.next_count, dst, base_dir);
      const int prev = pick_node(p, p.prev_table, p.prev_count, src, base_dir);
      first_valid = next >= 0 && prev >= 0;
      const float d0 = dist(front, ld(p.lp_nodes, src));
      const float d1 = dist(front, ld(p.lp_nodes, dst));
      const float dn = dist(front, ld(p.lp_nodes, next < 0 ? 0 : next));
      const float dp = dist(front, ld(p.lp_nodes, prev < 0 ? 0 : prev));
      const bool fwd = dn < d0 && dn < d1;
      const bool bwd = dp < d0 && dp < d1 && !fwd;
      first = fwd ? make_int2(dst, next)
                  : (bwd ? make_int2(prev, src) : make_int2(src, dst));
    }

    int2 path[kPathLen];
    int len;
    int new_last_m;
    bool ok = first_valid;
    if (first_valid) {
      // after a u-turn re-snap the target direction flips
      const float walk_dir = uturn ? clip_angle(base_dir + kPi) : base_dir;
      const bool fwd_v = nv > 0.0f;
      int2 cur = first;
      path[0] = cur;
      len = 1;
#pragma unroll
      for (int h = 1; h < kPathLen; ++h) {
        if (ok) {
          const int base = fwd_v ? cur.y : cur.x;
          const int nxt =
              pick_node(p, p.next_table, p.next_count, base, walk_dir);
          ok = nxt >= 0;
          if (ok) {
            cur = make_int2(base, nxt);
            ++len;
          }
        }
        path[h] = cur;
      }
      new_last_m = m;
    } else {
#pragma unroll
      for (int h = 0; h < kPathLen; ++h) {
        path[h] = ld(p.local_path, b * kPathLen + h);
      }
      len = __ldg(p.path_len + b);
      new_last_m = last_m;
    }

    // -- car_info ---------------------------------------------------------
    const bool has_path = len >= 2;
    const float cte = signed_distance(p.lp_nodes, path[1], front);
    const float heading =
        clip_angle(orientation(p.lp_nodes, path[1]) - new_rot);
    // per layer, the nearest packed edge to the rear axle
    int ne_lo = 0, ne_hi = 0;  // this lane's layers: lane and lane + 32
    for (int l = 0; l < p.L; ++l) {
      const int lo = p.bounds[l];
      const int hi = p.bounds[l + 1];
      Best best = no_best();
      for (int k = lo + lane; k < hi; k += 32) {
        const int2 e = ld(p.pk_edges, k);
        const float d = fabsf(dist(new_pos, ld(p.pk_nodes, e.x)) +
                              dist(new_pos, ld(p.pk_nodes, e.y)));
        take(best, d, k);
      }
      best = warp_min(best);
      const int idx = hi > lo ? best.i : 0;
      if (l == lane) ne_lo = idx;
      if (l == lane + 32) ne_hi = idx;
    }
    for (int l = lane; l < p.L; l += 32) {
      const int2 ne = ld(p.pk_edges, l < 32 ? ne_lo : ne_hi);
      const float2 n0 = ld(p.pk_nodes, ne.x);
      const float2 n1 = ld(p.pk_nodes, ne.y);
      const bool inside = within_edge_bounds(n0, n1, new_pos);
      const float d_perp = fabsf(signed_distance(p.pk_nodes, ne, new_pos));
      // torch.minimum: NaN first
      const float da = dist(new_pos, n0);
      const float db = dist(front, n1);
      const float d_node = isnan(da) ? da : (isnan(db) ? db : fminf(da, db));
      const float d = inside ? d_perp : d_node;
      p.o_lane_dist[static_cast<int64_t>(b) * p.L + l] = has_path ? d : 0.0f;
    }

    if (lane < kPathLen) {
      // lane h writes hop h (static indices keep `path` in registers)
      int2 mine = path[0];
#pragma unroll
      for (int h = 1; h < kPathLen; ++h) {
        if (lane == h) mine = path[h];
      }
      p.o_local_path[b * kPathLen + lane] = mine;
      p.o_info_path[b * kPathLen + lane] = ld(p.lp_nodes, mine.y);
    }
    if (lane == 0) {
      p.o_position[b] = new_pos;
      p.o_front[b] = front;
      p.o_rotation[b] = new_rot;
      p.o_steering[b] = ns;
      p.o_radius[b] = straight ? 0.0f : radius;
      p.o_velocity[b] = nv;
      p.o_path_len[b] = len;
      p.o_last_maneuver[b] = new_last_m;
      p.o_truncated[b] = ok ? 0 : 1;
      const float cte_i = has_path ? cte : 0.0f;
      p.o_cte[b] = cte_i;
      p.o_heading[b] = has_path ? heading : 0.0f;
      p.o_info_path_len[b] = has_path ? len : 0;
      p.o_info_velocity[b] = has_path ? nv : 0.0f;
      // -- shaping: env.default_reward / default_termination ----------------
      if (p.wrapped) {
        p.o_reward[b] = 0.0f;
        p.o_terminated[b] = 0;
      } else {
        const float r = cte_i * p.neg_inv_tw + 1.0f;
        p.o_reward[b] = isnan(r) ? r : fmaxf(r, 0.0f);
        p.o_terminated[b] = cte_i > p.term_cte ? 1 : 0;
      }
    }
  }
  if (lane == 0) resnapped[warp] = entered;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += resnapped[w];
    p.o_resnaps[blockIdx.x] = n;
  }
}

}  // namespace

// The launch: `in` and `out` hold the tensors' device pointers, `ints` the
// sizes and flags then L + 1 layer bounds, `floats` the car's constants,
// each in the order of the enums above. Returns the launch's CUDA error.
extern "C" int tc_car_launch(const void* const* in, void* const* out,
                             const int* ints, const float* floats,
                             void* stream) {
  Params p;
  p.position = static_cast<const float*>(in[kPosition]);
  p.rotation = static_cast<const float*>(in[kRotation]);
  p.steering = static_cast<const float*>(in[kSteering]);
  p.velocity = static_cast<const float*>(in[kVelocity]);
  p.local_path = static_cast<const int2*>(in[kLocalPath]);
  p.path_len = static_cast<const int32_t*>(in[kPathLenIn]);
  p.last_maneuver = static_cast<const int32_t*>(in[kLastManeuver]);
  p.control = static_cast<const float*>(in[kControl]);
  p.maneuver = in[kManeuver];
  p.lp_nodes = static_cast<const float2*>(in[kLpNodes]);
  p.lp_edges = static_cast<const int2*>(in[kLpEdges]);
  p.lp_edge_mask = static_cast<const uint8_t*>(in[kLpEdgeMask]);
  p.next_table = static_cast<const int32_t*>(in[kNextTable]);
  p.next_count = static_cast<const int32_t*>(in[kNextCount]);
  p.prev_table = static_cast<const int32_t*>(in[kPrevTable]);
  p.prev_count = static_cast<const int32_t*>(in[kPrevCount]);
  p.pk_nodes = static_cast<const float2*>(in[kPkNodes]);
  p.pk_edges = static_cast<const int2*>(in[kPkEdges]);
  p.o_position = static_cast<float2*>(out[kOPosition]);
  p.o_front = static_cast<float2*>(out[kOFront]);
  p.o_rotation = static_cast<float*>(out[kORotation]);
  p.o_steering = static_cast<float*>(out[kOSteering]);
  p.o_radius = static_cast<float*>(out[kORadius]);
  p.o_velocity = static_cast<float*>(out[kOVelocity]);
  p.o_local_path = static_cast<int2*>(out[kOLocalPath]);
  p.o_path_len = static_cast<int32_t*>(out[kOPathLen]);
  p.o_last_maneuver = static_cast<int32_t*>(out[kOLastManeuver]);
  p.o_truncated = static_cast<uint8_t*>(out[kOTruncated]);
  p.o_cte = static_cast<float*>(out[kOCte]);
  p.o_heading = static_cast<float*>(out[kOHeading]);
  p.o_lane_dist = static_cast<float*>(out[kOLaneDist]);
  p.o_info_path = static_cast<float2*>(out[kOInfoPath]);
  p.o_info_path_len = static_cast<int32_t*>(out[kOInfoPathLen]);
  p.o_info_velocity = static_cast<float*>(out[kOInfoVelocity]);
  p.o_reward = static_cast<float*>(out[kOReward]);
  p.o_terminated = static_cast<uint8_t*>(out[kOTerminated]);
  p.o_resnaps = static_cast<int32_t*>(out[kOResnaps]);
  p.B = ints[kB];
  p.man64 = ints[kMan64];
  p.lp_e = ints[kLpE];
  p.deg = ints[kDeg];
  p.L = ints[kL];
  p.has_acc = ints[kHasAcc];
  p.has_steer = ints[kHasSteer];
  p.wrapped = ints[kWrapped];
  if (p.L < 0 || p.L > kMaxLayers || p.B < 1) return cudaErrorInvalidValue;
  for (int l = 0; l <= p.L; ++l) p.bounds[l] = ints[kBounds + l];
  p.max_velocity = floats[kMaxVelocity];
  p.max_steering = floats[kMaxSteering];
  p.dec_dt = floats[kDecDt];
  p.acc_dt = floats[kAccDt];
  p.steer_dt = floats[kSteerDt];
  p.dt = floats[kDt];
  p.wheelbase = floats[kWheelbase];
  p.deg2rad = floats[kDeg2Rad];
  p.margin = floats[kMargin];
  p.neg_inv_tw = floats[kNegInvTw];
  p.term_cte = floats[kTermCte];
  const int blocks = (p.B + kWarps - 1) / kWarps;
  car_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
