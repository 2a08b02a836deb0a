"""Drive the PyTorch port (tinycarlo_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which exits non-zero on
any failed check:

1. device: requires CUDA; prints the card's name and power limit and the
   TF32 settings (both off).
2. build: compiles the port's CUDA kernels from tinycarlo_torch/ops/csrc
   with nvcc (one process per source, started together) and prints the
   build time and ptxas' report.
3. kernels: every kernel against its plain PyTorch version on the card.
   The masks and rank kernels on random compaction bundles (t = 1, 2, 3;
   w = 48, 160 and 640; h = 30, 128 and 480; an env with nothing to draw;
   an oversubscribed budget) and on real bundles of the bench config's
   states, masks in uint8 and float32, rank also against rank_from_masks
   of the masks kernel. The exact kernel on random exact bundles (t = 2,
   3, 5; 48x96, 128x160, 480x640; deep-clipped segments, the pinned
   swapped-edge segment, horizontal and vertical ties, an empty env, an
   oversubscribed budget) and on real bundles, uint8 and float32 (0/1).
   Bit-equality is required: the kernels are built with -fmad=false.
4. main path (classes): bench.py's workload through the port's entry
   points -- make_env_params, vector.reset(4096), the segment-overflow
   guard, then vector.step with Stanley actions and max_episode_steps=1000,
   the observation rendered every step and consumed by a checksum. The
   masks kernel's launch count must equal the renders. Reports env-steps/s
   (median of repeats, with spread) and per-stage ms; then the last
   observation against the plain version on the same states and a small
   rollout against the port on the CPU.
5. exact classes: the same workload with camera.stroke: exact (cv2's
   ThickLine stroke, the exact kernel): env-steps/s, per-stage ms, the
   device idle share and peak memory; exact-kernel launches equal to the
   renders and no masks-kernel launch; a small rollout against the CPU
   port (frames equal wherever the two devices' exact bundles are); and a
   sample of the card's exact frames against the port's
   pure-Python cv2 oracle (`thick_stroke_mask_ref`), segment by segment.
6. serving (rgb): the bundled pretrained combo (models.load_pretrained)
   through the port's `train.evaluate` on examples/config_simple_layout.yaml,
   whose rgb frames come from the rank kernel:
   a. the example's protocol (examples/benchmark_tinycar_net.py:92-98):
      maneuvers 0, 1, 2, 5 episodes of 1000 steps, seed 10, one worker
      process per maneuver; each cte_avg must be finite and below 0.02 m
      (steps are cut, and the cut printed, if a maneuver would take over
      ~30 s);
   b. 4096 episodes of 100 steps, repeated: env-steps/s with the policy,
      per-stage ms, the device idle share and the peak memory; the rank
      kernel's launch count must equal the renders;
   c. 8 envs x 20 combo-driven steps on the card and on the CPU port.
7. exact serving: the same config with camera.stroke: exact, frames from
   the exact kernel's masks (the rank kernel is not launched):
   a. benchmarks/policy_parity.py's protocol: maneuvers 0, 1, 2, 4
      sequential episodes of 500 steps, one worker process per maneuver
      (cut, and the cut printed, if a maneuver would take over ~90 s);
      each cte_avg below 0.02 m;
   b. 4096 episodes of 100 steps, 3 repeats: env-steps/s, launches equal
      to the renders, the device idle share;
   c. 8 envs x 20 combo-driven steps on the card and on the CPU port
      (frames equal wherever the two devices' exact bundles are).
8. results: the `kernels` JSON line, the card line and, last, the `ok`
   JSON line.

Every time is measured on the card in this run (CUDA events, or host
clocks around work that ends in torch.cuda.synchronize()).
"""
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's CONFIG (bench.py:31-59): simple_layout, classes masks at
# 128x160, line_thickness 2.
CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {
        "wheelbase": 0.0487,
        "track_width": 0.027,
        "max_velocity": 0.15,
        "max_steering_angle": 30,
        "steering_speed": 30,
        "max_acceleration": 0.1,
        "max_deceleration": 1.0,
    },
    "camera": {
        "position": [0.0, -0.005, 0.04],
        "orientation": [22, 0, 0],
        "resolution": [128, 160],
        "fov": 80,
        "max_range": 0.5,
        "line_thickness": 2,
    },
    "map": {
        "json_path": os.path.join(REPO, "examples/maps/simple_layout.json"),
        "pixel_per_meter": 450,
    },
}
N_ENVS = 4096
CHUNK = 100  # steps per timed repeat
REPEATS = 5
# the repeats of the paths other than exact classes, cut so that the
# whole run fits its time
FAST_REPEATS = 3
WARMUP = 10
SPEED, K = 0.5, 5.0  # bench.py:64

# the serving path: the example's config and protocol
# (examples/benchmark_tinycar_net.py:53-98) and the batched run
SERVE_CONFIG = os.path.join(REPO, "examples/config_simple_layout.yaml")
SERVE_STEPS, SERVE_EPISODES, SERVE_SEED = 1000, 5, 10
# a maneuver's time before the protocol's steps are cut (the maneuvers
# run in parallel processes)
SERVE_BUDGET_S = 30.0
# the exact serving protocol (benchmarks/policy_parity.py:131-133, run
# with --stroke exact): sequential episodes, as the reference's evaluate
EXACT_SERVE_STEPS, EXACT_SERVE_EPISODES = 500, 4
# at B = 1 the exact step is host-bound (~34 ms on the H100 machine's
# host): 4 x 500 steps take ~70 s a maneuver
EXACT_SERVE_BUDGET_S = 90.0
# cte_avg of the bundled combo: 0.0064 / 0.0092 / 0.0096 m in the JAX
# package's records, untrained inits 0.026-0.035 m (docs/TRAINING.md)
CTE_LIMIT = 0.02
# card against CPU port, 8 envs x 20 closed-loop steps: on equal frames the
# float32 combo forwards (TF32 off) agree to rounding; where a frame differs
# in a stroke-boundary pixel, the steering may move by up to ~4e-3
STEER_ATOL = 1e-5
STEER_ATOL_MOVED = 2e-2
# envs of the exact main path's last frames held against the cv2 oracle
ORACLE_ENVS = 16

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# int32 rate: 132 SMs x 64 INT32 lanes per SM per clock (half the float32
# lanes; NVIDIA's Hopper architecture white paper) x 1.98 GHz boost.
PEAK_I32_PER_S = 132 * 64 * 1.98e9
# float32 operations the masks kernel spends per evaluated pixel
# (masks.cu window_hit). Split stroke: apx, apy, tu 4, clip 2, dx 2, dy 2,
# d2 3, the tu range test 2, the d2 compare 1. Bresenham (t=1): apx, apy,
# |aby|, sign, major test, max, min, step 2, num 4, floor quotient 2,
# residual 3, its corrections 4, probe, target 2, range and match tests 3,
# the point test 1.
OPS_PER_PIXEL = {"split": 18, "bres": 29}
# int32 operations of the exact stamp (exact.cu exact_hit) that the
# function needs, each counted where it must be done: once per pixel if it
# depends on the lane, once per box row if only on the row, once per copy
# if only on the copy's flags (see exact_bytes_and_ops).
# Per pixel: the fill span's two lane tests and two ands; each cap's
# |xi - cx| (2), compare, or; each accepted edge's far-dot lane compare,
# and, or, and its DDA -- x-major: k, the multiply, add and shift, two
# range tests, the minor compare, two ands and the or (10); y-major: the
# lane compare, and, or (3).
EXACT_PIXEL_OPS = {"fill": 4, "cap": 4, "far": 3, "x_major": 10,
                   "y_major": 3}
# Per row: the fill span's ya, each chain's row test, offset and
# multiply-add (4), min, max, two rounding adds and shifts, the ymin/ystop
# tests and their and (20); each cap's |yi - cy| (2), table bound and read
# (4); each accepted edge's far-dot row compare (1) and, y-major, its k,
# multiply, add, shift, two range tests and and (7).
EXACT_ROW_OPS = {"fill": 20, "cap": 4, "far": 1, "x_major": 0,
                 "y_major": 7}
# Per copy: the fill flag test, each edge's accept and major bits (shift,
# and each).
EXACT_COPY_OPS = 1 + 4 * 4


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=7, warmup=2):
    """Median milliseconds of fn() on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def with_stroke(params, stroke):
    """The same EnvParams with camera.stroke replaced."""
    cfg = params.cfg
    return dataclasses.replace(params, cfg=dataclasses.replace(
        cfg, camera=dataclasses.replace(cfg.camera, stroke=stroke)))


def segments(seed, b, e, h, w, dev, n_layers=5, deep=False):
    """Numpy-seeded segments on `dev`; env 0 draws nothing. With `deep`,
    half of them are deep-clipped (~400 px off frame), the first edge of
    every env is the pinned segment (150, -151) -> (-378, 406) whose
    direction-swapped clipped outline edge needs its far dot, and edges
    1-3 and 4-6 are horizontal and vertical (ties of the quad's top
    vertex)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, e))
    v0 = rng.uniform(-40, h + 40, (b, e))
    u1 = u0 + rng.uniform(-90, 90, (b, e))
    v1 = v0 + rng.uniform(-60, 60, (b, e))
    draw = rng.random((b, e)) < 0.7
    if deep:
        far = rng.random((b, e)) < 0.5
        u0, v0, u1, v1 = (np.where(far, rng.uniform(-400, s + 400, (b, e)), x)
                          for s, x in zip((w, h, w, h), (u0, v0, u1, v1)))
        v1[:, 1:4] = v0[:, 1:4]
        u1[:, 4:7] = u0[:, 4:7]
        u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0] = 150.0, -151.0, -378.0, 406.0
        draw[:, :7] = True
    draw[0] = False
    lay = np.sort(rng.integers(0, n_layers, e)).astype(np.int32)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    return (f(u0), f(v0), f(u1), f(v1), torch.tensor(draw, device=dev),
            torch.tensor(lay, device=dev))


def random_bundle(rk, seed, b, e, h, w, t, k_per_block, dev, n_layers=5,
                  exact=False):
    """The fast (or with `exact` the exact) compaction bundle on `dev` of
    `segments`."""
    u0, v0, u1, v1, draw, lay = segments(seed, b, e, h, w, dev, n_layers,
                                         deep=exact)
    compact = rk.compact_env_exact_soa if exact else rk.compact_env_idx_soa
    return compact(
        u0, v0, u1, v1, draw, k_per_block * rk._n_xblocks(w), h, t,
        edge_layer=lay, n_layers=n_layers, w=w,
    )


def kernel_pair(rk, params):
    """(compaction, kernel, plain version, kernel symbol) of the classes
    render under the params' stroke."""
    from tinycarlo_torch.ops import rasterize as ras

    cam = params.cfg.camera
    if ras._exact(cam.line_thickness, cam.stroke):
        return (rk.compact_env_exact_soa, rk.exact_kernel,
                rk.rasterize_masks_exact_env_plain, "exact_kernel")
    return (rk.compact_env_idx_soa, rk.masks_kernel,
            rk.rasterize_masks_env_plain, "masks_kernel")


def kernel_vs_plain(kernel, plain, bundle, n_layers, res, t):
    """Max |kernel - plain| over uint8 and float32 outputs (0 expected); the
    float32 output must read exactly 0/1."""
    import torch

    err = 0.0
    for dt in (torch.uint8, torch.float32):
        got = kernel(bundle, n_layers, res, t, out_dtype=dt)
        want = plain(bundle, n_layers, res, t, out_dtype=dt)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"kernel output {got.shape} {got.dtype} != {want.shape}")
        e = (got.float() - want.float()).abs().max().item()
        check(e == 0.0, f"{kernel.NAME} kernel differs from its plain "
              f"version by {e} at t={t}, {res}, {dt}")
        if dt == torch.float32:
            check(bool(((got == 0) | (got == 1)).all()),
                  f"{kernel.NAME} kernel's float32 output is not 0/1")
        err = max(err, e)
    return err


def live_copies(rk, idx, bw, counts, res):
    """(env, copy, nb, frame, b0, xb) of the bundle's live slots."""
    import torch

    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    k = idx.shape[1] - 7
    live = torch.arange(k, device=idx.device)[None] < counts[0][:, None]
    env, slot = torch.nonzero(live, as_tuple=True)
    e = idx[env, slot].long()
    word = bw[env, e]
    rowband = word >> 9
    frame = rowband // n_bands
    return env, e, word & 511, frame, rowband - frame * n_bands, frame % nxb


def box_extent(rk, res, x0, y0, x1, y1, r, nb, b0, xb):
    """(columns, rows) of each live copy's segment bounding box, padded by
    the stroke radius r and clipped to the copy's stamped bands and to the
    frame (0 for a copy with no band): the only pixels the copy can
    light."""
    import torch

    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    h, w = res

    def span(lo, hi, clip_lo, clip_hi):
        """Integer pixels in [lo, hi] and [clip_lo, clip_hi)."""
        first = torch.maximum(torch.ceil(lo), clip_lo.float())
        last = torch.minimum(torch.floor(hi), clip_hi.float() - 1)
        return torch.clamp_min(last - first + 1, 0)

    row0 = b0 * rk._GRAN
    rows = torch.clamp_min(nb, win // rk._GRAN) * rk._GRAN
    cols = span(torch.minimum(x0, x1) - r, torch.maximum(x0, x1) + r,
                torch.zeros_like(xb), torch.clamp_max(w - xb * rk._XB, wb))
    ys = span(torch.minimum(y0, y1) - r, torch.maximum(y0, y1) + r, row0,
              torch.clamp_max(row0 + rows, h))
    live = (nb > 0).double()
    return cols.double() * live, ys.double() * live


def bundle_bytes_and_ops(rk, bundle, res, t, out_bytes):
    """The least work of the masks or rank kernel over this bundle: the
    bytes it must move (the counts rows, the live slots' idx entries and
    their copies' six SoA entries read once, the output written once) and
    the float32 operations of the stamp over `box_extent`'s pixels. Pixels
    outside those boxes cannot be lit, so a kernel need not evaluate them
    (the kernels do: they evaluate the whole window)."""
    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    _, hp, _, _, _ = rk._frame_geometry(res)
    env, e, nb, frame, b0, xb = live_copies(rk, idx, bw, counts, res)
    stroke = rk._stroke_params(t)
    r = 0.0 if stroke[0] == "bres" else max(stroke[1], stroke[2]) ** 0.5
    x0, y0 = ax[env, e], ay[env, e] - (frame * hp).float()
    cols, rows = box_extent(rk, res, x0, y0, x0 + abx[env, e],
                            y0 + aby[env, e], r, nb, b0, xb)
    pixels = int((cols * rows).sum().item())
    n_in = counts.numel() * 4 + int(env.numel()) * (4 + 6 * 4)
    return n_in + out_bytes, pixels * OPS_PER_PIXEL[stroke[0]]


def exact_bytes_and_ops(rk, bundle, res, t, out_bytes):
    """The least work of the exact kernel over this bundle: bytes of the
    counts rows, the live slots' idx entries and their copies' 30 int32
    fields read once and the output written once; int32 operations of the
    exact stamp over `box_extent`, the boxes spanning the clipped integer
    endpoints (the cap fields) padded by the stroke's extent -- per pixel,
    per box row and per copy as EXACT_PIXEL_OPS, EXACT_ROW_OPS and
    EXACT_COPY_OPS count them, for the parts each copy's flags switch on
    (the fill span, each accepted ring edge as x- or y-major; both caps)."""
    import torch

    from tinycarlo_torch.ops.cv2_stroke import stroke_y_extent

    idx, fields, counts = bundle
    _, hp, _, _, _ = rk._frame_geometry(res)
    env, e, nb, frame, b0, xb = live_copies(rk, idx, fields[-1], counts, res)
    ends = []
    for c in (22, 23):
        cx, cy = rk._unpack16(fields[c][env, e])
        ends += [cx.float(), (cy - frame * hp).float()]
    cols, rows = box_extent(rk, res, *ends, stroke_y_extent(t), nb, b0, xb)
    flags = fields[28][env, e].long()

    def per_copy(ops):
        n = (flags & 1) * ops["fill"] + 2 * ops["cap"]
        for i in range(4):
            accepted = (flags >> (1 + i)) & 1
            x_major = (flags >> (5 + i)) & 1
            n = n + accepted * (ops["far"] + torch.where(
                x_major == 1, ops["x_major"], ops["y_major"]))
        return n.double()

    n_ops = (cols * rows * per_copy(EXACT_PIXEL_OPS)
             + rows * per_copy(EXACT_ROW_OPS)
             + (rows > 0) * EXACT_COPY_OPS).sum().item()
    n_in = counts.numel() * 4 + int(env.numel()) * (4 + rk.EXACT_FIELDS * 4)
    return n_in + out_bytes, int(n_ops)


def bound(n_bytes, n_ops, peak_ops):
    """(bound ms, "bytes" or "operations") on the H100."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def main():
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path runs on a GPU",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import rasterize as ras
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.ops._build import libraries
    from tinycarlo_torch.train.stanley import stanley_steering

    # ---- 2. build ----------------------------------------------------------
    libraries.build()
    print(f"build: {libraries.build_seconds:.2f} s "
          f"({', '.join(sorted(libraries.build_log)) or 'cached'})")
    for src, log in sorted(libraries.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    params = fenv.make_env_params(CONFIG)
    params_exact = with_stroke(params, "exact")
    max_err, rank_err = check_kernels(rk, ras, fenv, vector, params, "cuda")
    exact_err = check_exact_kernels(rk, fenv, vector, params_exact, "cuda")

    # ---- 4. main path --------------------------------------------------------
    kernels = [classes_path(card, rk, fenv, vector, stanley_steering, params,
                            max_err, FAST_REPEATS)]

    # ---- 5. exact classes ----------------------------------------------------
    exact_entry = classes_path(card, rk, fenv, vector, stanley_steering,
                               params_exact, exact_err, REPEATS)
    check_exact_oracle(fenv, rk, params_exact, exact_entry.pop("run"))

    # ---- 6, 7. serving, fast and exact --------------------------------------
    kernels[0].pop("run")
    # the protocols' three maneuvers run at once, one worker process each:
    # at B = 1 or 5 a step is host-bound
    with multiprocessing.get_context("spawn").Pool(
            3, initializer=protocol_worker_init) as pool:
        kernels.append(serve(card, rank_err, pool))
        kernels.append(exact_entry)
        serve_exact(card, pool)

    # ---- 8. results ----------------------------------------------------------
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s after the "
          f"device check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


def classes_path(card, rk, fenv, vector, stanley_steering, params, err,
                 repeats):
    """Phases 4 and 5: the bench workload on the params' stroke, its
    checks and stage times. Returns the kernel's entry of the `kernels`
    line, with the run under "run"."""
    import torch

    compact, kernel, plain, symbol = kernel_pair(rk, params)
    exact = kernel is rk.exact_kernel
    what = "exact classes" if exact else "main path"
    for k in (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    run = run_main_path(fenv, vector, stanley_steering, params, N_ENVS,
                        CHUNK, repeats)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel.launches
    renders = run["steps"]
    check(launches == renders,
          f"{kernel.NAME} kernel launched {launches} times for {renders} "
          "renders")
    others = [k.NAME for k in (rk.masks_kernel, rk.rank_kernel,
                               rk.exact_kernel)
              if k is not kernel and k.launches]
    check(not others, f"the {what} ran the {others} kernel")
    check(run["checksum"] > 0, "observations were not rendered")
    rates = sorted(run["rates"])
    print(f"{what}: {N_ENVS} envs x {renders} steps, {launches} "
          f"{kernel.NAME} kernel launches, checksum {run['checksum']}")
    print(f"{what} env-steps/s: median {statistics.median(rates):.1f} "
          f"(min {rates[0]:.1f}, max {rates[-1]:.1f}, {repeats} repeats of "
          f"{CHUNK} steps) on {card}; peak memory {peak_gb:.2f} GB")

    check_outputs(fenv, rk, params, run)
    compare_with_cpu(fenv, vector, stanley_steering, params)
    times = stage_times(fenv, vector, rk, params, run["vstate"])
    wall_ms = 1e3 * N_ENVS / statistics.median(rates)
    busy_ms, top, by_name = device_profile(lambda: run["body"](
        run["vstate"], run["info"], torch.zeros((), dtype=torch.int64,
                                                device="cuda")))
    times["kernel_device"] = kernel_device_ms(by_name, symbol)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    print(f"{what} per step at {N_ENVS} envs on {card}, event ms / "
          "device-busy ms:")
    for key in ("projection", "compaction", "kernel", "step"):
        print(f"  {key}: {times[key]:.4f} ms / {fmt(times[key + '_device'])}")
    print(f"  plain version of the {kernel.NAME} kernel: "
          f"{times['plain']:.4f} ms")
    if busy_ms is None:
        print(f"{what} step: device busy share not measured (the "
              "profiler trace holds no device time)")
    else:
        print(f"{what} step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    out_bytes = N_ENVS * md.n_layers * res[0] * res[1]
    if exact:
        n_bytes, n_ops = exact_bytes_and_ops(rk, times["bundle"], res, t,
                                             out_bytes)
        bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_I32_PER_S)
        kind = "int32"
    else:
        n_bytes, n_ops = bundle_bytes_and_ops(rk, times["bundle"], res, t,
                                              out_bytes)
        bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_F32_PER_S)
        kind = "float32"
    print(f"{kernel.NAME} kernel bound on {card}: {n_bytes / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP {kind} -> {t_ops:.4f} ms:"
          f" {by} bind")
    replaces = {
        "masks": "tinycarlo_tpu/ops/rasterize_pallas.py:1931 "
                 "(_kernel_env_idx), "
                 "tinycarlo_tpu/ops/rasterize_pallas.py:2107 "
                 "(_kernel_env_dma)",
        "exact": "tinycarlo_tpu/ops/rasterize_pallas.py:2904 "
                 "(_kernel_env_exact)",
    }[kernel.NAME]
    return {
        "name": kernel.NAME,
        "route": "cuda",
        "source": f"tinycarlo_torch/ops/csrc/{kernel.NAME}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
        "bound_ms": bound_ms,
        "bound_by": by,
        # no single PyTorch call rasterizes compacted segment stamps into
        # per-layer masks, so there is no library yardstick
        "library_ms": None,
        "run": run,
    }


def bench_bundle(fenv, rk, params, states, projection=None):
    """The production compaction bundle of these states (bench budget),
    of the params' stroke."""
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    nxb = rk._n_xblocks(res[1])
    k = min(params.cfg.camera.max_visible_segments * nxb,
            md.packed_edges.shape[1] * nxb)
    u0, v0, u1, v1, draw = (
        projection or fenv._project_packed_batch_soa(params, states)
    )
    return kernel_pair(rk, params)[0](
        u0, v0, u1, v1, draw, k, res[0], params.cfg.camera.line_thickness,
        edge_layer=md.packed_edge_layer, n_layers=md.n_layers, w=res[1],
        layer_bounds=md.packed_layer_bounds,
    )


def rank_vs_plain(rk, ras, bundle, n_layers, res, t):
    """Max |rank kernel - plain| and |rank kernel - rank_from_masks(masks
    kernel)| on one bundle (0 expected)."""
    import torch

    got = rk.rank_kernel(bundle, n_layers, res, t)
    want = rk.rasterize_rank_env_plain(bundle, n_layers, res, t)
    via_masks = ras.rank_from_masks(rk.masks_kernel(bundle, n_layers, res, t))
    check(got.shape == want.shape == via_masks.shape
          and got.dtype == want.dtype == torch.uint8,
          f"rank kernel output {got.shape} {got.dtype} != {want.shape}")
    err = max((got.float() - want.float()).abs().max().item(),
              (got.float() - via_masks.float()).abs().max().item())
    check(err == 0.0, f"rank kernel differs from its plain version or the "
          f"masks kernel's ranks by {err} at t={t}, {res}")
    return err


def check_kernels(rk, ras, fenv, vector, params, dev):
    """The masks and rank kernels against their plain versions (and the
    rank kernel against the masks kernel's ranks); returns the max |error|
    of each."""
    masks_err = rank_err = 0.0
    cases = [
        # (seed, B, E, h, w, t, k per block)
        (1, 64, 120, 128, 160, 1, 120),
        (2, 64, 120, 30, 48, 2, 120),
        (3, 64, 120, 128, 160, 3, 8),   # oversubscribed budget
        (4, 32, 200, 64, 160, 2, 200),
        (5, 32, 80, 30, 160, 1, 80),
        # 480x640 (knuffingen's high-res shape): a 61 KB strip, above the
        # 48 KB default shared-memory limit
        (6, 16, 200, 480, 640, 2, 200),
    ]
    for seed, b, e, h, w, t, kb in cases:
        bundle = random_bundle(rk, seed, b, e, h, w, t, kb, dev)
        check(int(bundle[-1][0, 0]) == 0, "env 0 should have no live slot")
        if kb < e:
            check(int(bundle[-1][3].sum()) > 0, "budget not oversubscribed")
        masks_err = max(masks_err, kernel_vs_plain(
            rk.masks_kernel, rk.rasterize_masks_env_plain, bundle, 5, (h, w),
            t))
        rank_err = max(rank_err, rank_vs_plain(rk, ras, bundle, 5, (h, w), t))
    real, _ = vector.reset(params, 384, seed=1, render=False)
    real_bundle = bench_bundle(fenv, rk, params, real.env)
    geometry = (params.map_data.n_layers, tuple(params.cfg.camera.resolution),
                params.cfg.camera.line_thickness)
    masks_err = max(masks_err, kernel_vs_plain(
        rk.masks_kernel, rk.rasterize_masks_env_plain, real_bundle,
        *geometry))
    rank_err = max(rank_err, rank_vs_plain(rk, ras, real_bundle, *geometry))
    print(f"kernels: masks kernel equal to its plain version on "
          f"{len(cases)} random bundles and 384 real envs, uint8 and "
          f"float32; rank kernel equal to its plain version and to "
          f"rank_from_masks of the masks kernel on the same bundles")
    return masks_err, rank_err


def check_exact_kernels(rk, fenv, vector, params_exact, dev):
    """The exact kernel against its plain version, bit for bit, on random
    exact bundles and on real bundles of the bench states; returns the max
    |error|."""
    err = 0.0
    cases = [
        # (seed, B, E, h, w, t, k per block)
        (11, 64, 120, 48, 96, 2, 120),
        (12, 64, 120, 128, 160, 3, 120),
        (13, 64, 120, 128, 160, 5, 8),   # oversubscribed budget
        (14, 32, 160, 128, 160, 2, 160),
        (15, 16, 200, 480, 640, 3, 200),
        (16, 16, 200, 480, 640, 5, 200),
    ]
    for seed, b, e, h, w, t, kb in cases:
        bundle = random_bundle(rk, seed, b, e, h, w, t, kb, dev, exact=True)
        counts = bundle[-1]
        check(int(counts[0, 0]) == 0, "env 0 should have no live slot")
        check(int(counts[0, 1:].min()) > 0, "an env has no live slot")
        if kb < e:
            check(int(counts[3].sum()) > 0, "budget not oversubscribed")
        err = max(err, kernel_vs_plain(
            rk.exact_kernel, rk.rasterize_masks_exact_env_plain, bundle, 5,
            (h, w), t))
    real, _ = vector.reset(params_exact, 384, seed=1, render=False)
    bundle = bench_bundle(fenv, rk, params_exact, real.env)
    err = max(err, kernel_vs_plain(
        rk.exact_kernel, rk.rasterize_masks_exact_env_plain, bundle,
        params_exact.map_data.n_layers,
        tuple(params_exact.cfg.camera.resolution),
        params_exact.cfg.camera.line_thickness))
    print(f"kernels: exact kernel equal to its plain version on "
          f"{len(cases)} random exact bundles (t = 2, 3, 5; 48x96, "
          f"128x160, 480x640) and 384 real envs, uint8 and float32 (0/1)")
    return err


def run_main_path(fenv, vector, stanley_steering, params, n_envs, chunk,
                  repeats):
    """bench.py's loop (bench.py:78-111) through the port's entry points."""
    import torch

    dev = params.device
    max_steer = params.cfg.car.max_steering_angle
    vstate, _ = vector.reset(params, n_envs, seed=0, render=False)
    overflow = int(fenv.check_segment_overflow(params, vstate.env).sum())
    check(overflow == 0, f"{overflow} rasterizer slot copies dropped -- "
          "raise CameraConfig.max_visible_segments")
    info = fenv._info(params, vstate.env)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)
    speed = torch.full((n_envs,), SPEED, device=dev)
    maneuver = torch.zeros(n_envs, dtype=torch.int32, device=dev)

    def body(vstate, info, checksum):
        obs = fenv.render_observation_batch(params, vstate.env)
        # consume the observation (a contiguous 4-row band, as bench.py)
        checksum = checksum + obs[..., 60:64, :].sum(dtype=torch.int64)
        steering = torch.clamp(stanley_steering(
            info["cte"], info["heading_error"], SPEED, K, max_steer
        ), -1.0, 1.0)
        action = {"car_control": torch.stack([speed, steering], dim=-1),
                  "maneuver": maneuver}
        vstate, _, rew, term, trunc, info = vector.step(
            params, vstate, action, render=False, max_episode_steps=1000
        )
        return vstate, info, checksum, obs, rew

    for _ in range(WARMUP):
        vstate, info, checksum, obs, rew = body(vstate, info, checksum)
    sync(dev)
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        for _ in range(chunk):
            rendered = vstate.env
            vstate, info, checksum, obs, rew = body(vstate, info, checksum)
        sync(dev)
        rates.append(n_envs * chunk / (time.perf_counter() - start))
    return {"body": body, "vstate": vstate, "info": info, "obs": obs,
            "rew": rew,
            "rendered": rendered, "checksum": int(checksum), "rates": rates,
            "n_envs": n_envs, "steps": WARMUP + repeats * chunk}


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_outputs(fenv, rk, params, run):
    """Shapes, values and finiteness of the classes path's outputs, and its
    last observation against the plain version on the same states."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    obs = run["obs"]
    check(tuple(obs.shape) == (run["n_envs"], md.n_layers) + res
          and obs.dtype == torch.uint8,
          f"observation {tuple(obs.shape)} {obs.dtype}")
    check(bool(((obs == 0) | (obs == 255)).all()), "masks not 0/255")
    check(bool(torch.isfinite(run["rew"]).all()), "non-finite reward")
    for key, val in run["info"].items():
        check(bool(torch.isfinite(val.float()).all()), f"non-finite {key}")
    plain = kernel_pair(rk, params)[2](
        bench_bundle(fenv, rk, params, run["rendered"]), md.n_layers, res,
        params.cfg.camera.line_thickness,
    )
    check(torch.equal(obs, plain),
          "classes observation differs from the plain version")


def check_exact_oracle(fenv, rk, params, run):
    """The exact frames of ORACLE_ENVS envs of the exact path's last render
    against the port's pure-Python cv2 oracle, segment by segment on the
    int32-truncated endpoints: the card's frames rendered from the same
    endpoints in float64 must equal it bit for bit (cv2 equality on a
    machine without cv2); the float32 frames of the run may differ from
    them only where float32 rounds the stroke's clips and quad (the JAX
    package's documented float32 drift), on under 0.5% of the pixels."""
    import numpy as np
    import torch

    from tinycarlo_torch.ops.cv2_stroke import thick_stroke_mask_ref
    from tinycarlo_torch.ops.rasterize import _int_endpoints

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n = ORACLE_ENVS
    env = dataclasses.replace(
        run["rendered"], car=type(run["rendered"].car)(**{
            f.name: getattr(run["rendered"].car, f.name)[:n]
            for f in dataclasses.fields(run["rendered"].car)}))
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, env)
    f64 = rk.rasterize_masks_packed_soa(
        u0.double(), v0.double(), u1.double(), v1.double(), draw,
        md.packed_edge_layer, md.n_layers, res, t,
        max_visible=params.cfg.camera.max_visible_segments,
        layer_bounds=md.packed_layer_bounds, stroke="exact",
    ).cpu().numpy()
    f32 = run["obs"][:n].cpu().numpy()
    a, b = _int_endpoints(torch.stack([u0, v0], -1), torch.stack([u1, v1], -1),
                          torch.float64)
    a, b = a.long().cpu().numpy(), b.long().cpu().numpy()
    draw = draw.cpu().numpy()
    lay = md.packed_edge_layer.cpu().numpy()
    segs = 0
    for i in range(n):
        for l in range(md.n_layers):
            want = np.zeros(res, bool)
            for e in np.flatnonzero(draw[i] & (lay == l)):
                want |= thick_stroke_mask_ref(a[i, e], b[i, e], t, res)
                segs += 1
            got = f64[i, l] > 0
            check(np.array_equal(got, want),
                  f"exact frame of env {i}, layer {l} differs from the cv2 "
                  f"oracle on {int((got != want).sum())} pixels")
    drift = float((f32 != f64).mean())
    check(drift < 0.005, f"float32 exact frames differ from float64 on "
          f"{drift:.4%} of pixels")
    print(f"cv2 oracle: {n} envs x {md.n_layers} layers ({segs} segments) "
          f"of exact frames equal to thick_stroke_mask_ref bit for bit "
          f"(float64 bundle); the float32 frames differ from them on "
          f"{drift:.4%} of pixels")


def device_profile(fn, calls=5):
    """(device-busy ms per call, top kernels, {kernel name: (ms per call,
    records per call)}) of fn() from a torch.profiler trace: the sum of the
    CUDA kernels' device time over `calls` calls; (None, [], {}) if the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None, [], {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    by_name = {e.key: (e.self_device_time_total / 1e3 / calls,
                       e.count / calls) for e in kernels}
    return busy_us / 1e3 / calls, [
        (e.key[:70], e.self_device_time_total / 1e3 / calls, e.count // calls)
        for e in top
    ], by_name


def kernel_device_ms(by_name, symbol):
    """Device ms per step of the port's kernel `symbol` in a step's trace
    (device_profile's by_name), or None unless the trace holds exactly one
    record of it per step.

    A kernel's device time is read from the whole step's trace, not from a
    trace of the kernel alone: late in this script (after the serving
    protocol), traces of the rank or the masks kernel alone held their
    cudaLaunchKernel calls but no kernel record, also with a library
    linked against the shared CUDA runtime, while the serving step's
    traces held one record per launch. The cause is not known; the
    record count is checked here."""
    hits = [v for key, v in by_name.items() if symbol in key]
    if len(hits) != 1 or hits[0][1] != 1:
        return None
    return hits[0][0]


def stage_times(fenv, vector, rk, params, vstate):
    """Per-stage ms of one render and one step at the classes path's batch:
    stream time between CUDA events ("ms", which includes the gaps while
    the host enqueues eager kernels) and device-busy time from a profiler
    trace ("device_ms"; the kernel's comes from the whole step's trace,
    see kernel_device_ms)."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    _, kernel, plain, _ = kernel_pair(rk, params)
    n = vstate.episode_step.shape[0]
    proj = fenv._project_packed_batch_soa(params, vstate.env)
    bundle = bench_bundle(fenv, rk, params, vstate.env, projection=proj)
    action = {"car_control": torch.full((n, 2), SPEED, device="cuda"),
              "maneuver": torch.zeros(n, dtype=torch.int32, device="cuda")}
    stages = {
        "projection": lambda: fenv._project_packed_batch_soa(
            params, vstate.env),
        "compaction": lambda: bench_bundle(fenv, rk, params, None,
                                           projection=proj),
        "kernel": lambda: kernel(bundle, md.n_layers, res, t),
        "step": lambda: vector.step(params, vstate, action, render=False,
                                    max_episode_steps=1000),
    }
    out = {"bundle": bundle}
    for key, fn in stages.items():
        out[key] = cuda_ms(fn, repeats=20 if key == "kernel" else 7)
        if key != "kernel":  # its device ms: see kernel_device_ms
            out[key + "_device"] = device_profile(fn)[0]
    out["plain"] = cuda_ms(lambda: plain(bundle, md.n_layers, res, t),
                           repeats=5, warmup=1)
    return out


def exact_bundle_rows(bundle):
    """(B, ...) int32 rows of an exact compaction bundle on the CPU, one
    per env: its counts column, then each slot's copy index and 30 fields,
    zero for a dead slot -- what the kernel reads. (The compaction also
    fills the fields of copies no slot reads, among them undrawn segments
    projected to ~1e9 px, where float32 differs between the devices.)"""
    import torch

    idx, fields, counts = bundle
    live = (torch.arange(idx.shape[1], device=idx.device)[None]
            < counts[0][:, None])
    stacked = torch.stack(fields, -1)  # (B, LE, 30)
    slots = stacked.gather(1, idx.long()[..., None].expand(
        -1, -1, stacked.shape[-1]))
    rows = torch.cat([idx[..., None], slots], -1) * live[..., None]
    return torch.cat([counts.T, rows.flatten(1)], 1).cpu()


def exact_frames_follow_bundles(frames, bundles):
    """Under the exact stroke a frame is a function of its env's bundle
    (integer fields; the kernel is bit-equal to its plain version). Checks
    that every card frame whose env has the CPU port's bundle equals the
    CPU port's frame; returns the number of frames whose bundles differ.
    `frames` and `bundles` hold the card's and the CPU's, each (N, ...)
    with N frames."""
    same = (bundles[0] == bundles[1]).flatten(1).all(1)
    differ = (frames[0] != frames[1]).flatten(1).any(1)
    check(not bool((same & differ).any()), "exact frames "
          f"{(same & differ).nonzero().flatten().tolist()} differ between "
          "the card and the CPU port although their bundles are equal")
    return int((~same).sum())


def compare_with_cpu(fenv, vector, stanley_steering, params_gpu):
    """8 envs, 20 steps of Stanley control on the card and on the CPU port
    (same spawn and respawn rows): car states within 1e-4 (float32 libm and
    matmul rounding differ between the two devices) and observations
    differing on under 0.5% of pixels (an endpoint that truncates to the
    other integer moves a stroke). Under the exact stroke the last frames
    must be equal in every env whose exact bundle is equal on both
    devices."""
    import torch

    from tinycarlo_torch.ops import rasterize_kernels as rk

    params_cpu = fenv.make_env_params(params_gpu.cfg, device="cpu")
    exact = kernel_pair(rk, params_cpu)[1] is rk.exact_kernel
    n, steps = 8, 20
    rows = torch.arange(n) % params_cpu.map_data.spawns.count
    states, obs, bundles = [], [], []
    for params in (params_gpu, params_cpu):
        dev = params.device
        vstate, o = vector.reset(params, n, spawn_rows=rows.to(dev))
        info = fenv._info(params, vstate.env)
        for _ in range(steps):
            steer = torch.clamp(stanley_steering(
                info["cte"], info["heading_error"], SPEED, K,
                params.cfg.car.max_steering_angle), -1.0, 1.0)
            action = {"car_control": torch.stack(
                [torch.full_like(steer, SPEED), steer], -1),
                "maneuver": torch.zeros(n, dtype=torch.int32, device=dev)}
            vstate, o, _, _, _, info = vector.step(
                params, vstate, action, max_episode_steps=12,
                respawn_rows=rows.to(dev),
            )
        states.append(vstate.env.car.position.cpu())
        obs.append(o.cpu())
        if exact:
            bundles.append(exact_bundle_rows(bench_bundle(
                fenv, rk, params, vstate.env)))
    err = (states[0] - states[1]).abs().max().item()
    check(err < 1e-4, f"GPU and CPU car positions differ by {err}")
    frac = (obs[0] != obs[1]).float().mean().item()
    check(frac < 0.005, f"GPU and CPU observations differ on {frac:.4%}")
    moved = ""
    if exact:
        moved = (f"; {exact_frames_follow_bundles(obs, bundles)} of {n} "
                 "envs' exact bundles differ, every other frame is equal")
    print(f"cpu check ({params_gpu.cfg.camera.stroke} stroke): 8 envs x 20 "
          f"steps, positions within {err:.2e}, observations differ on "
          f"{frac:.4%} of pixels{moved}")


def serving_setup(stroke):
    """(params, combo policy) of the example's config with `stroke`."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.models.tinycar_net import load_pretrained
    from tinycarlo_torch.train.evaluate import combo_policy

    params = with_stroke(fenv.make_env_params(SERVE_CONFIG), stroke)
    check(params.cfg.sim.observation_space_format == "rgb",
          "the example's config should render rgb")
    model = load_pretrained(fenv.observation_shape(params))
    check(model is not None, "no bundled combo for the example's frames")
    return params, combo_policy(model)


def protocol_worker_init():
    """A protocol worker's float32 settings: the parent's (TF32 off)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_WORKER_SETUP = {}


def protocol_maneuver(stroke, maneuver, steps, episodes, sequential):
    """One maneuver of a serving protocol, in a worker process: evaluate's
    metrics at SERVE_SEED (without the positions) and, under "launches",
    each render kernel's launch count in this call."""
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import evaluate

    if stroke not in _WORKER_SETUP:
        _WORKER_SETUP[stroke] = serving_setup(stroke)
    params, act = _WORKER_SETUP[stroke]
    kernels = (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel)
    for k in kernels:
        k.launches = 0
    r = evaluate(act, params, maneuver, None, seed=SERVE_SEED, steps=steps,
                 episodes=episodes, sequential=sequential)
    del r["positions"]
    r["launches"] = {k.NAME: k.launches for k in kernels}
    return r


def serving_protocol(pool, params, act, kernel, steps, episodes, budget_s,
                     sequential):
    """Maneuvers 0, 1, 2 through `evaluate` at seed 10, one per process of
    `pool` at the same time (each evaluate call seeds its own generator,
    so the metrics are those of three calls in a row): each cte_avg finite
    and below CTE_LIMIT, `kernel` launched once per render and no other
    render kernel. Steps are cut (and the cut printed) if one maneuver
    would take over `budget_s` at the per-step time this process
    measures."""
    import numpy as np

    from tinycarlo_torch.train.evaluate import evaluate

    # timed after a warm-up: the first forward initialises cuDNN
    evaluate(act, params, 0, None, seed=SERVE_SEED, steps=5, episodes=episodes,
             sequential=sequential)
    probe = 20
    start = time.perf_counter()
    evaluate(act, params, 0, None, seed=SERVE_SEED, steps=probe,
             episodes=episodes, sequential=sequential)
    per_step = (time.perf_counter() - start) / probe
    if sequential:
        per_step /= episodes  # a sequential call steps episodes * steps times
    runs = episodes if sequential else 1
    full = steps
    if steps * runs * per_step > budget_s:
        steps = max(100, int(budget_s / (runs * per_step)) // 100 * 100)
        print(f"{kernel.NAME} serving protocol: steps cut from {full} to "
              f"{steps} ({per_step * 1e3:.2f} ms per step)")
    renders = steps * episodes if sequential else steps
    start = time.perf_counter()
    results = pool.starmap(protocol_maneuver, [
        (params.cfg.camera.stroke, maneuver, steps, episodes, sequential)
        for maneuver in range(3)])
    for maneuver, r in enumerate(results):
        launches = r["launches"]
        check(launches[kernel.NAME] == renders,
              f"{kernel.NAME} kernel launched {launches[kernel.NAME]} times "
              f"for {renders} renders")
        others = [name for name, count in launches.items()
                  if name != kernel.NAME and count]
        check(not others, f"the rgb path ran the {others} kernel")
        print(
            f"Maneuver {maneuver} -> Total reward: {r['total_reward']:.2f} | "
            f"CTE: {r['cte_avg']:.4f} m/step var: {r['cte_var']:.4f} | "
            f"Heading Error: {r['heading_error_avg']:.4f} rad/step var "
            f"{r['heading_error_var']:.4f} | Terminations: "
            f"{r['terminations']:3d} | perf: {r['steps_per_s']:.2f} steps/s"
        )
        check(np.isfinite(r["cte_avg"]) and r["cte_avg"] < CTE_LIMIT,
              f"maneuver {maneuver}: cte_avg {r['cte_avg']} is not below "
              f"{CTE_LIMIT} m")
    print(f"{kernel.NAME} serving protocol: 3 maneuvers x {episodes} "
          f"{'sequential ' if sequential else ''}episodes x {steps} steps in "
          f"{time.perf_counter() - start:.1f} s (one process per maneuver)")


def serving_batch(card, params, act, kernel, repeats):
    """4096 episodes of CHUNK steps, `repeats` times, after a warm-up:
    env-steps/s with the policy and `kernel` launched once per render.
    Returns the median rate and the peak memory in GB."""
    import warnings

    import numpy as np
    import torch

    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import evaluate

    for k in (rk.masks_kernel, rk.rank_kernel, rk.exact_kernel):
        k.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        evaluate(act, params, 0, None, seed=0, steps=WARMUP,
                 episodes=N_ENVS)
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for rep in range(repeats):
            r = evaluate(act, params, 0, None, seed=1 + rep, steps=CHUNK,
                         episodes=N_ENVS)
            check(np.isfinite(r["cte_avg"]) and np.isfinite(r["positions"])
                  .all(), "non-finite serving metrics")
            rates.append(r["steps_per_s"])
    dropped = [str(w.message) for w in caught if "dropped" in str(w.message)]
    check(not dropped, f"segment overflow while serving: {dropped}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel.launches
    renders = WARMUP + repeats * CHUNK
    check(launches == renders,
          f"{kernel.NAME} kernel launched {launches} times for {renders} "
          "renders")
    others = [k.NAME for k in (rk.masks_kernel, rk.rank_kernel,
                               rk.exact_kernel)
              if k is not kernel and k.launches]
    check(not others, f"the rgb path ran the {others} kernel")
    rates.sort()
    print(f"{kernel.NAME} serving: {N_ENVS} envs x {renders} steps, "
          f"{launches} {kernel.NAME} kernel launches")
    print(f"{kernel.NAME} serving env-steps/s (policy included): median "
          f"{statistics.median(rates):.1f} (min {rates[0]:.1f}, max "
          f"{rates[-1]:.1f}, {repeats} repeats of {CHUNK} steps) on {card}; "
          f"peak memory {peak_gb:.2f} GB")
    return statistics.median(rates), peak_gb


def serving_step_fn(params, act):
    """(vstate, one iteration of evaluate's loop at 4096 envs)."""
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.train.evaluate import standard_stack

    stack = standard_stack()
    vstate, _ = vector.reset(params, N_ENVS, seed=0, stack=stack,
                             render=False)
    m = torch.zeros(N_ENVS, dtype=torch.int32, device=params.device)

    def serving_step(vstate):
        obs = fenv.render_observation_batch(params, vstate.env)
        steering, _ = act(obs, m, None)
        action = {"car_control": torch.stack(
            [torch.full_like(steering, 0.35), steering], dim=-1),
            "maneuver": m}
        return vector.step(params, vstate, action, stack=stack,
                           render=False)[0]

    return vstate, stack, m, serving_step


def serve(card, rank_err, pool):
    """Phase 6: the bundled combo served on rgb frames through the port's
    evaluate, the protocol's maneuvers in `pool`'s processes. Returns the
    rank kernel's entry of the `kernels` line."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import rasterize as ras
    from tinycarlo_torch.ops import rasterize_kernels as rk

    params, act = serving_setup("fast")
    serving_protocol(pool, params, act, rk.rank_kernel, SERVE_STEPS,
                     SERVE_EPISODES, SERVE_BUDGET_S, sequential=False)
    rate, peak_gb = serving_batch(card, params, act, rk.rank_kernel,
                                  FAST_REPEATS)
    launches = rk.rank_kernel.launches

    vstate, stack, m, serving_step = serving_step_fn(params, act)
    times = serving_stage_times(fenv, vector, rk, ras, params, vstate, act,
                                stack, m)
    wall_ms = 1e3 * N_ENVS / rate
    busy_ms, top, by_name = device_profile(lambda: serving_step(vstate))
    times["rank kernel_device"] = kernel_device_ms(by_name, "rank_kernel")
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    print(f"serving per step at {N_ENVS} envs on {card}, event ms / "
          f"device-busy ms:")
    for key in ("projection", "compaction", "rank kernel", "rgb composite",
                "policy", "step"):
        print(f"  {key}: {times[key]:.4f} ms / {fmt(times[key + '_device'])}")
    print(f"  plain version of the rank kernel: {times['plain']:.4f} ms")
    if busy_ms is None:
        print("serving step: device busy share not measured (the profiler "
              "trace holds no device time)")
    else:
        print(f"serving step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"peak memory {peak_gb:.2f} GB")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")

    compare_serving_with_cpu(fenv, vector, params, act)

    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n_bytes, n_ops = bundle_bytes_and_ops(rk, times["bundle"], res, t,
                                          N_ENVS * res[0] * res[1])
    bound_ms, by, t_bytes, t_ops = bound(n_bytes, n_ops, PEAK_F32_PER_S)
    print(f"rank kernel bound on {card}: {n_bytes / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP f32 -> {t_ops:.4f} ms")
    return {
        "name": "rank",
        "route": "cuda",
        "source": "tinycarlo_torch/ops/csrc/rank.cu",
        "replaces": "tinycarlo_tpu/ops/rasterize_pallas.py:1493 "
                    "(_kernel_env_rank)",
        "launches": launches,
        "max_abs_err": rank_err,
        "ms": times["rank kernel"],
        "plain_ms": times["plain"],
        "bound_ms": bound_ms,
        "bound_by": by,
        # no single PyTorch call rasterizes compacted segment stamps into
        # a layer-rank map, so there is no library yardstick
        "library_ms": None,
    }


def serve_exact(card, pool):
    """Phase 7: the bundled combo on the exact stroke's rgb frames (the
    exact kernel's masks, decoded): policy_parity.py's protocol (its
    maneuvers in `pool`'s processes), 4096 envs, and the card against the
    CPU port."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.ops import rasterize_kernels as rk

    params, act = serving_setup("exact")
    serving_protocol(pool, params, act, rk.exact_kernel, EXACT_SERVE_STEPS,
                     EXACT_SERVE_EPISODES, EXACT_SERVE_BUDGET_S,
                     sequential=True)
    rate, peak_gb = serving_batch(card, params, act, rk.exact_kernel,
                                  FAST_REPEATS)
    vstate, _, _, serving_step = serving_step_fn(params, act)
    busy_ms, top, by_name = device_profile(lambda: serving_step(vstate))
    wall_ms = 1e3 * N_ENVS / rate
    kernel_ms = kernel_device_ms(by_name, "exact_kernel")
    if busy_ms is None:
        print("exact serving step: device busy share not measured (the "
              "profiler trace holds no device time)")
    else:
        kernel_ms = "not measured" if kernel_ms is None else f"{kernel_ms:.4f}"
        print(f"exact serving step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"exact kernel {kernel_ms} ms device, peak memory "
              f"{peak_gb:.2f} GB")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")
    compare_serving_with_cpu(fenv, vector, params, act)


def serving_stage_times(fenv, vector, rk, ras, params, vstate, act, stack,
                        m):
    """Per-stage ms of one serving step at 4096 envs: event ms and profiler
    device ms (see stage_times; the rank kernel's device ms comes from the
    whole step's trace), and the rank kernel's plain version."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n = m.shape[0]
    proj = fenv._project_packed_batch_soa(params, vstate.env)
    bundle = bench_bundle(fenv, rk, params, vstate.env, projection=proj)
    rank = rk.rank_kernel(bundle, md.n_layers, res, t)
    obs = ras.rgb_from_rank(rank, md.laneline_colors)
    action = {"car_control": torch.full((n, 2), 0.35, device=m.device),
              "maneuver": m}
    stages = {
        "projection": lambda: fenv._project_packed_batch_soa(
            params, vstate.env),
        "compaction": lambda: bench_bundle(fenv, rk, params, None,
                                           projection=proj),
        "rank kernel": lambda: rk.rank_kernel(bundle, md.n_layers, res, t),
        "rgb composite": lambda: ras.rgb_from_rank(rank, md.laneline_colors),
        "policy": lambda: act(obs, m, None),
        "step": lambda: vector.step(params, vstate, action, stack=stack,
                                    render=False),
    }
    out = {"bundle": bundle}
    for key, fn in stages.items():
        out[key] = cuda_ms(fn, repeats=20 if key == "rank kernel" else 7)
        if key != "rank kernel":  # its device ms: see kernel_device_ms
            out[key + "_device"] = device_profile(fn)[0]
    out["plain"] = cuda_ms(lambda: rk.rasterize_rank_env_plain(
        bundle, md.n_layers, res, t), repeats=5, warmup=1)
    return out


def compare_serving_with_cpu(fenv, vector, params_gpu, act_gpu):
    """8 envs, 20 combo-driven steps of the serving path on the card and on
    the CPU port (same spawn and respawn rows, each device's own combo and
    frames): steering within STEER_ATOL at every (step, env) whose frames
    are equal, within STEER_ATOL_MOVED where they differ, and rgb frames
    that differ on under 0.5% of pixels. Under the exact stroke every
    frame whose env has the same exact bundle on both devices must be
    equal."""
    import torch

    from tinycarlo_torch.models.tinycar_net import load_pretrained
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import combo_policy, standard_stack

    params_cpu = fenv.make_env_params(params_gpu.cfg, base_path=SERVE_CONFIG,
                                      device="cpu")
    exact = kernel_pair(rk, params_cpu)[1] is rk.exact_kernel
    act_cpu = combo_policy(load_pretrained(
        fenv.observation_shape(params_cpu), device="cpu"))
    n, steps = 8, 20
    rows = torch.arange(n) % params_cpu.map_data.spawns.count
    m = torch.arange(n, dtype=torch.int32) % 3
    steer, frames, bundles = [], [], []
    for params, act in ((params_gpu, act_gpu), (params_cpu, act_cpu)):
        dev = params.device
        stack = standard_stack()
        vstate, _ = vector.reset(params, n, stack=stack, render=False,
                                 spawn_rows=rows.to(dev))
        s_run, f_run, b_run = [], [], []
        for _ in range(steps):
            obs = fenv.render_observation_batch(params, vstate.env)
            s, _ = act(obs, m.to(dev), None)
            s_run.append(s.cpu())
            f_run.append(obs.cpu())
            if exact:
                b_run.append(exact_bundle_rows(bench_bundle(
                    fenv, rk, params, vstate.env)))
            action = {"car_control": torch.stack(
                [torch.full_like(s, 0.35), s], dim=-1),
                "maneuver": torch.where(m != 2, m, 3).to(dev)}
            vstate = vector.step(params, vstate, action, stack=stack,
                                 render=False, max_episode_steps=12,
                                 respawn_rows=rows.to(dev))[0]
        steer.append(torch.stack(s_run))
        frames.append(torch.stack(f_run))
        if exact:
            bundles.append(torch.cat(b_run))
    diff = (frames[0] != frames[1]).any(-1)  # (steps, n, H, W)
    moved = diff.flatten(2).any(-1)  # (steps, n): the frames differ
    err = (steer[0] - steer[1]).abs()
    err_equal = err[~moved].max().item() if (~moved).any() else 0.0
    err_moved = err[moved].max().item() if moved.any() else 0.0
    check(err_equal < STEER_ATOL, f"GPU and CPU steering differ by "
          f"{err_equal} on equal frames")
    check(err_moved < STEER_ATOL_MOVED, f"GPU and CPU steering differ by "
          f"{err_moved} where the frames differ")
    frac = diff.float().mean().item()
    check(frac < 0.005, f"GPU and CPU rgb frames differ on {frac:.4%}")
    bundle_note = ""
    if exact:
        n_moved = exact_frames_follow_bundles(
            [f.flatten(0, 1) for f in frames], bundles)
        bundle_note = (f"; {n_moved} frames' exact bundles differ, every "
                       "other frame is equal")
    print(f"serving cpu check ({params_gpu.cfg.camera.stroke} stroke): 8 envs"
          f" x 20 combo-driven steps, steering within {err_equal:.2e} on "
          f"{int((~moved).sum())} equal frames and {err_moved:.2e} on "
          f"{int(moved.sum())} differing ones; rgb frames differ on "
          f"{frac:.4%} of pixels{bundle_note}")


if __name__ == "__main__":
    sys.exit(main())
