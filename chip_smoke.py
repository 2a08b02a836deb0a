"""Drive the PyTorch port (tinycarlo_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which exits non-zero on
any failed check:

1. device: requires CUDA; prints the card's name and power limit and the
   TF32 settings (both off).
2. build: compiles the port's CUDA kernels from tinycarlo_torch/ops/csrc
   with nvcc and prints the build time and ptxas' report.
3. kernels: every kernel against its plain PyTorch version on the card,
   on random compaction bundles (t = 1, 2, 3; w = 48, 160 and 640; h = 30,
   128 and 480; an env with nothing to draw; an oversubscribed budget) and
   on real bundles of the bench config's states: the masks kernel in uint8
   and float32, the rank kernel also against rank_from_masks of the masks
   kernel. Bit-equality is required: the kernels are built with
   -fmad=false.
4. main path (classes): bench.py's workload through the port's entry
   points -- make_env_params, vector.reset(4096), the segment-overflow
   guard, then vector.step with Stanley actions and max_episode_steps=1000,
   the observation rendered every step and consumed by a checksum. The
   masks kernel's launch count must equal the renders. Reports env-steps/s
   (median of 5 repeats, with spread) and per-stage ms; then the last
   observation against the plain version on the same states and a small
   rollout against the port on the CPU.
5. serving (rgb): the bundled pretrained combo (models.load_pretrained)
   through the port's `train.evaluate` on examples/config_simple_layout.yaml,
   whose rgb frames come from the rank kernel:
   a. the example's protocol (examples/benchmark_tinycar_net.py:92-98):
      maneuvers 0, 1, 2, 5 episodes of 1000 steps, seed 10; each cte_avg
      must be finite and below 0.02 m (steps are cut, and the cut printed,
      if the protocol would take over ~2 minutes);
   b. 4096 episodes of 100 steps, 5 repeats: env-steps/s with the policy,
      per-stage ms, the device idle share and the peak memory; the rank
      kernel's launch count must equal the renders;
   c. 8 envs x 20 combo-driven steps on the card and on the CPU port.
6. results: the `kernels` JSON line, the card line and, last, the `ok`
   JSON line.

Every time is measured on the card in this run (CUDA events, or host
clocks around work that ends in torch.cuda.synchronize()).
"""
import json
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
WARMUP = 10
SPEED, K = 0.5, 5.0  # bench.py:64

# the serving path: the example's config and protocol
# (examples/benchmark_tinycar_net.py:53-98) and the batched run
SERVE_CONFIG = os.path.join(REPO, "examples/config_simple_layout.yaml")
SERVE_STEPS, SERVE_EPISODES, SERVE_SEED = 1000, 5, 10
SERVE_BUDGET_S = 120.0  # the protocol's time before its steps are cut
# cte_avg of the bundled combo: 0.0064 / 0.0092 / 0.0096 m in the JAX
# package's records, untrained inits 0.026-0.035 m (docs/TRAINING.md)
CTE_LIMIT = 0.02
# card against CPU port, 8 envs x 20 closed-loop steps: on equal frames the
# float32 combo forwards (TF32 off) agree to rounding; where a frame differs
# in a stroke-boundary pixel, the steering may move by up to ~4e-3
STEER_ATOL = 1e-5
STEER_ATOL_MOVED = 2e-2

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations the masks kernel spends per evaluated pixel
# (masks.cu window_hit). Split stroke: apx, apy, tu 4, clip 2, dx 2, dy 2,
# d2 3, the tu range test 2, the d2 compare 1. Bresenham (t=1): apx, apy,
# |aby|, sign, major test, max, min, step 2, num 4, floor quotient 2,
# residual 3, its corrections 4, probe, target 2, range and match tests 3,
# the point test 1.
OPS_PER_PIXEL = {"split": 18, "bres": 29}


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


def random_bundle(rk, seed, b, e, h, w, t, k_per_block, dev, n_layers=5):
    """Compaction bundle on `dev` for numpy-seeded segments; env 0 draws
    nothing."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, e))
    v0 = rng.uniform(-40, h + 40, (b, e))
    u1 = u0 + rng.uniform(-90, 90, (b, e))
    v1 = v0 + rng.uniform(-60, 60, (b, e))
    draw = rng.random((b, e)) < 0.7
    draw[0] = False
    lay = np.sort(rng.integers(0, n_layers, e)).astype(np.int32)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    k = k_per_block * rk._n_xblocks(w)
    return rk.compact_env_idx_soa(
        f(u0), f(v0), f(u1), f(v1), torch.tensor(draw, device=dev), k, h, t,
        edge_layer=torch.tensor(lay, device=dev),
        n_layers=n_layers, w=w,
    )


def kernel_vs_plain(rk, bundle, n_layers, res, t):
    """Max |kernel - plain| over uint8 and float32 outputs (0 expected)."""
    import torch

    err = 0.0
    for dt in (torch.uint8, torch.float32):
        got = rk.masks_kernel(bundle, n_layers, res, t, out_dtype=dt)
        want = rk.rasterize_masks_env_plain(bundle, n_layers, res, t,
                                            out_dtype=dt)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"kernel output {got.shape} {got.dtype} != {want.shape}")
        e = (got.float() - want.float()).abs().max().item()
        check(e == 0.0, f"masks kernel differs from its plain version by {e}"
              f" at t={t}, {res}, {dt}")
        err = max(err, e)
    return err


def bundle_bytes_and_ops(rk, bundle, res, t, out_bytes):
    """The least work of a kernel over this bundle: the bytes it must move
    (the counts rows, the live slots' idx entries and their copies' six SoA
    entries read once, the output written once) and the float32 operations
    of the stamp over each live copy's segment bounding box, padded by the
    stroke radius and clipped to the copy's stamped bands and to the frame.
    Pixels outside that box cannot be lit, so a kernel need not evaluate
    them (the kernels do: they evaluate the whole window)."""
    import torch

    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    h, w = res
    k = idx.shape[1] - 7
    live = torch.arange(k, device=idx.device)[None] < counts[0][:, None]
    env, slot = torch.nonzero(live, as_tuple=True)
    e = idx[env, slot].long()
    word = bw[env, e]
    nb = word & 511
    rowband = word >> 9
    frame = rowband // n_bands
    b0 = rowband - frame * n_bands
    xb = frame % nxb
    stroke = rk._stroke_params(t)
    r = 0.0 if stroke[0] == "bres" else max(stroke[1], stroke[2]) ** 0.5
    x0, y0 = ax[env, e], ay[env, e] - (frame * hp).float()
    x1, y1 = x0 + abx[env, e], y0 + aby[env, e]

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
    pixels = int((cols * ys * (nb > 0)).sum().item())
    ops = pixels * OPS_PER_PIXEL[stroke[0]]
    n_in = counts.numel() * 4 + int(env.numel()) * (4 + 6 * 4)
    return n_in + out_bytes, ops


def main():
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path runs on a GPU",
              file=sys.stderr)
        return 1
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
    max_err, rank_err = check_kernels(rk, ras, fenv, vector, params, "cuda")

    # ---- 4. main path --------------------------------------------------------
    rk.masks_kernel.launches = rk.rank_kernel.launches = 0
    run = run_main_path(fenv, vector, stanley_steering, rk, params, N_ENVS,
                        CHUNK, REPEATS)
    launches = rk.masks_kernel.launches
    renders = run["steps"]
    check(launches == renders,
          f"masks kernel launched {launches} times for {renders} renders")
    check(rk.rank_kernel.launches == 0, "the classes path ran the rank kernel")
    check(run["checksum"] > 0, "observations were not rendered")
    rates = sorted(run["rates"])
    print(f"main path: {N_ENVS} envs x {renders} steps, {launches} masks "
          f"kernel launches, checksum {run['checksum']}")
    print(f"env-steps/s: median {statistics.median(rates):.1f} "
          f"(min {rates[0]:.1f}, max {rates[-1]:.1f}, {REPEATS} repeats of "
          f"{CHUNK} steps) on {card}")

    check_outputs(fenv, rk, params, run)
    compare_with_cpu(fenv, vector, stanley_steering, params)
    times = stage_times(fenv, vector, rk, params, run["vstate"])
    wall_ms = 1e3 * N_ENVS / statistics.median(rates)
    busy_ms, top, by_name = device_profile(lambda: run["body"](
        run["vstate"], run["info"], torch.zeros((), dtype=torch.int64,
                                                device="cuda")))
    times["kernel_device"] = kernel_device_ms(by_name, "masks_kernel")
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    print(f"per step at {N_ENVS} envs on {card}, event ms / device-busy ms:")
    for key in ("projection", "compaction", "kernel", "step"):
        print(f"  {key}: {times[key]:.4f} ms / {fmt(times[key + '_device'])}")
    print(f"  plain version of the masks kernel: {times['plain']:.4f} ms")
    if busy_ms is None:
        print("main-path step: device busy share not measured (the "
              "profiler trace holds no device time)")
    else:
        print(f"main-path step: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for key, ms, count in top:
            print(f"  {ms:.4f} ms/step x{count}: {key}")
    bundle = times["bundle"]
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    out_bytes = N_ENVS * md.n_layers * res[0] * res[1]
    n_bytes, n_ops = bundle_bytes_and_ops(rk, bundle, res, t, out_bytes)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    print(f"masks kernel bound on {card}: {n_bytes / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {n_ops / 1e9:.2f} GOP f32 -> {t_ops:.4f} ms")
    kernels = [{
        "name": "masks",
        "route": "cuda",
        "source": "tinycarlo_torch/ops/csrc/masks.cu",
        "replaces": "tinycarlo_tpu/ops/rasterize_pallas.py:1931 "
                    "(_kernel_env_idx), "
                    "tinycarlo_tpu/ops/rasterize_pallas.py:2107 "
                    "(_kernel_env_dma)",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call rasterizes compacted segment stamps into
        # per-layer masks, so there is no library yardstick
        "library_ms": None,
    }]

    # ---- 5. serving ----------------------------------------------------------
    kernels.append(serve(card, rank_err))

    # ---- 6. results ----------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


def bench_bundle(fenv, rk, params, states, projection=None):
    """The production compaction bundle of these states (bench budget)."""
    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    nxb = rk._n_xblocks(res[1])
    k = min(params.cfg.camera.max_visible_segments * nxb,
            md.packed_edges.shape[1] * nxb)
    u0, v0, u1, v1, draw = (
        projection or fenv._project_packed_batch_soa(params, states)
    )
    return rk.compact_env_idx_soa(
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
        masks_err = max(masks_err, kernel_vs_plain(rk, bundle, 5, (h, w), t))
        rank_err = max(rank_err, rank_vs_plain(rk, ras, bundle, 5, (h, w), t))
    real, _ = vector.reset(params, 384, seed=1, render=False)
    real_bundle = bench_bundle(fenv, rk, params, real.env)
    geometry = (params.map_data.n_layers, tuple(params.cfg.camera.resolution),
                params.cfg.camera.line_thickness)
    masks_err = max(masks_err, kernel_vs_plain(rk, real_bundle, *geometry))
    rank_err = max(rank_err, rank_vs_plain(rk, ras, real_bundle, *geometry))
    print(f"kernels: masks kernel equal to its plain version on "
          f"{len(cases)} random bundles and 384 real envs, uint8 and "
          f"float32; rank kernel equal to its plain version and to "
          f"rank_from_masks of the masks kernel on the same bundles")
    return masks_err, rank_err


def run_main_path(fenv, vector, stanley_steering, rk, params, n_envs, chunk,
                  repeats):
    """bench.py's loop (bench.py:78-111) through the port's entry points."""
    import torch

    dev = params.device
    md = params.map_data
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
    """Shapes, values and finiteness of the main path's outputs, and its
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
    plain = rk.rasterize_masks_env_plain(
        bench_bundle(fenv, rk, params, run["rendered"]), md.n_layers, res,
        params.cfg.camera.line_thickness,
    )
    check(torch.equal(obs, plain),
          "main-path observation differs from the plain version")


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
    """Per-stage ms of one render and one step at the main path's batch:
    stream time between CUDA events ("ms", which includes the gaps while
    the host enqueues eager kernels) and device-busy time from a profiler
    trace ("device_ms"; the masks kernel's comes from the whole step's
    trace, see kernel_device_ms)."""
    import torch

    md = params.map_data
    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
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
        "kernel": lambda: rk.masks_kernel(bundle, md.n_layers, res, t),
        "step": lambda: vector.step(params, vstate, action, render=False,
                                    max_episode_steps=1000),
    }
    out = {"bundle": bundle}
    for key, fn in stages.items():
        out[key] = cuda_ms(fn, repeats=20 if key == "kernel" else 7)
        if key != "kernel":  # its device ms: see kernel_device_ms
            out[key + "_device"] = device_profile(fn)[0]
    out["plain"] = cuda_ms(lambda: rk.rasterize_masks_env_plain(
        bundle, md.n_layers, res, t), repeats=5, warmup=1)
    return out


def compare_with_cpu(fenv, vector, stanley_steering, params_gpu):
    """8 envs, 20 steps of Stanley control on the card and on the CPU port
    (same spawn and respawn rows): car states within 1e-4 (float32 libm and
    matmul rounding differ between the two devices) and observations
    differing on under 0.5% of pixels (an endpoint that truncates to the
    other integer moves a stroke)."""
    import torch

    params_cpu = fenv.make_env_params(CONFIG, device="cpu")
    n, steps = 8, 20
    rows = torch.arange(n) % params_cpu.map_data.spawns.count
    states, obs = [], []
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
    err = (states[0] - states[1]).abs().max().item()
    check(err < 1e-4, f"GPU and CPU car positions differ by {err}")
    frac = (obs[0] != obs[1]).float().mean().item()
    check(frac < 0.005, f"GPU and CPU observations differ on {frac:.4%}")
    print(f"cpu check: 8 envs x 20 steps, positions within {err:.2e}, "
          f"observations differ on {frac:.4%} of pixels")


def serve(card, rank_err):
    """Phase 5: the bundled combo served on rgb frames through the port's
    evaluate. Returns the rank kernel's entry of the `kernels` line."""
    import numpy as np
    import torch

    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.models.tinycar_net import load_pretrained
    from tinycarlo_torch.ops import rasterize as ras
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.evaluate import (
        combo_policy, evaluate, standard_stack,
    )

    params = fenv.make_env_params(SERVE_CONFIG)
    check(params.cfg.sim.observation_space_format == "rgb",
          "the example's config should render rgb")
    model = load_pretrained(fenv.observation_shape(params))
    check(model is not None, "no bundled combo for the example's frames")
    act = combo_policy(model)

    # a. the example's protocol, its steps cut if it would take too long
    # (timed after a warm-up: the first forward initialises cuDNN)
    evaluate(act, params, 0, None, seed=SERVE_SEED, steps=5,
             episodes=SERVE_EPISODES)
    start = time.perf_counter()
    evaluate(act, params, 0, None, seed=SERVE_SEED, steps=20,
             episodes=SERVE_EPISODES)
    per_step = (time.perf_counter() - start) / 20
    steps = SERVE_STEPS
    if 3 * steps * per_step > SERVE_BUDGET_S:
        steps = max(100, int(SERVE_BUDGET_S / (3 * per_step)) // 100 * 100)
        print(f"serving protocol: steps cut from {SERVE_STEPS} to {steps} "
              f"({per_step * 1e3:.2f} ms per step)")
    start = time.perf_counter()
    for maneuver in range(3):
        rk.rank_kernel.launches = rk.masks_kernel.launches = 0
        r = evaluate(act, params, maneuver, None, seed=SERVE_SEED,
                     steps=steps, episodes=SERVE_EPISODES)
        check(rk.rank_kernel.launches == steps,
              f"rank kernel launched {rk.rank_kernel.launches} times for "
              f"{steps} renders")
        check(rk.masks_kernel.launches == 0, "rgb path ran the masks kernel")
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
    print(f"serving protocol: 3 maneuvers x {SERVE_EPISODES} episodes x "
          f"{steps} steps in {time.perf_counter() - start:.1f} s")

    # b. batched serving at 4096 envs
    import warnings

    rk.rank_kernel.launches = rk.masks_kernel.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        evaluate(act, params, 0, None, seed=0, steps=WARMUP,
                 episodes=N_ENVS)
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for rep in range(REPEATS):
            r = evaluate(act, params, 0, None, seed=1 + rep, steps=CHUNK,
                         episodes=N_ENVS)
            check(np.isfinite(r["cte_avg"]) and np.isfinite(r["positions"])
                  .all(), "non-finite serving metrics")
            rates.append(r["steps_per_s"])
    dropped = [str(w.message) for w in caught if "dropped" in str(w.message)]
    check(not dropped, f"segment overflow while serving: {dropped}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = rk.rank_kernel.launches
    renders = WARMUP + REPEATS * CHUNK
    check(launches == renders,
          f"rank kernel launched {launches} times for {renders} renders")
    check(rk.masks_kernel.launches == 0, "rgb path ran the masks kernel")
    rates.sort()
    print(f"serving: {N_ENVS} envs x {renders} steps, {launches} rank "
          f"kernel launches")
    print(f"serving env-steps/s (policy included): median "
          f"{statistics.median(rates):.1f} (min {rates[0]:.1f}, max "
          f"{rates[-1]:.1f}, {REPEATS} repeats of {CHUNK} steps) on {card}")

    stack = standard_stack()
    vstate, _ = vector.reset(params, N_ENVS, seed=0, stack=stack,
                             render=False)
    m = torch.zeros(N_ENVS, dtype=torch.int32, device=params.device)

    def serving_step(vstate):
        """One iteration of evaluate's loop (train/evaluate.py)."""
        obs = fenv.render_observation_batch(params, vstate.env)
        steering, _ = act(obs, m, None)
        action = {"car_control": torch.stack(
            [torch.full_like(steering, 0.35), steering], dim=-1),
            "maneuver": m}
        return vector.step(params, vstate, action, stack=stack,
                           render=False)[0]

    times = serving_stage_times(fenv, vector, rk, ras, params, vstate, act,
                                stack, m)
    wall_ms = 1e3 * N_ENVS / statistics.median(rates)
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

    compare_serving_with_cpu(fenv, vector, params, act, load_pretrained,
                             combo_policy, standard_stack)

    res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    n_bytes, n_ops = bundle_bytes_and_ops(rk, times["bundle"], res, t,
                                          N_ENVS * res[0] * res[1])
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
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
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # no single PyTorch call rasterizes compacted segment stamps into
        # a layer-rank map, so there is no library yardstick
        "library_ms": None,
    }


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


def compare_serving_with_cpu(fenv, vector, params_gpu, act_gpu,
                             load_pretrained, combo_policy, standard_stack):
    """8 envs, 20 combo-driven steps of the serving path on the card and on
    the CPU port (same spawn and respawn rows, each device's own combo and
    frames): steering within STEER_ATOL at every (step, env) whose frames
    are equal, within STEER_ATOL_MOVED where they differ, and rgb frames
    that differ on under 0.5% of pixels."""
    import torch

    params_cpu = fenv.make_env_params(SERVE_CONFIG, device="cpu")
    act_cpu = combo_policy(load_pretrained(
        fenv.observation_shape(params_cpu), device="cpu"))
    n, steps = 8, 20
    rows = torch.arange(n) % params_cpu.map_data.spawns.count
    m = torch.arange(n, dtype=torch.int32) % 3
    steer, frames = [], []
    for params, act in ((params_gpu, act_gpu), (params_cpu, act_cpu)):
        dev = params.device
        stack = standard_stack()
        vstate, _ = vector.reset(params, n, stack=stack, render=False,
                                 spawn_rows=rows.to(dev))
        s_run, f_run = [], []
        for _ in range(steps):
            obs = fenv.render_observation_batch(params, vstate.env)
            s, _ = act(obs, m.to(dev), None)
            s_run.append(s.cpu())
            f_run.append(obs.cpu())
            action = {"car_control": torch.stack(
                [torch.full_like(s, 0.35), s], dim=-1),
                "maneuver": torch.where(m != 2, m, 3).to(dev)}
            vstate = vector.step(params, vstate, action, stack=stack,
                                 render=False, max_episode_steps=12,
                                 respawn_rows=rows.to(dev))[0]
        steer.append(torch.stack(s_run))
        frames.append(torch.stack(f_run))
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
    print(f"serving cpu check: 8 envs x 20 combo-driven steps, steering "
          f"within {err_equal:.2e} on {int((~moved).sum())} equal frames "
          f"and {err_moved:.2e} on {int(moved.sum())} differing ones; rgb "
          f"frames differ on {frac:.4%} of pixels")


if __name__ == "__main__":
    sys.exit(main())
