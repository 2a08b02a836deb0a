"""Drive the PyTorch port (tinycarlo_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which exits non-zero on
any failed check:

1. device: requires CUDA; prints the card's name and power limit and the
   TF32 settings (both off).
2. build: compiles the port's CUDA kernels from tinycarlo_torch/ops/csrc
   with nvcc and prints the build time and ptxas' report.
3. kernels: every kernel against its plain PyTorch version on the card,
   on random compaction bundles (t = 1, 2, 3; w = 48, 160 and 640; h = 30
   and 480; an env with nothing to draw; an oversubscribed budget) and on
   real bundles of the bench config's states, in uint8 and float32.
   Bit-equality is required: the kernels are built with -fmad=false.
4. main path: bench.py's workload through the port's entry points --
   make_env_params, vector.reset(4096), the segment-overflow guard, then
   vector.step with Stanley actions and max_episode_steps=1000, the
   observation rendered every step and consumed by a checksum. The masks
   kernel's launch count must equal the renders. Reports env-steps/s
   (median of 5 repeats, with spread) and per-stage ms.
5. results: the last observation against the plain version on the same
   states, a small rollout against the port on the CPU, then the
   `kernels` JSON line, the card line and, last, the `ok` JSON line.

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
    """Bytes the masks kernel must move (bundle read once, output written
    once) and float32 operations this bundle's live slots need."""
    import torch

    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    n_in = sum(x.numel() * x.element_size() for x in bundle)
    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    k = idx.shape[1] - 7
    word = torch.gather(bw, 1, idx[:, :k].long())
    nb = word & 511
    live = (torch.arange(k, device=nb.device)[None] < counts[0][:, None]) & (
        nb > 0
    )
    rows = torch.clamp_min(nb, win // rk._GRAN) * rk._GRAN
    pixels = int((rows * live).sum().item()) * wb
    ops = pixels * OPS_PER_PIXEL[rk._stroke_params(t)[0]]
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
    max_err = check_kernels(rk, fenv, vector, params, "cuda")

    # ---- 4. main path --------------------------------------------------------
    rk.masks_kernel.launches = 0
    run = run_main_path(fenv, vector, stanley_steering, rk, params, N_ENVS,
                        CHUNK, REPEATS)
    launches = rk.masks_kernel.launches
    renders = run["steps"]
    check(launches == renders,
          f"masks kernel launched {launches} times for {renders} renders")
    check(run["checksum"] > 0, "observations were not rendered")
    rates = sorted(run["rates"])
    print(f"main path: {N_ENVS} envs x {renders} steps, {launches} masks "
          f"kernel launches, checksum {run['checksum']}")
    print(f"env-steps/s: median {statistics.median(rates):.1f} "
          f"(min {rates[0]:.1f}, max {rates[-1]:.1f}, {REPEATS} repeats of "
          f"{CHUNK} steps) on {card}")

    # ---- 5. results ----------------------------------------------------------
    check_outputs(fenv, rk, params, run)
    compare_with_cpu(fenv, vector, stanley_steering, params)
    times = stage_times(fenv, vector, rk, params, run["vstate"])
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa
    print(f"per step at {N_ENVS} envs on {card}, event ms / device-busy ms:")
    for key in ("projection", "compaction", "kernel", "step"):
        print(f"  {key}: {times[key]:.4f} ms / {fmt(times[key + '_device'])}")
    print(f"  plain version of the masks kernel: {times['plain']:.4f} ms")
    wall_ms = 1e3 * N_ENVS / statistics.median(rates)
    busy_ms, top = device_profile(lambda: run["body"](
        run["vstate"], run["info"], torch.zeros((), dtype=torch.int64,
                                                device="cuda")))
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


def check_kernels(rk, fenv, vector, params, dev):
    """The masks kernel against its plain version; returns max |error|."""
    max_err = 0.0
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
        max_err = max(max_err, kernel_vs_plain(rk, bundle, 5, (h, w), t))
    real, _ = vector.reset(params, 384, seed=1, render=False)
    max_err = max(max_err, kernel_vs_plain(
        rk, bench_bundle(fenv, rk, params, real.env),
        params.map_data.n_layers, tuple(params.cfg.camera.resolution),
        params.cfg.camera.line_thickness,
    ))
    print(f"kernels: masks kernel equal to its plain version on "
          f"{len(cases)} random bundles and 384 real envs, uint8 and float32")
    return max_err


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
    """(device-busy ms per call, top kernels) of fn() from a torch.profiler
    trace: the sum of the CUDA kernels' device time over `calls` calls.
    (None, []) when the trace holds no device time."""
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
        return None, []
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return busy_us / 1e3 / calls, [
        (e.key[:70], e.self_device_time_total / 1e3 / calls, e.count // calls)
        for e in top
    ]


def stage_times(fenv, vector, rk, params, vstate):
    """Per-stage ms of one render and one step at the main path's batch:
    stream time between CUDA events ("ms", which includes the gaps while
    the host enqueues eager kernels) and device-busy time from a profiler
    trace ("device_ms")."""
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


if __name__ == "__main__":
    sys.exit(main())
