"""The rasterizer benchmarks on the port: each compaction layout and its
kernel, timed at the JAX package's benchmark workload.

    python -m tinycarlo_torch.benchmarks.rasterize_bench [mode ...] [--empty]

The counterpart of two scripts of the JAX package, at their sizes: 4096
envs reset on simple_layout, 5 layers, 128x160 frames, line thickness 2.
- benchmarks/rasterize_bench.py, per-layer padded segments (B, 5, 192)
  projected layer by layer (`camera.project_layer`), k = 128, gran 8:
  `full` (`compact_soa` + the frame kernel), `compact` (`compact_soa`
  alone), `env` (`compact_env_soa` unsplit + the env kernel),
  `envcompact`;
- benchmarks/exp_r2.py, the packed edge axis (B, 264)
  (`env._project_packed_batch`), MAXVIS 128, gran 16: `cur`
  (`compact_env_soa` lane-split, k = 256, + the env kernel split), `curc`,
  `seg` (`compact_env_seg`, k = 128, + the segment kernel), `segc`, `idx`
  (the production `compact_env_idx_soa`, k = 256, + the masks kernel) and
  `idxc`.
The default is every mode. `--empty` draws nothing (the JAX scripts'
EMPTY=1). The segments are projected anew every run; nothing is cached.

Protocol, as the JAX scripts': per mode one warm-up, then 5 repeats with
distinct shifts of p0 (+0.01 * repeat), each of 30 iterations that perturb
both endpoints by i * 0.001, compact, render and reduce the output (or the
bundle) to a checksum carried through the loop; each repeat ends on
`torch.cuda.synchronize()`. Prints per mode `mode: med X ms/iter (all:
...) checksum N`, the warm-up's checksum, with the slots the compaction
dropped (its counts' "dropped" row, summed over the batch) and the
kernel's launches per iteration; and the card's name and power limit.
The checksum's int64 sum over the uint8 masks takes much of a kernel
mode's ms/iter, so each mode also prints its compaction alone and each
kernel mode its kernel alone, each `ITERS` back-to-back calls on the
first iteration's input, in ms per call.

Runs on the card and raises without a GPU. `run(device="cpu")` times the
plain versions on the CPU: a test of the script, not a measurement of
any device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, Sequence

import torch

from tinycarlo_torch import camera as cam
from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils.helper import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
H, W, THICK = 128, 160, 2
# benchmarks/rasterize_bench.py:36
K, GRAN = 128, 8
# benchmarks/exp_r2.py:23-26
MAXVIS, GRAN_PACKED = 128, 16
ITERS, REPEATS = 30, 5
N_ENVS = 4096
MODES = ("full", "compact", "env", "envcompact", "cur", "curc", "seg",
         "segc", "idx", "idxc")
# the config of both scripts (rasterize_bench.py:53-63, exp_r2.py:38-48)
CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {"wheelbase": 0.0487, "track_width": 0.027,
            "max_velocity": 0.15, "max_steering_angle": 30,
            "steering_speed": 30, "max_acceleration": 0.1,
            "max_deceleration": 1.0},
    "camera": {"position": [0.0, -0.005, 0.04], "orientation": [22, 0, 0],
               "resolution": [H, W], "fov": 80, "max_range": 0.5,
               "line_thickness": THICK},
    "map": {"json_path": os.path.join(REPO, "examples/maps/simple_layout.json"),
            "pixel_per_meter": 450},
}


class Inputs:
    """The segments of a reset of `n_envs` envs: per layer (`layer`: p0,
    p1 (B, L, E, 2), draw (B, L, E)) and on the packed edge axis
    (`packed`: (B, Ep, 2) x2, (B, Ep)), with the packed edges' layers."""

    def __init__(self, device="cuda", n_envs: int = N_ENVS,
                 empty: bool = False):
        params = fenv.make_env_params(CONFIG, device=device)
        states, _ = vector.reset(params, n_envs, seed=0, render=False)
        md = params.map_data
        body = cam.car_world_to_body_matrix(states.env.car.position,
                                            states.env.car.rotation)
        pose = torch.matmul(params.camera.E, body)  # (B, 3, 4)
        self.layer = list(cam.project_layer(
            md.laneline_nodes, md.laneline_edges, md.laneline_edge_mask,
            pose[:, None], params.camera.K, (H, W),
            params.cfg.camera.max_range,
        ))
        self.packed = list(fenv._project_packed_batch(params, states.env))
        if empty:
            self.layer[2] = torch.zeros_like(self.layer[2])
            self.packed[2] = torch.zeros_like(self.packed[2])
        self.edge_layer = md.packed_edge_layer
        self.n_layers = md.n_layers


def bundle(mode: str, inputs: Inputs, p0: torch.Tensor, i: int):
    """The compaction of `mode` with p0 (the shifted per-layer or packed
    start points) and both endpoints perturbed by i * 0.001. Returns
    (bundle, dropped-row index of its counts)."""
    d = i * 0.001
    if mode in ("full", "compact", "env", "envcompact"):
        _, p1, draw = inputs.layer
        a, b = p0 + d, p1 + d
        if mode in ("full", "compact"):
            return rk.compact_soa(a, b, draw, K, GRAN, H, THICK), 2
        return rk.compact_env_soa(a, b, draw, K, GRAN, H, THICK), 2
    _, p1, draw = inputs.packed
    a, b = p0 + d, p1 + d
    e = a.shape[1]
    nxb = rk._n_xblocks(W)
    k = min(MAXVIS * nxb, e * nxb)
    packed = dict(edge_layer=inputs.edge_layer, n_layers=inputs.n_layers,
                  w=W)
    if mode in ("cur", "curc"):
        return rk.compact_env_soa(a[:, None], b[:, None], draw[:, None], k,
                                  GRAN_PACKED, H, THICK, **packed), 2
    if mode in ("seg", "segc"):
        return rk.compact_env_seg(
            a[:, None, :, 0], a[:, None, :, 1], b[:, None, :, 0],
            b[:, None, :, 1], draw[:, None], min(MAXVIS, e), GRAN_PACKED, H,
            THICK, **packed,
        ), 3
    return rk.compact_env_idx_soa(
        a[..., 0], a[..., 1], b[..., 0], b[..., 1], draw, k, H, THICK,
        **packed,
    ), 3


def render(mode: str, soa, n_layers: int) -> torch.Tensor:
    """The masks of a kernel mode's bundle, through its kernel."""
    if mode == "full":
        return rk.frame_soa_kernel(soa, (H, W), THICK, GRAN)
    if mode == "env":
        return rk.env_soa_kernel(soa, n_layers, (H, W), THICK, GRAN,
                                 split=False)
    if mode == "cur":
        return rk.env_soa_kernel(soa, n_layers, (H, W), THICK, GRAN_PACKED,
                                 split=True)
    if mode == "seg":
        return rk.env_seg_kernel(soa, n_layers, (H, W), THICK, GRAN_PACKED,
                                 split=True)
    return rk.masks_kernel(soa, n_layers, (H, W), THICK)


# the kernel each kernel mode renders through
KERNEL_OF = {"full": rk.frame_soa_kernel, "env": rk.env_soa_kernel,
             "cur": rk.env_soa_kernel, "seg": rk.env_seg_kernel,
             "idx": rk.masks_kernel}
KERNELS = tuple(dict.fromkeys(KERNEL_OF.values()))


def _step(mode: str, inputs: Inputs, p0: torch.Tensor, i: int):
    """One iteration: (int64 checksum term, the bundle's dropped count)."""
    soa, drop_row = bundle(mode, inputs, p0, i)
    dropped = soa[-1][drop_row].sum()
    if mode in KERNEL_OF:
        out = render(mode, soa, inputs.n_layers)
        return out.sum(dtype=torch.int64), dropped
    total = sum(x.to(torch.float32).sum() for x in soa)
    return total.to(torch.int64), dropped


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms_per_call(fn, n: int, device: torch.device) -> float:
    """Wall ms per call of n back-to-back calls of fn, synchronized before
    and after."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def time_mode(mode: str, inputs: Inputs, iters: int = ITERS,
              repeats: int = REPEATS) -> Dict:
    """The protocol for one mode: {"ms": per-repeat ms/iter, "median",
    "checksum" (the warm-up's), "dropped" (the warm-up's first iteration's
    dropped slots), "launches" (kernel launches per iteration in the
    repeats), "compact_ms" (the compaction alone) and "kernel_ms" (the
    kernel alone on the compaction's bundle; None for a compaction-only
    mode)}. A kernel mode launches its kernel iters * (repeats + 2)
    times: warm-up, repeats and the kernel alone."""
    start_points = inputs.layer[0] if mode in (
        "full", "compact", "env", "envcompact") else inputs.packed[0]
    device = start_points.device

    def loop(p0):
        c = torch.zeros((), dtype=torch.int64, device=device)
        dropped = None
        for i in range(iters):
            term, drop = _step(mode, inputs, p0, i)
            c = c + term
            dropped = drop if dropped is None else dropped
        return c, dropped

    checksum, dropped = loop(start_points)
    _sync(device)
    checksum, dropped = int(checksum), int(dropped)
    launched = sum(k.launches for k in KERNELS)
    times = []
    for rep in range(1, repeats + 1):
        p0 = start_points + 0.01 * rep
        _sync(device)
        t0 = time.perf_counter()
        loop(p0)
        _sync(device)
        times.append((time.perf_counter() - t0) / iters * 1e3)
    launches = (sum(k.launches for k in KERNELS) - launched) / (iters * repeats)
    soa, _ = bundle(mode, inputs, start_points, 0)
    compact_ms = _ms_per_call(lambda: bundle(mode, inputs, start_points, 0),
                              iters, device)
    kernel_ms = (_ms_per_call(lambda: render(mode, soa, inputs.n_layers),
                              iters, device) if mode in KERNEL_OF else None)
    return {"ms": times, "median": statistics.median(times),
            "checksum": checksum, "dropped": dropped, "launches": launches,
            "compact_ms": compact_ms, "kernel_ms": kernel_ms}


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run(modes: Sequence[str] = MODES, device="cuda", n_envs: int = N_ENVS,
        iters: int = ITERS, repeats: int = REPEATS, empty: bool = False,
        inputs: Inputs = None, log=print) -> Dict[str, Dict]:
    """Time `modes` (see the module docstring) on `device`; returns each
    mode's `time_mode` result."""
    device = resolve_device(device)
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    inputs = inputs or Inputs(device, n_envs, empty)
    where = card_line() if device.type == "cuda" else "the CPU (plain versions)"
    _, _, draw = inputs.layer
    live = draw.sum(-1).float()
    log(f"batch {tuple(draw.shape)} per layer: {live.mean().item():.2f} live "
        f"segs/frame, {(live == 0).float().mean().item() * 100:.1f}% empty "
        f"frames; packed {tuple(inputs.packed[2].shape)}: "
        f"{inputs.packed[2].sum(-1).float().mean().item():.1f} live edges/env;"
        f" on {where}")
    results = {}
    for mode in modes:
        r = time_mode(mode, inputs, iters, repeats)
        results[mode] = r
        alone = f"compaction {r['compact_ms']:.4f} ms"
        if r["kernel_ms"] is not None:
            alone += f", kernel {r['kernel_ms']:.4f} ms"
        log(f"{mode}: med {r['median']:.4f} ms/iter  (all: "
            + " ".join(f"{t:.4f}" for t in r["ms"])
            + f") checksum {r['checksum']}; {alone}; dropped "
            f"{r['dropped']}; {r['launches']:g} launches/iter")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="*", default=list(MODES))
    ap.add_argument("--empty", action="store_true",
                    help="draw nothing (the empty-frame floor)")
    args = ap.parse_args(argv)
    run(args.modes, empty=args.empty)
    return 0


if __name__ == "__main__":
    sys.exit(main())
