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

The probe modes of benchmarks/exp_r2.py (:147-327) time what writing
the output costs without rasterizing, each through its kernel
(ops/probe_kernels.py); the number in a mode's name is its parameter:
`ovl<KK>` (KK float32 multiply-add rounds on a 128 x 128 tile per env,
then a uint8 fill of the env's (5, 128, 160) block), `dmaflat[g]` (a
uint8 fill of (N, 800, 128), g envs per block, default 1), `dmaf32` (a
float32 fill of (N, 5, 128, 160)), `dma[g]` (a uint8 fill of (N, 5, 128,
160)), `dskip` (a fill of the (env, layer) frames of an (N * 5, 128, 256)
uint8 output that the reset draws in; the output is zeroed once, outside
the timed loop) and `dskipall` (every frame). Their protocol is exp_r2's
kernel-only one (:347-357): one warm-up, then 5 repeats of 30
iterations, iteration i filling with i (ovl: with i + 0.9999, so that
the checksum depends on the chain) and reducing the output to a
checksum as exp_r2 does (the whole output; `out[0, 0, 0, :4]` for
`dmaf32`; rows 60:64 of every frame for `dskip*`). Each prints its
ms/iter, the kernel alone and its library call alone (`fill_` for the
fills, `index_fill_` over the live frames for `dskip*`, none for `ovl`),
each `ITERS` back-to-back calls of iteration 1's fill, its launches per
iteration and its bound (the bytes it must write and, for `ovl`, its
float32 operations, `helper.bound`), and `dskip*`
the share of frames written. They are not in the default list.

Runs on the card and raises without a GPU. `run(device="cpu")` times the
plain versions on the CPU: a test of the script, not a measurement of
any device.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import sys
import time
from typing import Dict, Sequence

import torch

from tinycarlo_torch import camera as cam
from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.ops import probe_kernels as pk
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils.helper import bound, card_line, resolve_device

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
# a set of the probe modes (any KK and g parse, see `parse_probe`)
PROBES = ("ovl0", "ovl64", "ovl512", "dmaflat", "dmaflat16", "dmaf32", "dma",
          "dma4", "dskip", "dskipall")
_PROBE = re.compile(r"(ovl)(\d+)|(dmaflat)(\d*)|(dmaf32)()|(dma)(\d*)"
                    r"|(dskip)()|(dskipall)()")
# dskip's frame width (exp_r2.py:248)
FRAME_W = 256
# the fraction the ovl modes add to iteration i's value (exp_r2 fills
# with i): its multiply-add chain carries i + 0.9999 past i + 1 within
# KK >= 1 rounds, so the mode's checksum depends on the chain having run
OVL_FRACTION = 0.9999
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


def ms_per_call(fn, n: int, device: torch.device) -> float:
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
    compact_ms = ms_per_call(lambda: bundle(mode, inputs, start_points, 0),
                              iters, device)
    kernel_ms = (ms_per_call(lambda: render(mode, soa, inputs.n_layers),
                              iters, device) if mode in KERNEL_OF else None)
    return {"ms": times, "median": statistics.median(times),
            "checksum": checksum, "dropped": dropped, "launches": launches,
            "compact_ms": compact_ms, "kernel_ms": kernel_ms}


def parse_probe(mode: str):
    """(kind, parameter) of a probe mode -- ("ovl", KK), ("dmaflat", g),
    ("dmaf32", 1), ("dma", g), ("dskip", None), ("dskipall", None) -- or
    None for any other name. A group g of 0 raises."""
    m = _PROBE.fullmatch(mode)
    if m is None:
        return None
    kind, param = [x for x in m.groups() if x is not None]
    if kind in ("dskip", "dskipall"):
        return kind, None
    value = int(param) if param else 1
    if kind != "ovl" and value < 1:
        raise ValueError(f"probe mode {mode!r}: envs per block must be >= 1")
    return kind, value


def probe_live(mode: str, inputs: Inputs) -> torch.Tensor:
    """dskip's (L, N) int32 live frames: layer l of an env is live iff the
    reset draws one of its packed edges (exp_r2.py:249-257); all ones for
    dskipall."""
    _, _, draw = inputs.packed
    if mode == "dskipall":
        return torch.ones((inputs.n_layers, draw.shape[0]), dtype=torch.int32,
                          device=draw.device)
    lay = inputs.edge_layer.long()
    return torch.stack([(draw & (lay == l)).any(-1)
                        for l in range(inputs.n_layers)]).to(torch.int32)


def probe_setup(mode: str, inputs: Inputs):
    """A probe mode's kernel, its output (allocated once; zeroed for dskip),
    `launch(i)` filling it with iteration i's value, `checksum(out)` (a
    0-dim int64 as exp_r2 reduces the mode's output), its library call
    (None for ovl) and dskip's live frames (None otherwise)."""
    kind, param = parse_probe(mode)
    _, _, draw = inputs.packed
    dev, n, nl = draw.device, draw.shape[0], inputs.n_layers
    full = lambda o: o.sum(dtype=torch.int64)  # noqa: E731
    live = None
    if kind == "ovl":
        out = torch.empty((n, nl, H, W), dtype=torch.uint8, device=dev)
        return (pk.ovl_kernel, out,
                lambda i: pk.ovl_kernel(out, i + OVL_FRACTION, param), full,
                None, None)
    if kind in ("dmaflat", "dma", "dmaf32"):
        shape = (n, nl * H * W // 128, 128) if kind == "dmaflat" else (
            n, nl, H, W)
        dtype = torch.float32 if kind == "dmaf32" else torch.uint8
        out = torch.empty(shape, dtype=dtype, device=dev)
        checksum = full
        if kind == "dmaf32":
            checksum = lambda o: o[0, 0, 0, :4].sum().to(torch.int64)  # noqa
        return (pk.fill_kernel, out, lambda i: pk.fill_kernel(out, i, param),
                checksum, lambda: out.fill_(1), None)
    live = probe_live(mode, inputs)
    out = torch.zeros((n * nl, H, FRAME_W), dtype=torch.uint8, device=dev)
    # the live frames' flat indices, built outside the timed calls
    frames = torch.nonzero(live.T.reshape(-1) > 0).flatten()
    return (pk.skip_kernel, out, lambda i: pk.skip_kernel(out, live, i),
            lambda o: o[:, 60:64, :].sum(dtype=torch.int64),
            lambda: out.view(n * nl, -1).index_fill_(0, frames, 1), live)


def probe_work(mode: str, out: torch.Tensor, live) -> tuple:
    """(bytes, float32 operations) a probe mode's function needs: its
    output written once (dskip: live (L, N) int32 read once and the live
    frames written once; ovl: its 4-byte value read once and N * 16384 * KK
    * 2 multiply-add operations)."""
    kind, kk = parse_probe(mode)
    if live is not None:
        return (live.numel() * 4
                + int((live > 0).sum()) * out[0].numel()), 0
    n_bytes = out.numel() * out.element_size()
    if kind == "ovl":
        return n_bytes + 4, out.shape[0] * pk.TILE[0] * pk.TILE[1] * kk * 2
    return n_bytes, 0


def time_probe(mode: str, inputs: Inputs, iters: int = ITERS,
               repeats: int = REPEATS) -> Dict:
    """exp_r2's kernel-only protocol for one probe mode: {"ms" (per-repeat
    ms/iter), "median", "checksum" (the warm-up's), "launches" (kernel
    launches per iteration in the repeats), "kernel_ms" and "library_ms"
    (each alone, None for ovl's library), "bytes", "ops", "bound_ms",
    "bound_by", "bytes_ms", "ops_ms" (`helper.bound`), "live_share" (dskip*, else None)}. The kernel launches
    iters * (repeats + 2) times."""
    kernel, out, launch, checksum, library, live = probe_setup(mode, inputs)
    device = out.device

    def loop():
        c = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(iters):
            launch(i)
            c = c + checksum(out)
        return c

    total = int(loop())
    _sync(device)
    launched = kernel.launches
    times = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        loop()
        _sync(device)
        times.append((time.perf_counter() - t0) / iters * 1e3)
    launches = (kernel.launches - launched) / (iters * repeats)
    kernel_ms = ms_per_call(lambda: launch(1), iters, device)
    library_ms = (ms_per_call(library, iters, device) if library is not None
                  else None)
    n_bytes, n_ops = probe_work(mode, out, live)
    ms, by, bytes_ms, ops_ms = bound(n_bytes, n_ops)
    return {"ms": times, "median": statistics.median(times),
            "checksum": total, "launches": launches, "kernel_ms": kernel_ms,
            "library_ms": library_ms, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": ms, "bound_by": by, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "live_share": (None if live is None
                           else (live > 0).float().mean().item())}


def run(modes: Sequence[str] = MODES, device="cuda", n_envs: int = N_ENVS,
        iters: int = ITERS, repeats: int = REPEATS, empty: bool = False,
        inputs: Inputs = None, log=print) -> Dict[str, Dict]:
    """Time `modes` (see the module docstring) on `device`; returns each
    mode's `time_mode` result."""
    device = resolve_device(device)
    for mode in modes:
        if mode not in MODES and parse_probe(mode) is None:
            raise ValueError(f"unknown mode {mode!r}; modes: {MODES} and "
                             "the probes ovl<KK>, dmaflat[g], dmaf32, "
                             "dma[g], dskip, dskipall")
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
        if parse_probe(mode) is not None:
            r = results[mode] = time_probe(mode, inputs, iters, repeats)
            lib = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            share = ("" if r["live_share"] is None
                     else f"; live share {r['live_share']:.4f}")
            log(f"{mode}: med {r['median']:.4f} ms/iter  (all: "
                + " ".join(f"{t:.4f}" for t in r["ms"])
                + f") checksum {r['checksum']}; kernel {r['kernel_ms']:.4f} "
                f"ms, library {lib}; {r['launches']:g} launches/iter; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                f"{r['bytes'] / 1e6:.1f} MB, {r['ops'] / 1e9:.2f} GOP f32)"
                + share)
            continue
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
