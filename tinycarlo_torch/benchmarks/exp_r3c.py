"""Headline-throughput probes on the card: graph length and the
observation's store floors.

    python -m tinycarlo_torch.benchmarks.exp_r3c [unroll fill]

The counterpart of benchmarks/exp_r3c.py's `probe_unroll` (:60-99) and
`probe_fill` (:102-139), which stay the JAX package's:

- `unroll`: the script asks whether `lax.scan(..., unroll=N)` lets one
  step's rasterizer overlap the next step's car and info work. A replayed
  CUDA graph has no scan to unroll; its counterpart is the graph's
  length: bench.py's step (tinycarlo_torch.benchmarks.bench `make_body`,
  at the script's config, which is bench.py's) captured 1, 2 and 4 steps
  to a graph, replayed to the same CHUNK (30) steps (30 = 7 x 4 + 2: the
  remainder runs through the 1-step graph), a warm chunk, then the median
  of 5 chunks ended by `torch.cuda.synchronize()`; ms a step and
  env-steps/s.
- `fill`: the store rate of the (B, 5, 128, 160) uint8 observation and of
  its float32 equivalent, as `fill_` of a carried counter and the uint8
  column iota + i (`copy_` into the carried buffer), each a captured
  write replayed CHUNK times, median of 5; ms a write and GB/s over the
  script's bytes (the uint8 bytes, times 4 for float32). The script
  carries its counter so that XLA cannot fold the fill away; in torch
  `fill_` of a 0-d device tensor is a broadcast copy, slower than `fill_`
  of a number, so two more rows fill a constant: torch's store floor
  (torch folds nothing).

Not ported, and why:
- `geom` (:142-182) re-sweeps the rasterizer's window geometry through
  the `TINYCARLO_*` switches, which the port does not have (ROADMAP §2:
  measurement-only switches of the Pallas kernel; the CUDA kernels' block
  geometry is fixed, env_block.cuh);
- `dma` (:185-230) compares the idx kernel (K1) with the manual-DMA
  variant (K2), which are one kernel in the port (masks.cu).

Runs on the card and raises without a GPU; `run(device="cpu")` runs the
same steps eagerly at a size the tests choose.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.benchmarks import bench as pbench
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_ENVS = int(os.environ.get("BENCH_ENVS", 4096))
CHUNK = 30
REPEATS = 5
UNROLLS = (1, 2, 4)
PROBES = ("unroll", "fill")
# the fill probe's writes: (name, dtype, bytes per uint8 byte, kind); the
# script's three, then `fill_` of a constant, torch's store floor
FILLS = (("uint8 fill_ (carried)", torch.uint8, 1, "carried"),
         ("uint8 iota+i (carried)", torch.uint8, 1, "iota"),
         ("float32 fill_ (carried)", torch.float32, 4, "carried"),
         ("uint8 fill_ (constant)", torch.uint8, 1, "constant"),
         ("float32 fill_ (constant)", torch.float32, 4, "constant"))


def config() -> Dict:
    """exp_r3c.py `_config` (:35-48)."""
    return {
        "sim": {"fps": 30, "observation_space_format": "classes"},
        "car": {"wheelbase": 0.0487, "track_width": 0.027,
                "max_velocity": 0.15, "max_steering_angle": 30,
                "steering_speed": 30, "max_acceleration": 0.1,
                "max_deceleration": 1.0},
        "camera": {"position": [0.0, -0.005, 0.04],
                   "orientation": [22, 0, 0], "resolution": [128, 160],
                   "fov": 80, "max_range": 0.5, "line_thickness": 2},
        "map": {"json_path": os.path.join(
            REPO, "examples/maps/simple_layout.json"),
            "pixel_per_meter": 450},
    }


def _median_ms(run_chunk: Callable[[], None], cuda: bool,
               repeats: int = REPEATS) -> float:
    """ms of run_chunk(), median of `repeats` after a warm call, each
    ended by a synchronize."""
    run_chunk()
    times = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        run_chunk()
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def probe_unroll(dev, n_envs: int = N_ENVS, chunk: int = CHUNK,
                 unrolls=UNROLLS, resolution=None) -> List[Dict]:
    """bench.py's step captured `u` steps to a graph for each u in
    `unrolls` (eagerly on the CPU), replayed to `chunk` steps: [{"unroll",
    "ms_step", "env_steps_per_s", "launches" (the masks kernel's at
    capture: u, or the steps run on the CPU)}]."""
    cfg = config()
    if resolution is not None:
        cfg["camera"]["resolution"] = list(resolution)
    params = fenv.make_env_params(cfg, device=dev)
    cuda = dev.type == "cuda"
    body = pbench.make_body(params, n_envs)
    vstate, _ = vector.reset(params, n_envs, seed=0, render=False)
    info = fenv._info(params, vstate.env)
    state = [vstate, {"cte": info["cte"],
                      "heading_error": info["heading_error"]},
             torch.zeros((), dtype=torch.int64, device=dev)]

    def eager(u):
        def run():
            for _ in range(u):
                state[:] = body(*state)[:3]
        return run

    if cuda:
        graphs.warm_up(eager(1), pbench.WARMUP)
        static = pbench.carried(*state)
        graphs.check_distinct(static, "exp_r3c unroll")

        def capture(u):
            def captured():
                carry = list(state)
                for _ in range(u):
                    carry[:] = body(*carry)[:3]
                for dst, src in zip(static, pbench.carried(*carry)):
                    dst.copy_(src)
            return graphs.capture(captured,
                                  generators=(state[0].generator,))

    out, one = [], None
    for u in unrolls:
        launches = rk.masks_kernel.launches
        if cuda:
            graph = capture(u)
            at_capture = rk.masks_kernel.launches - launches
            one = graph if u == 1 else (one or capture(1))
            full, rest = divmod(chunk, u)

            def run_chunk(graph=graph, one=one, full=full, rest=rest):
                for _ in range(full):
                    graph.replay()
                for _ in range(rest):
                    one.replay()
        else:
            run_chunk = eager(chunk)
        ms = _median_ms(run_chunk, cuda) / chunk
        if int(state[2]) <= 0:
            raise RuntimeError("exp_r3c: observations were not rendered")
        out.append({"unroll": u, "ms_step": ms,
                    "env_steps_per_s": n_envs / (ms / 1e3),
                    "launches": at_capture if cuda
                    else rk.masks_kernel.launches - launches})
    return out


def probe_fill(dev, n_envs: int = N_ENVS, chunk: int = CHUNK) -> List[Dict]:
    """The observation's store floors (module docstring): [{"name",
    "ms_write", "gb_s"}]."""
    shape = (n_envs, 5, 128, 160)
    nbytes = n_envs * 5 * 128 * 160
    cuda = dev.type == "cuda"
    out = []
    for name, dtype, mult, kind in FILLS:
        i = torch.ones((), dtype=torch.uint8, device=dev)
        buf = torch.zeros(shape, dtype=dtype, device=dev)

        def write(i=i, buf=buf, kind=kind):
            if kind == "iota":
                buf.copy_((torch.arange(shape[-1], dtype=torch.int32,
                                        device=dev).to(torch.uint8)
                           + i).expand(shape))
            elif kind == "carried":
                buf.fill_(i)
            else:
                buf.fill_(1)
            i.add_(1)

        step = write
        if cuda:
            graphs.warm_up(write)
            step = graphs.capture(write).replay

        def run_chunk(step=step):
            for _ in range(chunk):
                step()

        ms = _median_ms(run_chunk, cuda) / chunk
        if int(buf[:, :, 60:64].sum(dtype=torch.int64)) <= 0:
            raise RuntimeError(f"exp_r3c {name}: nothing written")
        out.append({"name": name, "ms_write": ms,
                    "gb_s": nbytes * mult / (ms / 1e3) / 1e9})
    return out


def run(device="cuda", probes=PROBES, n_envs: int = N_ENVS,
        chunk: int = CHUNK, resolution=None) -> Dict:
    """The probes (module docstring); returns the JSON line's dict."""
    dev = resolve_device(device)
    result = {"metric": "graph length and store floors (exp_r3c)",
              "n_envs": n_envs, "chunk": chunk}
    for name in probes:
        if name == "unroll":
            result["unroll"] = probe_unroll(dev, n_envs, chunk,
                                            resolution=resolution)
        elif name == "fill":
            result["fill"] = probe_fill(dev, n_envs, chunk)
        else:
            raise ValueError(f"unknown probe {name!r}: one of {PROBES} "
                             "(geom and dma are not ported: see the "
                             "module's docstring)")
    result["device"] = card_line() if dev.type == "cuda" else "cpu"
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    result = run(probes=tuple(argv) or PROBES)
    for name in result:
        if name == "unroll":
            print("== unroll ==")
            for r in result[name]:
                print(f"unroll={r['unroll']}: {r['ms_step']:.3f} ms/step = "
                      f"{r['env_steps_per_s']:,.0f} env-steps/s")
        elif name == "fill":
            print("== fill ==")
            for r in result[name]:
                print(f"{r['name']}: {r['ms_write']:.3f} ms/write = "
                      f"{r['gb_s']:,.0f} GB/s")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
