"""Layout floors of the rgb frame on the card: how fast can a (B, 128, 160,
3) uint8 frame, its planar twin and the rank map be written at all, bare
and as the palette composite.

    python -m tinycarlo_torch.benchmarks.exp_r4_rgb

The counterpart of benchmarks/exp_r4_rgb.py (:36-113), which stays the
JAX package's. Its probes are XLA-native there (no Pallas kernel), so
they are plain torch ops here: `fill_` of a carried counter, and the
script's palette composite (rank = (column + i) % 6, then five
`torch.where`s of the palette's colours). Probes at BENCH_ENVS (4096) x
128 x 160, with the script's byte counts for the GB/s:

  fill-hwc     fill_ of the (B, 128, 160, 3) frame
  fill-planar  fill_ of the (B, 3, 128, 160) frame (the same bytes)
  fill-rank    fill_ of the (B, 128, 160) rank map
  comp-hwc     the composite into an HWC frame
  comp-planar  the composite, moved to (B, 3, H, W)
  fill-flat3   fill_ of the HWC bytes as (B, 128, 480)
  comp-flat3   the composite, reshaped to (B, 128, 480)
  comp-flat3r  the composite, reshaped to (B, 128, 480) and back to HWC

Views. In torch `movedim` and `reshape` of a contiguous tensor give views,
so each probe's frame is written into a carried buffer of its own layout
with `copy_`: the planar composite pays its transpose there, and a
reshape costs nothing. `comp-flat3r` is therefore `comp-flat3`'s
composite viewed back, the same work as `comp-hwc` (in XLA it may be a
relayout copy).

Each probe is one captured step (the frame of the uint8 counter i, then
i += 1), replayed CHUNK (30) times a repeat: a warm repeat, then the
median of 5, each ended by `torch.cuda.synchronize()`; its checksum sums
the script's band ([:, 60:62], or [:, :, 60:62] for planar) after the
repeat. Prints "name: ms/step = GB/s" as the script does, then one JSON
line.

Runs on the card and raises without a GPU; `run(device="cpu")` runs the
same steps eagerly (tests).
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import card_line, resolve_device

N_ENVS = int(os.environ.get("BENCH_ENVS", 4096))
CHUNK = 30
REPEATS = 5
H, W = 128, 160
# exp_r4_rgb.py:32-35
PALETTE = ((255, 255, 255), (0, 200, 0), (0, 0, 200), (200, 0, 0),
           (80, 80, 80))
PROBES = ("fill-hwc", "fill-planar", "fill-rank", "comp-hwc",
          "comp-planar", "fill-flat3", "comp-flat3", "comp-flat3r")


def palette(dev) -> torch.Tensor:
    """(5, 3) uint8 colours on `dev` (made outside a capture: a host
    copy cannot be captured)."""
    return torch.tensor(PALETTE, dtype=torch.uint8, device=dev)


def composite(i: torch.Tensor, n: int, h: int = H, w: int = W,
              planar: bool = False, colors=None) -> torch.Tensor:
    """The script's composite (exp_r4_rgb.py:77-87) for the uint8 counter
    i: rank = (column + i) % 6 in uint8, then pixel by pixel the palette
    colour of rank l + 1, black where none; (n, h, w, 3), or with
    `planar` its (n, 3, h, w) view. `colors`: `palette(i.device)`."""
    dev = i.device
    colors = palette(dev) if colors is None else colors
    rank = torch.remainder(
        torch.arange(w, dtype=torch.uint8, device=dev) + i, 6
    ).expand(n, h, w)
    frame = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=dev)
    for layer in range(5):
        frame = torch.where((rank == layer + 1)[..., None], colors[layer],
                            frame)
    return frame.movedim(-1, 1) if planar else frame


def probes(n: int, dev, h: int = H, w: int = W) -> List[
        Tuple[str, Tuple[int, ...], Callable, int, bool]]:
    """(name, buffer shape, frame(i), bytes a step, planar band) of each
    probe, in the script's order, with its byte counts."""
    hwc, planar = (n, h, w, 3), (n, 3, h, w)
    rank, flat3 = (n, h, w), (n, h, w * 3)
    nb_hwc, nb_rank = n * h * w * 3, n * h * w
    colors = palette(dev)

    def comp(**kw):
        return lambda i: composite(i, n, h, w, colors=colors, **kw)

    return [
        ("fill-hwc", hwc, None, nb_hwc, False),
        ("fill-planar", planar, None, nb_hwc, True),
        ("fill-rank", rank, None, nb_rank, False),
        ("comp-hwc", hwc, comp(), nb_hwc + nb_rank, False),
        ("comp-planar", planar, comp(planar=True), nb_hwc + nb_rank, True),
        ("fill-flat3", flat3, None, nb_hwc, False),
        ("comp-flat3", flat3, lambda i: comp()(i).reshape(flat3),
         nb_hwc + nb_rank, False),
        ("comp-flat3r", hwc, lambda i: comp()(i).reshape(flat3).reshape(
            hwc), nb_hwc + nb_rank, False),
    ]


def timed(name, shape, frame, nbytes, planar, dev, chunk: int = CHUNK,
          repeats: int = REPEATS) -> Dict:
    """One probe: {"name", "ms" (median a step), "gb_s", "all", "checksum"
    (the last repeat's band sum)}."""
    cuda = dev.type == "cuda"
    i = torch.ones((), dtype=torch.uint8, device=dev)
    buf = torch.zeros(shape, dtype=torch.uint8, device=dev)

    def step():  # the frame of i, then i + 1 (the script's scan body)
        if frame is None:
            buf.fill_(i)
        else:
            buf.copy_(frame(i))
        i.add_(1)

    if cuda:
        graphs.warm_up(step)
        step = graphs.capture(step).replay
    times, checksum = [], 0
    for rep in range(repeats + 1):
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(chunk):
            step()
        if cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        band = buf[:, :, 60:62] if planar else buf[:, 60:62]
        checksum = int(band.sum(dtype=torch.int64))
        if rep:
            times.append(elapsed * 1e3 / chunk)
    ms = statistics.median(times)
    return {"name": name, "ms": ms, "gb_s": nbytes / (ms / 1e3) / 1e9,
            "all": times, "checksum": checksum}


def run(device="cuda", n_envs: int = N_ENVS, chunk: int = CHUNK,
        repeats: int = REPEATS, names=PROBES) -> Dict:
    """The probes `names` (module docstring); returns the JSON line's
    dict."""
    dev = resolve_device(device)
    results = [timed(*p, dev, chunk, repeats)
               for p in probes(n_envs, dev) if p[0] in names]
    return {"metric": "rgb layout floors, ms a step and GB/s",
            "n_envs": n_envs, "chunk": chunk, "probes": results,
            "device": card_line() if dev.type == "cuda" else "cpu"}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    result = run(names=tuple(argv) or PROBES)
    for r in result["probes"]:
        print(f"{r['name']:<11}: {r['ms']:.3f} ms/step = "
              f"{r['gb_s']:,.0f} GB/s", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
