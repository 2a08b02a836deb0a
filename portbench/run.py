"""The benchmark of tinycarlo_torch on one NVIDIA H100: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell names an entry of
BENCHMARK.json's `workloads`; everything else is found by name:

- `portbench/workloads/<cell>.json`: the driver, the traffic's
  parameters and the limits of the comparison that decides `correct`;
- the configuration's file (BENCHMARK.json `configs[].file`) under
  `portbench/configs/`, its map beside it;
- `portbench/drivers/<driver>.py`: set-up, the measured window, the
  traced window and the comparison with `portbench/reference/`;
- `portbench/layer_metrics/<metric>.py`: one reader per per-layer metric.

A run: set-up (the program's state from the seed, every shape of the
cell warmed, kernels built), then `--seconds` of measured work with
`--trace 0` (the end-to-end metrics) or a profiled window with `--trace
1` (the per-layer metrics, `busy_s`, `window_s`, `breakdown`); then, with
the program's state freed, the comparison with the plain reference. The
last line of stdout is one JSON object; the numbers compared, each with
its limit, are the last lines of stderr and the line's last key.

Exits 2 without a card (or with fewer cards than the cell asks for) and 3
when a forbidden module (JAX or the JAX package) is loaded, printing no
result in either case.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench import peaks  # noqa: E402

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
# top-level module names a run may not load: JAX, its libraries, the JAX
# package and the JAX-era scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tinycarlo_tpu",
             "benchmarks", "bench", "examples")


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or the time
    this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def refused() -> bool:
    """Whether a forbidden module is loaded; names them on stderr."""
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
    return bool(bad)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the harness's own folders, loaded by file path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA libraries into tinycarlo_torch/_build/)."""
    cache = os.path.join(PB, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")


class Run:
    """What a driver is given: the cell, its configuration and traffic,
    the seed, the device and the limits of its comparison."""

    def __init__(self, cell: str, config: Dict, config_file: str,
                 spec: Dict, seed: int, device, seconds: float):
        self.cell = cell
        self.config = config
        self.config_file = config_file
        self.traffic = spec["traffic"]
        self.limits = spec.get("limits", {})
        self.seed = seed
        self.device = device
        self.seconds = seconds

    def env_config(self, fmt: Optional[str] = None) -> Dict:
        """The configuration's env dict with the map's path made absolute
        and, when given, the observation format set."""
        cfg = json.loads(json.dumps(self.config["config"]))
        cfg["map"]["json_path"] = os.path.join(
            os.path.dirname(self.config_file), cfg["map"]["json_path"])
        if fmt is not None:
            cfg["sim"]["observation_space_format"] = fmt
        return cfg


class Readers:
    """What a per-layer reader sees: the traced windows by name and the
    driver's counts (shapes, steps)."""

    def __init__(self, traces: Dict, facts: Dict):
        self.traces = traces
        self.facts = facts


def prepare(name: str, seed: int, seconds: float, device):
    """(manifest, workload entry, Run, driver module) of a cell, found by
    its name in BENCHMARK.json."""
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == wl["config"])
    spec = load_json(os.path.join(PB, "workloads", f"{name}.json"))
    config_file = os.path.join(ROOT, cfg_entry["file"])
    driver = load_module(os.path.join(PB, "drivers", f"{spec['driver']}.py"),
                         f"portbench_driver_{spec['driver']}")
    run = Run(name, load_json(config_file), config_file, spec, seed, device,
              seconds)
    return manifest, wl, run, driver


def cell_metrics(manifest: Dict, key: str, cell: str) -> List[Dict]:
    """The manifest's `key` metrics that this cell reports: those listing
    it under `workloads`, and those without the key."""
    return [m for m in manifest.get(key, [])
            if cell in m.get("workloads", [cell])]


def judge(checks: List[tuple]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def main(argv=None) -> int:
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_caches()
    import torch
    device = torch.device("cuda", 0)
    manifest, wl, run, driver = prepare(args.workload, args.seed,
                                        args.seconds, device)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {wl['name']} needs {wl['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(device)
    cell = driver.Cell(run)
    torch.cuda.synchronize()
    setup_s = time.time() - start

    if args.trace:
        traces, facts = cell.traced()
        result = {"attempted": facts["attempted"], "failed": facts["failed"]}
    else:
        result = cell.window(args.seconds)
    torch.cuda.synchronize()
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(wl["chips"]))
    if refused():
        return 3

    metrics = {}
    if args.trace:
        ctx = Readers(traces, facts)
        for m in cell_metrics(manifest, "per_layer", wl["name"]):
            reader = load_module(
                os.path.join(PB, "layer_metrics", f"{m['name']}.py"),
                "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(result["metrics"], setup_s=setup_s)
        for m in cell_metrics(manifest, "end_to_end", wl["name"]):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": wl["chips"], "memory_peak_bytes": int(peak),
           "power_limit_w": peaks.power_limit_w()}
    breakdown = None
    if args.trace:
        w = traces["window"]
        dev["busy_s"] = w.busy_s()
        dev["window_s"] = w.wall_s
        breakdown = {"device_ops": w.top_kernels(), "idle_gaps": w.idle_gaps()}
        del traces, ctx

    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = cell.check()
    print(f"portbench: the comparison took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    correct = judge(checks)
    if refused():
        return 3

    line = {"correct": correct, "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    sys.stdout.flush()
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
