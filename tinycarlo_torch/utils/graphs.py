"""How a step of the port becomes a replayed CUDA graph, in one place.

The pattern: run the step eagerly first (`warm_up`: every kernel launched
and its launcher's one-time setup done outside the capture), then capture
one step that reads static tensors and writes its new values back into
them (`capture`), so that each `replay()` advances the state by one step.
The generators the step draws from are registered with the graph, so each
replay draws what an eager step would. Every warm-up and capture runs on
one side stream per card (`side_stream`), made at first use and kept for
the process: autograd records the stream a gradient's leaves were first
used on, so a training step's first use and its capture share it, and a
library's per-stream state (such as cuBLAS's workspace) is made once, not
once a call. Kernel launch counters count at capture only; a replay passes no
Python.

`StepGraphs` is the entry points' cache of captured steps, each keyed by
its owner's key and the tracing mode (`vector.rollout`,
`gym_env.TinyCarloEnv`, `train.td3_loop.chunk`, `train.il.train_chunk`,
`train.il.Collector`); the measurement scripts under benchmarks/ call the
primitives (`warm_up`, `capture`, `capture_carried`).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
from torch import nn

from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils import profiling


def tensors(obj) -> List[torch.Tensor]:
    """The tensors of a state, in a fixed order: dataclass fields, dict
    values, tuple and list items, a module's parameters and buffers;
    generators, numbers and None are skipped."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in tensors(v)]
    return []


def copy_into(dst, src) -> None:
    """Copy every tensor of `src` into its counterpart of `dst` (the same
    structure), in place."""
    a, b = tensors(dst), tensors(src)
    if len(a) != len(b):
        raise ValueError(f"states differ: {len(a)} and {len(b)} tensors")
    with torch.no_grad():
        for d, s in zip(a, b):
            if d is not s:
                d.copy_(s)


def check_distinct(ts: Iterable[torch.Tensor], what: str) -> None:
    """Raise if two of the tensors start at the same address: a step that
    writes one of them back would clobber the other."""
    ts = list(ts)
    if len({t.data_ptr() for t in ts}) != len(ts):
        raise RuntimeError(f"{what}: the step's carried tensors share "
                           "storage")


_STREAMS: Dict[int, torch.cuda.Stream] = {}


def side_stream() -> torch.cuda.Stream:
    """The current card's stream for warm-ups and captures, made at first
    use and kept for the process."""
    index = torch.cuda.current_device()
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(index)
    return stream


def warm_up(fn: Callable, times: int = 1):
    """fn() `times` times on the side stream, then wait for it; returns the
    last result."""
    stream = side_stream()
    stream.wait_stream(torch.cuda.current_stream())
    out = None
    with torch.cuda.stream(stream):
        for _ in range(times):
            out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    return out


def capture(step: Callable[[], None], kernels: Sequence = (),
            generators: Iterable[torch.Generator] = (),
            pool=None) -> torch.cuda.CUDAGraph:
    """One call of `step()` (which writes its results into static tensors)
    captured as a CUDA graph on the side stream, with `generators`
    registered (each once) and the memory `pool` of another graph shared
    when given. Raises unless each of `kernels` (wrappers with a
    `launches` count, as `env.render_kernels` gives them) was launched
    exactly once during the capture."""
    return _record(step, dict.fromkeys(kernels, 1), generators, pool)[0]


def _record(step: Callable, launches: Dict[Any, int],
            generators: Iterable[torch.Generator], pool):
    """(graph, step()'s result as captured), as `capture`; raises unless
    each kernel wrapper of `launches` recorded its count of launches."""
    graph = torch.cuda.CUDAGraph()
    seen = []
    for g in generators:
        if g is not None and all(g is not s for s in seen):
            graph.register_generator_state(g)
            seen.append(g)
    before = {k: k.launches for k in launches}
    with torch.cuda.graph(graph, pool=pool, stream=side_stream()):
        out = step()
    recorded = {k.NAME: k.launches - n for k, n in before.items()}
    want = {k.NAME: n for k, n in launches.items()}
    if recorded != want:
        raise RuntimeError(f"the captured step recorded the launches "
                           f"{recorded}, not {want}")
    return graph, out


class StepGraphs:
    """An owner's captured steps on `device`, keyed by the owner's key and
    the tracing mode (`profiling.enabled()`): a graph captured with tracing
    on carries its marks and replays only while tracing is on. The graphs
    share one memory pool, so a graph's static result holds until another
    of them replays; what a step carries to the next lives in tensors made
    outside the capture. `eager` counts the steps run eagerly (warm-ups
    included), `captures` and `replays` the graphs' (`replays_by_key` by
    the owner's key); with a `name`, each replay is the host span
    "<name>.replay"."""

    def __init__(self, device, name: Optional[str] = None):
        self.cuda = torch.device(device).type == "cuda"
        self.name = name
        # (key, tracing) -> (graph, static result, held host counts)
        self.entries: Dict[Tuple[Any, bool], tuple] = {}
        self.pool = None
        self.eager = self.captures = self.replays = 0
        self.replays_by_key: Dict[Any, int] = {}

    def run(self, key, fn: Callable, graph: bool = True,
            kernels: Sequence = (),
            generators: Iterable[torch.Generator] = ()):
        """One step: fn() off the card or with the owner's `graph` flag
        off; else the key's first call runs fn() eagerly (`warm_up`),
        captures it (`capture`) and returns the eager result, and each
        later call replays the graph and returns fn()'s result as
        captured."""
        if not (graph and self.cuda):
            self.eager += 1
            return fn()
        if (key, profiling.enabled()) in self.entries:
            return self.replay(key)
        out = warm_up(fn)
        self.eager += 1
        self.capture(key, fn, kernels, generators)
        return out

    def capture(self, key, fn: Callable, kernels: Sequence = (),
                generators: Iterable[torch.Generator] = ()) -> None:
        """fn, warmed up, captured as the graph of `key` with `generators`
        registered. The host counts it makes are held
        (`profiling.held_counts`) and each replay adds them. Raises unless
        each of `kernels` (`env.render_kernels` of a step that renders)
        was recorded once and every other render kernel
        (`rasterize_kernels.RENDER_KERNELS`) never."""
        launches = {k: 0 for k in rk.RENDER_KERNELS}
        launches.update(dict.fromkeys(kernels, 1))
        with profiling.held_counts() as held:
            graph, out = _record(fn, launches, generators, self.pool)
        self.pool = graph.pool()
        self.entries[(key, profiling.enabled())] = (graph, out, held)
        self.captures += 1

    def replay(self, key):
        """The graph of `key` replayed; returns its static result."""
        graph, out, held = self.entries[(key, profiling.enabled())]
        if self.name is None:
            graph.replay()
        else:
            with profiling.span(f"{self.name}.replay"):
                graph.replay()
        profiling.add_counts(held)
        self.replays += 1
        self.replays_by_key[key] = self.replays_by_key.get(key, 0) + 1
        return out


def capture_carried(body: Callable, state, carried: Callable,
                    kernels: Sequence = (),
                    generators: Iterable[torch.Generator] = (),
                    warmup: int = 1, what: str = "step"):
    """A step `body(*state) -> new state` captured over the state's own
    tensors: `warmup` eager steps on the side stream, then one step
    captured over the resulting state, writing its new values back into
    the tensors `carried(*state)` lists (which must not share storage).
    Returns (graph, state): the static state, which every `replay()`
    advances by one step. `kernels` and `generators` as in `capture`."""
    state = list(state)

    def eager():
        state[:] = body(*state)

    warm_up(eager, warmup)
    static = carried(*state)
    check_distinct(static, what)

    def step():
        for dst, src in zip(static, carried(*body(*state))):
            if dst is not src:
                dst.copy_(src)

    return capture(step, kernels, generators=generators), state


def deterministic(on: bool = True) -> None:
    """Switch torch to deterministic algorithms (and cuDNN to its
    deterministic, non-benchmarked ones), or back to the defaults. cuBLAS
    needs CUBLAS_WORKSPACE_CONFIG (":4096:8") set before its first call
    for bit-repeatable products across streams."""
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
