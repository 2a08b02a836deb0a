"""CUDA graph capture of a step over static tensors, shared by the
headline bench (benchmarks/bench.py), `vector.rollout` and the TD3 loop
(train/td3_loop.py).

The pattern: run the step eagerly on a side stream first (`warm_up`: every
kernel launched and its launcher's one-time setup done outside the
capture), then capture one step that reads the state's tensors and writes
its new values back into them (`capture`; `capture_carried` does both for
a step that maps a state to its next), so that each `replay()` advances
the state by one step. The generators the step draws from are
registered with the graph, so each replay draws what an eager step would.
A capture raises unless each render kernel (`env.render_kernels`: the
front kernel and the masks or rank kernel, or the exact kernel) was
recorded exactly once: a graph that rendered nothing, or twice, is not
the step it stands for.
Kernel launch counters count at capture only; a replay passes no Python.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Sequence

import torch
from torch import nn


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


def warm_up(fn: Callable, times: int = 1, stream=None):
    """fn() `times` times on a side stream (`stream`, or a new one), then
    wait for it; returns the last result."""
    stream = torch.cuda.Stream() if stream is None else stream
    stream.wait_stream(torch.cuda.current_stream())
    out = None
    with torch.cuda.stream(stream):
        for _ in range(times):
            out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    return out


def capture(step: Callable[[], None], kernels: Sequence = (),
            generators: Iterable[torch.Generator] = (), pool=None,
            stream=None) -> torch.cuda.CUDAGraph:
    """One call of `step()` (which writes its results into static tensors)
    captured as a CUDA graph on `stream` (default: torch's capture
    stream), with `generators` registered (each once) and the memory
    `pool` of another graph shared when given. Raises unless each of
    `kernels` (wrappers with a `launches` count, as
    `env.render_kernels` gives them) was launched exactly once during the
    capture."""
    graph = torch.cuda.CUDAGraph()
    seen = []
    for g in generators:
        if g is not None and all(g is not s for s in seen):
            graph.register_generator_state(g)
            seen.append(g)
    before = [k.launches for k in kernels]
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        step()
    for k, n in zip(kernels, before):
        if k.launches - n != 1:
            raise RuntimeError(
                f"the captured step launched the {k.NAME} kernel "
                f"{k.launches - n} times, not once")
    return graph


def capture_carried(body: Callable, state, carried: Callable,
                    kernels: Sequence = (),
                    generators: Iterable[torch.Generator] = (),
                    warmup: int = 1, what: str = "step"):
    """A step `body(*state) -> new state` captured over the state's own
    tensors: `warmup` eager steps on a side stream, then one step
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
