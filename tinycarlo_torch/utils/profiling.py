"""Profiling and throughput helpers.

Counterpart of tinycarlo_tpu/utils/profiling.py (the reference profiles
with `DEBUG=1` wall-clock prints, tinycarlo/env.py:144-145, and ad-hoc
steps/s counters, stanley_control.py:63):
  * `trace(...)`: a context manager around `torch.profiler` (the host and,
    on the card, CUDA activity) that writes a Chrome trace of the work in
    its block and keeps the profile for `key_averages()`;
  * `StepsPerSecond`: a throughput meter that synchronises the card
    before it reads the clock (the JAX package calls block_until_ready).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None
          ) -> Iterator[torch.profiler.profile]:
    """`with profiling.trace(dir) as prof: step(...)` writes
    `dir/trace.json` (open it in chrome://tracing or Perfetto) when the
    block ends; `prof.key_averages()` sums it by kernel. With a GPU
    present the trace holds the card's activity too. The default directory
    is tinycarlo_torch_trace under the temporary directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "tinycarlo_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(result) -> None:
    tensors = result if isinstance(result, (list, tuple)) else [result]
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)
               and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepsPerSecond:
    """Throughput meter: call `tick(n_steps, result)` after each chunk
    (`result`, a tensor or a list of them, is waited for on the card);
    `rate` leaves out the first tick (capture-bearing) by default."""

    def __init__(self, skip_first: bool = True):
        self.skip_first = skip_first
        self._steps = 0
        self._start: Optional[float] = None
        self._ticks = 0

    def tick(self, n_steps: int, result=None) -> None:
        if result is not None:
            _sync(result)
        self._ticks += 1
        if self.skip_first and self._ticks == 1:
            self._start = time.perf_counter()
            return
        if self._start is None:
            self._start = time.perf_counter()
        self._steps += n_steps

    @property
    def rate(self) -> float:
        if self._start is None or self._steps == 0:
            return 0.0
        return self._steps / (time.perf_counter() - self._start)
