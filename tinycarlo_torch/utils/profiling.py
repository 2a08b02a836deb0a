"""Profiling, tracing and throughput helpers.

Counterpart of tinycarlo_tpu/utils/profiling.py (the reference profiles
with `DEBUG=1` wall-clock prints, tinycarlo/env.py:144-145, and ad-hoc
steps/s counters, stanley_control.py:63):
  * `tracing()`: the port's tracer, spans and counters inside the
    program that survive CUDA-graph replay (below);
  * `trace(...)`: a context manager around `torch.profiler` (the host and,
    on the card, CUDA activity) that writes a Chrome trace of the work in
    its block and keeps the profile for `key_averages()`;
  * `StepsPerSecond`: a throughput meter that synchronises the card
    before it reads the clock (the JAX package calls block_until_ready).

The tracer
----------
`with profiling.tracing() as tr:` turns tracing on in this process, one
session at a time; off is the default. Inside the block:

  * `span(name)` records a host span (name, start, end, parent, call id)
    in memory, stamped with `time.time_ns()`, the clock `torch.profiler`
    stamps its events in, so spans and a profile of the same work line up.
    `span(name, call=True)` starts a new call id, which the spans opened
    inside it share (one `vector.rollout` call, one `env.step()`). While a
    profiler is recording, a span also opens a `record_function` of its
    name, so the profile's events fall inside it.
  * `device_span(name, device)` is a span that survives graph replay: on a
    CUDA device it enqueues a one-thread mark kernel
    (`ops/csrc/trace_mark.cu`) at entry and exit, eager or under capture,
    which writes (mark id, the card's clock) into a device ring at a slot
    taken by an atomic, so every replay of a captured graph writes stamps
    of its own. On the CPU the mark reads `time.time_ns()` (the work runs
    synchronously). `tr.device_spans()` gives them on the host clock: the
    ring is read back once, after one synchronize, when the block ends,
    and the card's clock is put on the host's by offsets measured when the
    block starts and ends (a mark between two host reads around a
    synchronize). A ring that wraps keeps its newest RING_MARKS marks and
    counts the rest in `tr.counters["trace.marks_lost"]`; it never blocks.
  * `count(name, n)` adds to a host counter; `device_count(name, t)` adds
    the sum of a device tensor into a device accumulator (captured into a
    graph like any other work), read back with the ring. A capture that
    counts on the host holds its counts (`held_counts`), and
    `graphs.StepGraphs` adds them at each replay (`add_counts`).
  * `tr.counters`, `tr.spans` and `tr.device_spans()` hold the results.

Off, `span` and `device_span` return one shared no-op context after one
check of a module-level variable, and the counters return at once: no
`record_function`, no dispatcher call, no allocation, nothing enqueued.
So a graph captured with tracing off is the graph of untraced code, kernel
for kernel; `graphs.StepGraphs` keys its graphs by `enabled()`.

Names in the port (spans are host spans unless marked device):

  | Name | Where |
  |---|---|
  | `rollout` (call) | one `vector.rollout` call |
  | `rollout.warmup`, `rollout.capture` | around its eager steps and its capture |
  | `rollout.replay` | around each replay of its graph |
  | `rollout.step` (device) | one whole step, eager or in the captured graph |
  | `vector.step`, `vector.render` (device) | `vector.step`; its render |
  | `render`, `render.compact` (device) | `env.render_observation_batch`; its projection and compaction (the front kernel on the card; under the exact stroke the compaction alone) |
  | `gym.step` (call), `gym.stage_in`, `gym.replay`, `gym.wait`, `gym.unpack` | `TinyCarloEnv.step`: action staging and copy in; the graph's replay; the copy out and its synchronize; unpacking and `_convert_info` |
  | `td3.policy` ... `td3.update` (device) | the stages of `train.td3_loop._step` (`td3_loop.STAGES`) |

Counters: `render.copies` (host; B x LE, the copies each render's
compaction routes, counted per eager render and per replay),
`render.live_copies` and `render.dropped_copies` (device; rows 0 and 3 of
the compaction's `counts`, summed over the batch each render). Live over
copies is the compaction's useful share. `render.dropped_copies` is the
in-graph form of `env.check_segment_overflow`: eligible copies that found
no slot under `camera.max_visible_segments`; nonzero means lost pixels,
and an operator raises the budget until it reads 0. `render.front`
(host): the envs whose bundle the front kernel (ops/csrc/front.cu) wrote,
counted per render like `render.copies`; beside the envs rendered, the
share of renders the kernel takes. `td3.updates`, `td3.actor_updates`
(host): the TD3 updates a `train.td3_loop` step ran, and of them the
actor updates; `td3.rows_inserted` (host): the replay rows the step
wrote (its batch, duplicates of a slot included). Each is counted per
eager step and per replay, like `render.copies`. `car.kernel` (host):
the envs whose step's per-car work the car kernel (ops/csrc/car.cu)
took, counted per `env.step` call like `render.front`; beside the envs
stepped, the share of steps the kernel takes. `car.resnaps` (device): the
cars that ran the kernel's u-turn re-snap scan, the u-turn entries (the
torch composition scans for every car). `trace.marks_lost`: device-span
marks the ring overwrote.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# marks a ring holds (16 bytes each on the card)
RING_MARKS = 1 << 20
# device counters a process can name
MAX_COUNTERS = 64

_tracer: Optional["Tracer"] = None
_NOOP = contextlib.nullcontext()
# Process-wide registries: a captured graph keeps the mark ids, counter
# slots and buffer addresses it was captured with, so none of them is
# ever renumbered or freed.
_NAMES: List[str] = []
_IDS: Dict[str, int] = {}
_COUNTERS: Dict[str, int] = {}
_RINGS: Dict[Tuple[int, int], "_Ring"] = {}
_LAUNCH = []


@dataclass
class Span:
    """A host or device span; times in ns on the host clock (`time.time_ns`).
    `parent` indexes the enclosing span of the same list (-1 at the top);
    `call_id` is 0 outside a call (and on device spans); `replayed` marks a
    device span enqueued under capture, so written by a graph's replay."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call_id: int = 0
    replayed: bool = False


def enabled() -> bool:
    """Whether a tracing session is open."""
    return _tracer is not None


def span(name: str, call: bool = False):
    """A host span (module docstring); `call` starts a new call id."""
    tr = _tracer
    if tr is None:
        return _NOOP
    return _HostSpan(tr, name, call)


def device_span(name: str, device=None):
    """A span that survives graph replay, of work enqueued on `device`
    (default: the card when there is one)."""
    tr = _tracer
    if tr is None:
        return _NOOP
    return _DeviceSpan(tr, name, device)


def count(name: str, n: int) -> None:
    """Add `n` to the host counter `name`."""
    tr = _tracer
    if tr is not None:
        tr._count(name, n)


def device_count(name: str, tensor: torch.Tensor) -> None:
    """Add the sum of `tensor` to the counter `name`, on its device."""
    tr = _tracer
    if tr is not None:
        tr._device_count(name, tensor)


@contextlib.contextmanager
def held_counts() -> Iterator[Dict[str, int]]:
    """Around a capture: the host counts made inside are held in the dict
    it yields, not added, since the capture runs nothing; the code that
    replays the graph adds them at each replay (`add_counts`)."""
    held: Dict[str, int] = {}
    tr = _tracer
    if tr is None:
        yield held
        return
    prev, tr._held = tr._held, held
    try:
        yield held
    finally:
        tr._held = prev


def add_counts(counts: Dict[str, int]) -> None:
    """Add held counts (one replay's)."""
    tr = _tracer
    if tr is not None:
        for name, n in counts.items():
            tr._count(name, n)


@contextlib.contextmanager
def tracing() -> Iterator["Tracer"]:
    """Turn tracing on for the block; yields the session's Tracer, whose
    device spans and counters are read back when the block ends."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("tracing is already on")
    tr = Tracer()
    _tracer = tr
    try:
        yield tr
    finally:
        _tracer = None
        tr._finish()


def _profiler_range(name: str):
    """A `record_function` of `name`, entered, while a profiler records."""
    if not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _HostSpan:
    __slots__ = ("tr", "name", "call", "i", "rf")

    def __init__(self, tr: "Tracer", name: str, call: bool):
        self.tr, self.name, self.call = tr, name, call

    def __enter__(self):
        tr = self.tr
        parent = tr._stack[-1] if tr._stack else -1
        if self.call:
            tr._calls += 1
            call_id = tr._calls
        else:
            call_id = tr.spans[parent].call_id if parent >= 0 else 0
        self.i = len(tr.spans)
        tr.spans.append(Span(self.name, time.time_ns(), -1, parent, call_id))
        tr._stack.append(self.i)
        self.rf = _profiler_range(self.name)
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        tr = self.tr
        tr.spans[self.i].end_ns = time.time_ns()
        if tr._stack and tr._stack[-1] == self.i:
            tr._stack.pop()
        return False


class _DeviceSpan:
    __slots__ = ("tr", "name", "device", "rf")

    def __init__(self, tr: "Tracer", name: str, device):
        self.tr, self.name, self.device = tr, name, device

    def __enter__(self):
        self.rf = _profiler_range(self.name)
        self.tr._mark(self.name, self.device, 0)
        return self

    def __exit__(self, *exc):
        self.tr._mark(self.name, self.device, 1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _launcher():
    """The mark kernel's C launch (ops/csrc/trace_mark.cu), loaded once."""
    if not _LAUNCH:
        from tinycarlo_torch.ops._build import libraries

        fn = libraries.get("trace_mark").tc_trace_mark_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def _launch_mark(ring: torch.Tensor, head: torch.Tensor, cap: int,
                 mark_id: int) -> None:
    """One mark into `ring` (cap x 2 int64) on its device's current
    stream; raises if the launch failed."""
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream(ring.device).cuda_stream
        err = _launcher()(ring.data_ptr(), head.data_ptr(), cap, mark_id,
                          stream)
    if err != 0:
        raise RuntimeError(f"trace mark launch failed: CUDA error {err}")


class _Ring:
    """A card's mark ring, its head and its counter accumulators; kept for
    the process (graphs captured under tracing write into them)."""

    def __init__(self, index: int, cap: int):
        self.device = torch.device("cuda", index)
        self.cap = cap
        z = dict(dtype=torch.int64, device=self.device)
        self.ring = torch.zeros((cap, 2), **z)
        self.head = torch.zeros(1, **z)
        self.acc = torch.zeros(MAX_COUNTERS, **z)
        self.cal = torch.zeros((1, 2), **z)
        self.cal_head = torch.zeros(1, **z)

    def mark(self, mark_id: int) -> None:
        _launch_mark(self.ring, self.head, self.cap, mark_id)

    def reset(self) -> None:
        self.head.zero_()
        self.acc.zero_()

    def calibrate(self, tries: int = 5) -> Tuple[int, int]:
        """(card clock, offset to the host clock) of a mark: each try puts
        the offset between the host reads before the launch and after the
        synchronize; the estimate is the middle of where they all agree
        (of the narrowest try's bounds if they do not)."""
        lo, hi, best = None, None, None
        g = 0
        for _ in range(tries):
            torch.cuda.synchronize(self.device)
            h0 = time.time_ns()
            _launch_mark(self.cal, self.cal_head, 1, 0)
            torch.cuda.synchronize(self.device)
            h1 = time.time_ns()
            g = int(self.cal[0, 1].item())
            lo = h0 - g if lo is None else max(lo, h0 - g)
            hi = h1 - g if hi is None else min(hi, h1 - g)
            if best is None or h1 - h0 < best[1] - best[0]:
                best = (h0 - g, h1 - g)
        if lo > hi:
            lo, hi = best
        return g, (lo + hi) // 2


class Tracer:
    """One tracing session's spans, counters and device marks."""

    def __init__(self):
        self.ring_marks = RING_MARKS
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self._stack: List[int] = []
        self._calls = 0
        self._held: Optional[Dict[str, int]] = None
        self._host_marks = collections.deque(maxlen=RING_MARKS)
        self._host_taken = 0
        self._rings: Dict[int, _Ring] = {}
        self._starts: Dict[int, Tuple[int, int]] = {}
        self._device_spans: List[Span] = []
        self._device_counters = set()
        # {device index: (offset ns at the start, at the end)}
        self.offsets: Dict[int, Tuple[int, int]] = {}
        if torch.cuda.is_available():
            self._ring(torch.cuda.current_device())

    def device_spans(self) -> List[Span]:
        """The device spans, on the host clock, in the order their begin
        marks ran (complete once the session has ended)."""
        return self._device_spans

    # -- recording ---------------------------------------------------------

    def _count(self, name: str, n: int) -> None:
        if self._held is not None:
            self._held[name] = self._held.get(name, 0) + int(n)
        else:
            self.counters[name] += int(n)

    def _device_count(self, name: str, tensor: torch.Tensor) -> None:
        if tensor.device.type != "cuda":
            self.counters[name] += int(tensor.sum())
            return
        slot = _COUNTERS.get(name)
        if slot is None:
            if len(_COUNTERS) >= MAX_COUNTERS:
                raise RuntimeError(f"more than {MAX_COUNTERS} device counters")
            slot = _COUNTERS[name] = len(_COUNTERS)
        self._device_counters.add(name)
        ring = self._ring(tensor.device.index)
        ring.acc[slot:slot + 1].add_(tensor.sum(dtype=torch.int64))

    def _mark(self, name: str, device, end: int) -> None:
        nid = _IDS.get(name)
        if nid is None:
            nid = _IDS[name] = len(_NAMES)
            _NAMES.append(name)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type != "cuda":
            self._host_marks.append((nid * 4 + end, time.time_ns()))
            self._host_taken += 1
            return
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        captured = int(torch.cuda.is_current_stream_capturing())
        self._ring(index).mark(nid * 4 + 2 * captured + end)

    def _ring(self, index: int) -> _Ring:
        ring = self._rings.get(index)
        if ring is not None:
            return ring
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"tracing: cuda:{index} was first marked under a capture; "
                "make it the current device before tracing starts")
        ring = _RINGS.get((index, self.ring_marks))
        if ring is None:
            ring = _RINGS[(index, self.ring_marks)] = _Ring(
                index, self.ring_marks)
        ring.reset()
        self._rings[index] = ring
        self._starts[index] = ring.calibrate()
        return ring

    # -- reading back ------------------------------------------------------

    def _finish(self) -> None:
        marks = []
        lost = max(0, self._host_taken - self.ring_marks)
        host = list(self._host_marks)
        for index, ring in self._rings.items():
            torch.cuda.synchronize(ring.device)
            g1, off1 = ring.calibrate()
            g0, off0 = self._starts[index]
            head = int(ring.head.item())
            acc = ring.acc.cpu().tolist()
            for name in self._device_counters:
                self.counters[name] += acc[_COUNTERS[name]]
            n = min(head, ring.cap)
            lost += head - n
            # the newest n marks, oldest first
            order = torch.roll(ring.ring, -(head % ring.cap), 0) \
                if head > ring.cap else ring.ring[:n]
            order = order.cpu().tolist()
            self.offsets[index] = (off0, off1)
            rate = (off1 - off0) / (g1 - g0) if g1 != g0 else 0.0
            marks.append([(m, g + off0 + int(rate * (g - g0)))
                          for m, g in order])
        self.counters["trace.marks_lost"] += lost
        self._device_spans = pair_marks(host)
        for device_marks in marks:
            self._device_spans += pair_marks(device_marks)


def pair_marks(marks) -> List[Span]:
    """Device spans from (mark id, host ns) marks in the order they ran:
    an end closes the innermost open span of its name (spans opened inside
    it that never closed, and ends whose begin the ring lost, are
    dropped)."""
    out: List[Span] = []
    stack: List[int] = []
    for mark_id, t in marks:
        name = _NAMES[mark_id >> 2]
        if not mark_id & 1:
            out.append(Span(name, t, -1, stack[-1] if stack else -1,
                            replayed=bool(mark_id & 2)))
            stack.append(len(out) - 1)
            continue
        for j in range(len(stack) - 1, -1, -1):
            if out[stack[j]].name == name:
                out[stack[j]].end_ns = t
                del stack[j:]
                break
    keep = {i: k for k, i in enumerate(
        i for i, s in enumerate(out) if s.end_ns >= 0)}
    spans = [out[i] for i in keep]
    for s in spans:
        s.parent = keep.get(s.parent, -1)
    return spans


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
