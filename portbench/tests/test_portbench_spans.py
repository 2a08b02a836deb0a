"""The program-span readers (`portbench/spans.py`, the ten readers of
`layer_metrics/` that read `facts["program"]`) on made-up spans and
counters, None without them; and the spans pass without the profiler on
each driver at a tiny size on the CPU, whose gym steps equal the traced
window's from the same reset."""
import os

import numpy as np
import pytest

from portbench import run as harness
from portbench import spans
from portbench.tests.test_portbench_counts import make_trace
from portbench.tests.test_portbench_drivers import tiny_gym, tiny_rollout

PROGRAM_READERS = ("call_start_ms.rollout", "replay_launch_us.rollout",
                   "step_span_ms.rollout", "replay_gap_us.rollout",
                   "render_span_ms.rollout", "compact_span_ms.rollout",
                   "vector_step_span_ms.rollout", "live_copy_share.rollout",
                   "host_ms.gym", "wait_ms.gym")
MS = 1_000_000  # ns


def reader(name):
    return harness.load_module(
        os.path.join(harness.PB, "layer_metrics", f"{name}.py"),
        "reader_" + name.replace(".", "_"))


def rollout_program():
    """One call: 3 ms of eager steps, 2 ms of capture, then 3 replays of
    40 us whose steps take 3 ms on the card, 20, 30 us apart."""
    host = [("rollout", 0, 20 * MS, -1, 1),
            ("rollout.warmup", 0, 3 * MS, 0, 1),
            ("rollout.capture", 3 * MS, 5 * MS, 0, 1)]
    for i in range(3):
        b = 5 * MS + i * 50_000
        host.append(("rollout.replay", b, b + 40_000, 0, 1))
    dev = [("rollout.step", 0, 1 * MS, -1, False)]
    begin = 6 * MS
    for i, gap in enumerate((20_000, 30_000, None)):
        n = len(dev)
        dev += [("rollout.step", begin, begin + 3 * MS, -1, True),
                ("render", begin, begin + MS, n, True),
                ("render.compact", begin, begin + MS // 2, n + 1, True),
                ("vector.step", begin + MS, begin + 2 * MS + i, n, True)]
        if gap is not None:
            begin += 3 * MS + gap
    return {"spans": host, "device_spans": dev, "wall_s": 0.02, "steps": 4,
            "counters": {"render.copies": 400, "render.live_copies": 100,
                         "render.dropped_copies": 0}}


def gym_program():
    """Two steps of 1.5 ms, each waiting 1.0 ms; a reset's wait outside
    the steps."""
    host = [("gym.wait", 0, 5 * MS, -1, 0)]
    for call in (1, 2):
        b = call * 10 * MS
        i = len(host)
        host += [("gym.step", b, b + 1_500_000, -1, call),
                 ("gym.wait", b + 200_000, b + 1_200_000, i, call)]
    return {"spans": host, "device_spans": [], "counters": {},
            "wall_s": 0.01, "steps": 2}


def test_rollout_readers():
    ctx = harness.Readers({}, {"program": rollout_program()})
    got = {name: reader(name).read(ctx) for name in PROGRAM_READERS}
    assert got["call_start_ms.rollout"] == pytest.approx(5.0)
    assert got["replay_launch_us.rollout"] == pytest.approx(40.0)
    assert got["step_span_ms.rollout"] == pytest.approx(3.0)
    assert got["replay_gap_us.rollout"] == pytest.approx(25.0)
    assert got["render_span_ms.rollout"] == pytest.approx(1.0)
    assert got["compact_span_ms.rollout"] == pytest.approx(0.5)
    assert got["vector_step_span_ms.rollout"] == pytest.approx(1.000001)
    assert got["live_copy_share.rollout"] == pytest.approx(25.0)
    assert got["host_ms.gym"] is None and got["wait_ms.gym"] is None


def test_gym_readers():
    ctx = harness.Readers({}, {"program": gym_program()})
    assert reader("host_ms.gym").read(ctx) == pytest.approx(0.5)
    assert reader("wait_ms.gym").read(ctx) == pytest.approx(1.0)
    assert reader("step_span_ms.rollout").read(ctx) is None


@pytest.mark.parametrize("name", PROGRAM_READERS)
def test_readers_read_nothing_without_the_program(name):
    assert reader(name).read(harness.Readers({}, {"wall_s": 1.0})) is None


def test_rollout_breakdown_and_gaps_by_span():
    prog = rollout_program()
    # kernels: 2 ms busy in each replayed step, one gap inside the capture
    steps = [s for s in prog["device_spans"]
             if s[0] == "rollout.step" and s[4]]
    kernels = [("k", s[1], 2 * MS) for s in steps]
    t = make_trace(0.02, [("e", 0, MS)] + kernels,
                   host=[("cudaGraphLaunch", 5 * MS, 5 * MS + 10_000)])
    b = spans.rollout_breakdown(t, prog)
    assert b["replayed_steps"] == 3
    assert b["steps_ms"] == pytest.approx(9.0)
    assert b["steps_busy_ms"] == pytest.approx(6.0)
    assert b["replay_gaps_ms"] == pytest.approx(0.05)
    assert b["call_start_ms"] == pytest.approx(5.0)
    gaps = spans.idle_gaps_by_span(t, prog)
    # 1 ms -> 6 ms: from the eager step's end, in the host's warm-up,
    # through the capture, to the first replayed step
    first = gaps[0]
    assert first[:2] == ["rollout.warmup", "between steps"]
    assert first[3] == pytest.approx(5e-3)
    assert [g[1] for g in gaps[1:]] == ["inside a step"] * 2


def test_rollout_pass_on_the_cpu():
    run, driver = tiny_rollout("simple_layout.rollout-classes-4096")
    c = driver.Cell(run)
    t, prog = spans.rollout_pass(c, profiled=False)
    assert t is None and prog["steps"] == run.traffic["steps_per_call"]
    names = {s[0] for s in prog["device_spans"]}
    assert {"rollout.step", "render", "render.compact",
            "vector.step"} <= names
    # the CPU runs every step eagerly: nothing replayed
    assert spans.replayed_ms(prog, "rollout.step") is None
    assert 0 < spans.live_copy_share(prog) <= 100
    assert spans.call_start_ms(prog) == 0.0


def test_gym_pass_equals_the_window_on_the_cpu():
    run, driver = tiny_gym()
    c = driver.Cell(run)
    c.env.reset(seed=run.seed)
    c._steps(count=run.traffic["trace_steps"])
    window = c.records
    t, prog, records = spans.gym_pass(c, profiled=False)
    assert t is None and c.records is window
    assert records["resets"] == window["resets"]
    assert len(records["out"]) == len(window["out"])
    for a, b in zip(records["out"], window["out"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert records["frames"].keys() == window["frames"].keys()
    assert all(np.array_equal(records["frames"][k], window["frames"][k])
               for k in window["frames"])
    assert len([s for s in prog["spans"] if s[0] == "gym.step"]) \
        == run.traffic["trace_steps"]
    # no copy out on the CPU: the step is all host
    assert spans.gym_wait_ms(prog) == 0.0 and spans.gym_host_ms(prog) > 0


def test_on_host_clock_undoes_the_profilers_drift():
    """Device timestamps that drift from the host clock (1 us, growing
    by 1e-3 of the elapsed time) move back onto it, anchored at the mark
    kernels; a trace that lost a mark kernel stays as it is."""
    prog = rollout_program()
    marks = sorted(x for s in prog["device_spans"] for x in s[1:3])
    work = [m + 100_000 for m in marks[::3]]  # other kernels between

    def drift(ns):
        return ns + 1_000 + (ns - marks[0]) // 1000

    kernels = ([("mark_kernel", drift(m), 500) for m in marks]
               + [("k", drift(w), 2_000) for w in work])
    t = make_trace(0.02, kernels)
    moved = spans.on_host_clock(t, prog)
    got = sorted(moved.start_ns.tolist())
    assert got == sorted(marks + work)
    assert moved.dur_ns.tolist() == t.dur_ns.tolist()
    lost = make_trace(0.02, kernels[1:])
    assert spans.on_host_clock(lost, prog) is lost
