"""The yardstick's arithmetic on made-up traces: busy time as a union of
intervals, kernels by name, the least times from shapes (K1's bytes, the
rollout step's bytes), the readers, and the p95 over every sample."""
import os

import numpy as np
import pytest

from portbench import peaks
from portbench import run as harness
from portbench.drivers import gym_step
from portbench.trace import Trace


def reader(name):
    return harness.load_module(
        os.path.join(harness.PB, "layer_metrics", f"{name}.py"),
        "reader_" + name.replace(".", "_"))


def make_trace(wall_s, kernels, count=1, host=()):
    names = [k[0] for k in kernels]
    return Trace(wall_s=wall_s, names=names,
                 start_ns=np.asarray([k[1] for k in kernels], np.int64),
                 dur_ns=np.asarray([k[2] for k in kernels], np.int64),
                 host=list(host), count=count)


def test_busy_is_the_union_of_kernels():
    t = make_trace(1e-5, [("a", 0, 4000), ("b", 2000, 4000),
                          ("c", 8000, 1000)])
    assert t.busy_s() == pytest.approx(7e-6)
    assert t.kernel_s("a") == (pytest.approx(4e-6), 1)
    gaps = make_trace(1e-5, [("a", 0, 1000), ("b", 5000, 1000)],
                      host=[("outer", 0, 9000), ("inner", 900, 2000)])
    assert gaps.idle_gaps() == [["inner", pytest.approx(4e-6)]]


def test_idle_share_and_busy_ms():
    # the traced window took 2e-5 s (the profiler's cost); the same work
    # untimed 1e-5 s
    ctx = harness.Readers({"window": make_trace(
        2e-5, [("a", 0, 2000), ("b", 3000, 2000)], count=2)},
        {"wall_s": 1e-5})
    assert reader("idle_share.rollout").read(ctx) == pytest.approx(60.0)
    assert reader("idle_share.gym").read(ctx) == pytest.approx(60.0)
    assert reader("device_busy_ms.gym").read(ctx) == pytest.approx(2e-3)
    assert reader("idle_share.rollout").read(harness.Readers({}, {})) is None


def test_masks_roofline_counts_the_masks_once():
    # 4096 envs x 5 layers x 128 x 160 uint8 masks: 419.4 MB a launch
    n_bytes = 4096 * 5 * 128 * 160
    least = n_bytes / 3.35e12
    launch_ns = int(round(2 * least * 1e9))  # each launch twice the least
    ctx = harness.Readers(
        {"window": make_trace(1.0, [
            ("void (anonymous namespace)::masks_kernel<unsigned char>", 0,
             launch_ns),
            ("void at::native::other", launch_ns, 10_000),
            ("void (anonymous namespace)::masks_kernel<unsigned char>",
             2 * launch_ns, launch_ns)])},
        {"masks_bytes": n_bytes})
    assert reader("masks_kernel_roofline.rollout").read(ctx) == \
        pytest.approx(50.0, rel=1e-6)
    assert peaks.least_s(n_bytes) == pytest.approx(1.2519e-4, rel=1e-3)
    none = harness.Readers({"window": make_trace(1.0, [("x", 0, 5)])},
                           {"masks_bytes": n_bytes})
    assert reader("masks_kernel_roofline.rollout").read(none) is None


def test_step_mfu_from_shapes():
    from portbench.drivers import rollout
    b, frame = 512, 5 * 480 * 640
    facts = {"steps": 1000, "obs_bytes": b * frame,
             "car_state_bytes": b * rollout.CAR_STATE_BYTES}
    assert rollout.CAR_STATE_BYTES == 72
    facts["wall_s"] = 2.5  # 2.5 ms a step, timed without the profiler
    ctx = harness.Readers({"window": make_trace(9.9, [("k", 0, 1)])}, facts)
    least = (b * frame + 2 * b * 72) / 3.35e12
    assert reader("step_mfu.rollout").read(ctx) == pytest.approx(
        100 * least / 2.5e-3)


def test_p95_is_over_every_sample():
    walls = [1.0] * 90 + [10.0] * 10
    # the p95 of all 100 samples; a median of chunk p95s would read 1.0
    assert gym_step.p95(walls) == pytest.approx(10.0)
    assert gym_step.p95(list(range(1, 101))) == pytest.approx(95.05)
