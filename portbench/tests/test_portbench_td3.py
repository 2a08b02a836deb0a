"""The `td3` driver at a tiny size on the CPU (the port's plain versions
stand in for its kernels): 8 envs, a 32x40 camera, a 128-slot replay that
the set-up's 16-step chunk wraps, batch 16, 4 updates a step. The run
passes its comparison with the cell's limits; the control, the reference
in bfloat16 in the program's place, fails it; and so does a timed path
broken underneath: one update of a step skipped, one eviction slot
moved."""
import pytest
import torch

from portbench import run as harness
from tinycarlo_torch.train import replay as rb
from tinycarlo_torch.train import td3

CELL = "simple_layout.td3-rgb-1024"
SEED = 2_147_483_659


def tiny_cell(seed=SEED):
    _, _, run, driver = harness.prepare(CELL, seed, 0.0, torch.device("cpu"))
    run.traffic = dict(run.traffic, envs=8, steps_per_chunk=16)
    run.config["config"]["camera"]["resolution"] = [32, 40]
    run.config["learner"] = dict(run.config["learner"], replay_size=128,
                                 batch_size=16)
    return driver.Cell(run)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_td3_passes_and_control_fails():
    c = tiny_cell()
    r = c.window(0.0)
    assert r["attempted"] == 8 * 16 and r["failed"] == 0
    c.release()
    checks = c.check()
    assert harness.judge(checks), checks
    control = c.check(stand_in="bfloat16")
    assert not harness.judge(control), control


def _skip_one_update(monkeypatch):
    calls = []
    step = td3.train_step

    def skipped(state, cfg, batch, do_actor=None):
        calls.append(1)
        if len(calls) == 2:  # the first followed step's second update
            zero = torch.zeros(())
            return state, {"critic1_loss": zero, "critic2_loss": zero,
                           "actor_loss": zero}
        return step(state, cfg, batch, do_actor)

    monkeypatch.setattr(td3, "train_step", skipped)


def _move_one_slot(monkeypatch):
    add = rb.add_batch

    def moved(buf, batch, generator=None, idx=None):
        idx = torch.randint(buf.size, (batch["m"].shape[0],),
                            generator=generator)
        idx[0] = (idx[0] + 1) % buf.size
        return add(buf, batch, generator, idx)

    monkeypatch.setattr(rb, "add_batch", moved)


@pytest.mark.parametrize("fault", [_skip_one_update, _move_one_slot])
def test_td3_faults_fail(fault, monkeypatch):
    c = tiny_cell(SEED + 2)
    fault(monkeypatch)
    c._follow()
    monkeypatch.undo()
    c.release()
    checks = c.check()
    print(fault.__name__, checks)
    assert not harness.judge(checks), (fault.__name__, checks)


def test_encoder_flops_at_128x160():
    """Five conv3x3 stride-2 blocks (24, 36, 48, 64, 64) over 3x128x160
    and the 1280 -> 256 layer: 43 048 960 operations a frame."""
    from portbench import td3_work

    ops = td3_work.encoder_flops(128, 160, (24, 36, 48, 64, 64), 256)
    assert ops == (64 * 80 * 24 * 3 + 32 * 40 * 36 * 24 + 16 * 20 * 48 * 36
                   + 8 * 10 * 64 * 48 + 4 * 5 * 64 * 64) * 9 * 2 \
        + 1280 * 256 * 2 == 43_048_960


def test_step_work_bounds_by_operations():
    """At the cell's widths the step's least time is the operations'
    (~1 ms at the float32 peak), well above its bytes' (~0.1 ms)."""
    from portbench import peaks, td3_work

    _, _, run, _ = harness.prepare(CELL, SEED, 0.0, torch.device("cpu"))
    w = td3_work.step_work(run.config, 1024)
    assert 0.8e-3 < w["flops_per_step"] / peaks.PEAK_F32_PER_S < 1.5e-3
    assert w["bytes_per_step"] / peaks.PEAK_BYTES_PER_S < 0.2e-3


def _reader(name):
    import os
    return harness.load_module(
        os.path.join(harness.PB, "layer_metrics", f"{name}.py"),
        "t_" + name.replace(".", "_"))


def test_span_readers():
    """The span readers on a made-up pass of two replayed steps, each a
    policy span and two 1 ms updates (a third update's span lost on the
    second), and an eager step they leave out."""
    ms = 1_000_000
    dev = [("td3.policy", 0, ms, -1, True), ("td3.env_step", ms, 3 * ms, -1,
                                              True),
           ("td3.encoder", 3 * ms, 8 * ms, -1, True),
           ("td3.update", 8 * ms, 9 * ms, -1, True),
           ("td3.update", 9 * ms, 10 * ms, -1, True),
           ("td3.policy", 20 * ms, 21 * ms, -1, True),
           ("td3.env_step", 21 * ms, 25 * ms, -1, True),
           ("td3.encoder", 25 * ms, 30 * ms, -1, True),
           ("td3.update", 30 * ms, 31 * ms, -1, True),
           ("td3.update", 31 * ms, 33 * ms, -1, True),
           ("td3.encoder", 40 * ms, 60 * ms, -1, False)]
    prog = {"spans": [], "device_spans": dev, "steps": 2,
            "counters": {"td3.updates": 4}}
    ctx = harness.Readers({}, {"program": prog})
    assert _reader("encoder_span_ms.train").read(ctx) == 5.0
    assert _reader("env_span_ms.train").read(ctx) == 3.0
    # per step 2 and 3 ms of updates, median 2.5, over 2 updates a step
    assert _reader("update_span_ms.train").read(ctx) == 1.25
    assert _reader("update_span_ms.train").read(
        harness.Readers({}, {})) is None
