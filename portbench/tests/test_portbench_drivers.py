"""Each driver at a tiny size on the CPU (the port's plain versions stand in
for its kernels): the run passes its comparison with the cell's limits;
the control, the reference in bfloat16 in the program's place, fails it;
and a run whose timed path is broken underneath fails it, once for each
fault the cell can have: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced."""
import dataclasses

import pytest
import torch

from portbench import run as harness
from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector

SEED = 2_147_483_659
ROLLOUTS = {
    # cell: (checksum rows, camera resolution) at the tiny size
    "simple_layout.rollout-classes-4096": ([60, 64], None),
    "knuffingen.rollout-classes-512": ([40, 44], [96, 128]),
}
GYM = "simple_layout.gym-rgb-1"


def tiny_rollout(cell):
    rows, res = ROLLOUTS[cell]
    _, _, run, driver = harness.prepare(cell, SEED, 0.0, torch.device("cpu"))
    run.traffic = dict(run.traffic, envs=8, steps_per_call=40,
                       tracked_envs=6, frames_checked=6, checksum_rows=rows)
    if res is not None:
        run.config["config"]["camera"]["resolution"] = res
    return run, driver


def finish(cell_obj):
    cell_obj.window(0.0)
    cell_obj.release()
    return cell_obj


def cell_name(c):
    return c.run.cell


def correct(checks):
    return harness.judge(checks)


@pytest.mark.parametrize("cell", sorted(ROLLOUTS))
def test_rollout_passes_and_control_fails(cell):
    run, driver = tiny_rollout(cell)
    c = finish(driver.Cell(run))
    assert correct(c.check()), c.check()
    control = c.check(stand_in="bfloat16")
    assert not correct(control), control


def _broken_step(kind):
    step = vector.step

    def broken(params, state, action, **kw):
        new, obs, reward, term, trunc, info = step(params, state, action,
                                                   **kw)
        if kind == "unchanged":
            new = dataclasses.replace(new, env=state.env)
        elif kind == "half":  # the second half of the batch left out
            b = state.episode_step.shape[0]
            keep = torch.arange(b) >= b // 2
            car = dataclasses.replace(new.env.car, **{
                f.name: torch.where(
                    keep.reshape((-1,) + (1,) * (getattr(
                        new.env.car, f.name).ndim - 1)),
                    getattr(state.env.car, f.name),
                    getattr(new.env.car, f.name))
                for f in dataclasses.fields(new.env.car)})
            new = dataclasses.replace(new, env=fenv.EnvState(car=car))
        elif kind == "reward":
            reward = reward + 0.1
        return new, obs, reward, term, trunc, info

    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "reward", "frame"])
@pytest.mark.parametrize("cell", sorted(ROLLOUTS))
def test_rollout_faults_fail(cell, kind, monkeypatch):
    run, driver = tiny_rollout(cell)
    c = driver.Cell(run)
    if kind == "half":  # a tracked car lies in the half that is left out
        assert (c.tracked >= run.traffic["envs"] // 2).any()
    if kind == "frame":
        render = fenv.render_observation_batch

        def altered(params, states, *a, **kw):
            obs = render(params, states, *a, **kw).clone()
            obs[..., 20, :] = 255 - obs[..., 20, :]
            return obs

        monkeypatch.setattr(fenv, "render_observation_batch", altered)
    else:
        monkeypatch.setattr(vector, "step", _broken_step(kind))
    finish(c)
    monkeypatch.undo()
    checks = c.check()
    print(cell_name(c), kind, checks)
    assert not correct(checks), (kind, checks)


def tiny_gym(seconds=2.0):
    _, _, run, driver = harness.prepare(GYM, SEED, seconds,
                                        torch.device("cpu"))
    run.traffic = dict(run.traffic, frame_stride=20, max_steps_per_s=200,
                       trace_steps=50)
    return run, driver


def gym_finish(c, seconds=2.0):
    c.window(seconds)
    c.release()
    return c


def test_gym_passes_and_control_fails():
    run, driver = tiny_gym()
    c = gym_finish(driver.Cell(run))
    assert len(c.records["out"]) >= 40
    assert correct(c.check()), c.check()
    assert not correct(c.check(stand_in="bfloat16"))


@pytest.mark.parametrize("kind", ["unchanged", "reward", "frame"])
def test_gym_faults_fail(kind, monkeypatch):
    run, driver = tiny_gym()
    c = driver.Cell(run)
    c.env.graphs = False  # the eager step, so the broken body is what runs
    step = fenv.step

    def broken(params, state, action, render=True, wrapped=False):
        new, obs, reward, term, trunc, info = step(params, state, action,
                                                   render, wrapped)
        if kind == "unchanged":
            new = state
            info = fenv._info(params, state)
        elif kind == "reward":
            reward = reward + 0.1
        elif kind == "frame" and obs is not None:
            obs = obs.clone()
            obs[..., 20, :, :] = 255 - obs[..., 20, :, :]
        return new, obs, reward, term, trunc, info

    monkeypatch.setattr(fenv, "step", broken)
    gym_finish(c)
    monkeypatch.undo()
    checks = c.check()
    print(cell_name(c), kind, checks)
    assert not correct(checks), (kind, checks)
