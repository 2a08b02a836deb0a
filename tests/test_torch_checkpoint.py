"""The port's checkpoints (tinycarlo_torch.utils.checkpoint, torch.save)
and profiling helpers, on the CPU: the round trips of
tests/test_checkpoint.py (a learner, a mid-episode env state) and of the
whole training loop, each restored state equal bit for bit and the next
steps from it equal to the original's. The JAX package's Orbax files are
another format (utils/checkpoint.py's docstring); no test crosses them."""
import os

import numpy as np
import pytest
import torch

from tests.test_torch_common import bench_config
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.train import td3 as ptd3
from tinycarlo_torch.train import td3_loop as ploop
from tinycarlo_torch.utils import checkpoint as ckpt
from tinycarlo_torch.utils import graphs, profiling


def _equal(a, b):
    ta, tb = graphs.tensors(a), graphs.tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def test_td3_state_roundtrip(tmp_path):
    cfg = ptd3.TD3Config(seq_len=3)
    state = ptd3.create(cfg, seed=0, device="cpu")
    with torch.no_grad():
        state.opt_actor.count.fill_(7)
        state.opt_actor.mu["head.fc1.weight"].normal_()
    path = str(tmp_path / "td3.pt")
    ckpt.save(path, state)
    other = ptd3.create(cfg, seed=1, device="cpu")
    assert not _equal(state, other)
    restored = ckpt.restore(path, example=other)
    assert restored is other and _equal(state, other)
    tree = ckpt.restore(path)
    assert torch.equal(tree["actor"]["head.fc1.weight"],
                       state.actor.head.fc1.weight)
    assert int(tree["opt_actor"]["count"]) == 7


def test_env_state_resume_mid_episode(tmp_path):
    """A batched env state and its respawn generator checkpoint mid-episode
    and resume to identical trajectories, respawns included."""
    params = penv.make_env_params(bench_config((32, 40)),
                                  dtype=torch.float64, device="cpu")
    vstate, _ = pvec.reset(params, 4, seed=0, render=False)
    action = {"car_control": torch.tensor([[0.5, 0.1]] * 4,
                                          dtype=torch.float64),
              "maneuver": torch.zeros(4, dtype=torch.int32)}
    for _ in range(5):
        vstate = pvec.step(params, vstate, action, render=False,
                           max_episode_steps=7)[0]
    path = str(tmp_path / "env.pt")
    ckpt.save(path, vstate)
    restored = ckpt.restore(path, example=pvec.reset(params, 4, seed=9,
                                                     render=False)[0])
    a, b = vstate, restored
    for _ in range(4):  # through the truncation at step 7: respawns drawn
        a = pvec.step(params, a, action, render=False,
                      max_episode_steps=7)[0]
        b = pvec.step(params, b, action, render=False,
                      max_episode_steps=7)[0]
    assert torch.equal(a.env.car.position, b.env.car.position)
    assert torch.equal(a.episode_step, b.episode_step)


def _encoder(obs):
    x = obs.float() / 255.0
    return x.reshape(x.shape[0], -1)[:, :256]


def test_loop_state_resume(tmp_path):
    """The whole loop -- envs, queue, noise, maneuvers, replay, learner,
    generators and the host's counts -- restored into a fresh loop of
    another seed gives the original's next chunk bit for bit."""
    params = penv.make_env_params(bench_config((32, 40)), device="cpu")
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=32, max_episode_steps=5)
    state = ploop.init_loop(params, cfg, loop_cfg, 4, seed=0)
    state, _ = ploop.chunk(state, params, cfg, loop_cfg, _encoder, 6)
    path = str(tmp_path / "loop.pt")
    ckpt.save(path, state)
    fresh = ploop.init_loop(params, cfg, loop_cfg, 4, seed=3)
    ckpt.restore(path, example=fresh)
    assert (fresh.filled_host, fresh.steps_host) == (24, 5)
    assert _equal(state, fresh)
    a_state, a = ploop.chunk(state, params, cfg, loop_cfg, _encoder, 6)
    b_state, b = ploop.chunk(fresh, params, cfg, loop_cfg, _encoder, 6)
    assert int(a_state.buf.filled) == 32  # evicting: generator draws
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert _equal(a_state, b_state)


def test_restore_checks_shapes(tmp_path):
    path = str(tmp_path / "t.pt")
    ckpt.save(path, {"x": torch.zeros(3), "n": 4})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, example={"x": torch.zeros(2), "n": 0})
    out = ckpt.restore(path, example={"x": torch.ones(3), "n": 0})
    assert out["n"] == 4 and not out["x"].any()


def test_profiling_trace_and_rate(tmp_path):
    """trace writes a Chrome trace of its block; the meter leaves out its
    first tick."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())
    meter = profiling.StepsPerSecond()
    assert meter.rate == 0.0
    meter.tick(10, torch.zeros(1))
    meter.tick(10)
    assert np.isfinite(meter.rate) and meter.rate > 0
