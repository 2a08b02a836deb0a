"""The port's fused TD3 loop (tinycarlo_torch.train.td3_loop) on the CPU:
against the JAX package's chunk with the same draws, and the cases of
tests/test_td3_loop.py on the port alone; td3_bench at a tiny size.

Parity: bench.py's config at 48x160 with `camera.stroke: exact` (t = 2),
whose frames the two packages render equal bit for bit in float64, B = 4,
seq_len 3, batch 8, replay 64 (above B * T: no eviction), 6 steps, the
stand-in encoder of tests/test_td3_loop.py. The JAX chunk's draws (OU
normals, eviction and sample indices, new maneuvers) are recomputed in the
test from its key schedule (td3_loop.py:145) and injected into the port;
no env finishes in 6 steps, so no respawn is drawn. A second case runs
examples/train_td3.py's time-to-policy flags at this size (4 updates a
step, the per-episode sigma past its plan, a replay the chunk wraps), its
respawn rows drawn from the JAX envs' keys. The nets run in
float32 in both (the JAX chunk's skip branch is float32): positions,
rewards, cte and distances within 1e-6, features and stored rows within
rtol 1e-5, losses within rtol 1e-4 (XLA's and torch's float32 sums differ
in order, and Adam's first steps move a weight by about lr where a
gradient near zero changes sign); discrete values equal.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (bench_config, to_numpy_tree,
                                     torch_threads)
from tests.test_torch_slice import _respawn_rows
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.benchmarks import td3_bench
from tinycarlo_torch.train import replay as prb
from tinycarlo_torch.train import td3 as ptd3
from tinycarlo_torch.train import td3_loop as ploop
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu.train import td3 as jtd3
from tinycarlo_tpu.train import td3_loop as jloop

B = 4


def p_encoder(obs):
    """tests/test_td3_loop.py's stand-in encoder: the frame mean-pooled
    into 256 features."""
    x = obs.float() / 255.0 if obs.dtype == torch.uint8 else obs.float()
    f = x.reshape(x.shape[0], -1)
    f = torch.nn.functional.pad(f, (0, 256 - f.shape[1] % 256))
    return f.reshape(x.shape[0], -1, 256).mean(dim=1)


def j_encoder(obs):
    x = obs.astype(jnp.float32) / 255.0 if obs.dtype == jnp.uint8 else obs
    f = x.reshape(x.shape[0], -1)
    f = jnp.pad(f, ((0, 0), (0, 256 - f.shape[1] % 256)))
    return f.reshape(x.shape[0], -1, 256).mean(axis=1)


@pytest.fixture(scope="module")
def params():
    return penv.make_env_params(bench_config((32, 40)), device="cpu")


def _run(params, cfg, loop_cfg, n_steps, seed=0, state=None):
    state = state or ploop.init_loop(params, cfg, loop_cfg, B, seed=seed)
    return ploop.chunk(state, params, cfg, loop_cfg, p_encoder, n_steps)


def _port_state(jstate, pp, cfg):
    """The port's LoopState from the JAX package's."""
    buf = jstate.buf
    return ploop.LoopState(
        vstate=convert.vec_state_from_numpy(to_numpy_tree(jstate.vstate),
                                            device="cpu"),
        queue=torch.from_numpy(np.array(jstate.queue)),
        noise=torch.from_numpy(np.array(jstate.noise)),
        maneuver=torch.from_numpy(np.array(jstate.maneuver)),
        buf=prb.ReplayBuffer(
            storage={k: torch.from_numpy(np.array(v))
                     for k, v in buf.storage.items()},
            filled=torch.tensor(int(buf.filled), dtype=torch.int32),
            size=buf.size),
        td3_state=convert.td3_state_from_flax(
            jax.device_get(jstate.td3_state), cfg, device="cpu"),
        generator=torch.Generator(),
        sigma=torch.from_numpy(np.array(jstate.sigma)),
        sigma_target=torch.tensor(float(jstate.sigma_target)),
        ep_count=torch.from_numpy(np.array(jstate.ep_count)),
        filled_host=int(buf.filled), steps_host=int(jstate.td3_state.steps),
    )


def _jax_draws(key, n_steps, size, batch, filled0, updates,
               env_keys=None, spawns=0, done=None):
    """The draws of the JAX chunk (td3_loop.py:145-277) from its key. With
    the envs' keys, also the spawn rows vector.step's auto-reset draws
    from them (vector.py:131-139), given the chunk's (T, B) `done`: each
    step splits every env's key; a running env keeps the first half, a
    respawned one the key its reset leaves (env.py:356-360)."""
    out = {k: [] for k in ("ou", "evict", "sample", "maneuver", "respawn")}
    filled = filled0
    for t in range(n_steps):
        if env_keys is None:
            out["respawn"].append(jnp.zeros((B,), jnp.int32))
        else:
            out["respawn"].append(_respawn_rows(env_keys, spawns))
            halves = jax.vmap(jax.random.split)(env_keys)
            reset = jax.vmap(jax.random.split)(halves[:, 1])[:, 0]
            env_keys = jax.random.wrap_key_data(jnp.where(
                jnp.asarray(done[t])[:, None],
                jax.random.key_data(reset),
                jax.random.key_data(halves[:, 0])))
        key, k_ou, k_evict, k_sample, k_m = jax.random.split(key, 5)
        filled = min(filled + B, size)
        out["ou"].append(jax.random.normal(k_ou, (B, 1), jnp.float32))
        out["evict"].append(jax.random.randint(k_evict, (B,), 0, size))
        out["sample"].append([
            jax.random.randint(k, (batch,), 0, jnp.int32(filled))
            for k in jax.random.split(k_sample, updates)])
        out["maneuver"].append(jax.random.randint(k_m, (B,), 0, 3,
                                                  jnp.int32))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _chunk_pair(n, **loop_kw):
    """The JAX chunk and the port's, n steps from the same state with the
    JAX chunk's draws injected: (jfinal, jout, pfinal, pout)."""
    cfg_dict = bench_config((48, 160))
    cfg_dict["camera"] = dict(cfg_dict["camera"], stroke="exact")
    jp = jenv.make_env_params(cfg_dict, dtype=jnp.float64)
    pp = penv.make_env_params(cfg_dict, dtype=torch.float64, device="cpu")
    jcfg = jtd3.TD3Config(seq_len=3, batch_size=8)
    pcfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    jlc = jloop.LoopConfig(**loop_kw)
    plc = ploop.LoopConfig(**loop_kw)
    jstate = jloop.init_loop(jp, jcfg, jlc, jax.random.key(2), B)
    pstate = _port_state(jstate, pp, pcfg)
    jfinal, jout = jax.jit(partial(
        jloop.chunk, params=jp, cfg=jcfg, loop_cfg=jlc,
        encoder_apply=j_encoder, n_steps=n))(jstate)
    draws = _jax_draws(jstate.key, n, jlc.replay_size, 8, 0,
                       jlc.updates_per_step, jstate.vstate.env.key,
                       jp.map_data.spawns.count, np.asarray(jout["done"]))
    with torch_threads(1):
        pfinal, pout = ploop.chunk(pstate, pp, pcfg, plc, p_encoder, n,
                                   draws=draws)
    return jfinal, jout, pfinal, pout


def _assert_chunks_match(jfinal, jout, pfinal, pout):
    # the port adds every update's losses; the last update's are the keys
    # both packages give
    assert set(pout) == set(jout) | {"update_losses"}
    for j, k in enumerate(ploop.LOSSES):
        assert torch.equal(pout["update_losses"][:, -1, j], pout[k]), k
    for k in ("reward", "cte", "laneline_distances"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    for k in ("done", "sigma"):
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    for k in ("critic1_loss", "critic2_loss", "actor_loss"):
        want = np.asarray(jout[k])
        np.testing.assert_allclose(pout[k].numpy(), want, rtol=1e-4,
                                   atol=0, err_msg=k)
        assert ((pout[k].numpy() == 0) == (want == 0)).all(), k
    assert (np.asarray(jout["critic1_loss"])[1:] != 0).all()
    np.testing.assert_allclose(pfinal.vstate.env.car.position.numpy(),
                               np.asarray(jfinal.vstate.env.car.position),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pfinal.maneuver.numpy(),
                                  np.asarray(jfinal.maneuver))
    np.testing.assert_allclose(pfinal.queue.numpy(),
                               np.asarray(jfinal.queue), rtol=1e-5,
                               atol=1e-7)
    for k, v in jfinal.buf.storage.items():
        np.testing.assert_allclose(pfinal.buf.storage[k].numpy(),
                                   np.asarray(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(pfinal.sigma.numpy(),
                                  np.asarray(jfinal.sigma))
    np.testing.assert_array_equal(pfinal.ep_count.numpy(),
                                  np.asarray(jfinal.ep_count))
    assert int(pfinal.buf.filled) == int(jfinal.buf.filled)
    assert int(pfinal.td3_state.steps) == int(jfinal.td3_state.steps)


def test_chunk_matches_jax_with_injected_draws():
    jfinal, jout, pfinal, pout = _chunk_pair(6, replay_size=64,
                                             max_episode_steps=50)
    assert not np.asarray(jout["done"]).any()
    _assert_chunks_match(jfinal, jout, pfinal, pout)
    assert int(pfinal.buf.filled) == B * 6
    assert int(pfinal.td3_state.steps) == 5


def test_chunk_matches_jax_with_the_time_to_policy_flags():
    """examples/train_td3.py's `--updates 4 --episodes N` at a small size:
    four updates a step (actor updates among them, policy_delay 2), the
    per-episode sigma 0.4 * (1 - e / 2) run past its plan (2-step
    episodes: 4 a chunk, so sigma clamps at 0), and a 16-slot replay that
    the chunk's 32 inserts wrap mid-chunk (eviction draws, duplicate
    slots). Respawns happen, drawn from the JAX envs' keys."""
    n = 8
    jfinal, jout, pfinal, pout = _chunk_pair(
        n, replay_size=16, max_episode_steps=2, updates_per_step=4,
        total_episodes=2)
    _assert_chunks_match(jfinal, jout, pfinal, pout)
    done = pout["done"].numpy()
    assert done.sum(axis=0).tolist() == [n // 2] * B  # past the plan of 2
    assert (pout["sigma"].numpy()[-1] == 0).all()  # clamped at 0
    assert int(pfinal.buf.filled) == 16 < B * n  # wrapped inside the chunk
    assert int(pfinal.td3_state.steps) == 4 * (n - 1)  # from step 2 on
    actor = pout["actor_loss"].numpy()
    assert (actor[1:] != 0).all() and actor[0] == 0


def test_fused_chunk(params):
    """tests/test_td3_loop.py::test_fused_chunk on the port: fill counts,
    updates once a batch is in, the actor moves, the queue is rolled."""
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=50)
    state, out = _run(params, cfg, loop_cfg, 6)
    assert out["reward"].shape == (6, B)
    assert int(state.buf.filled) == 24 == state.filled_host
    assert bool((out["critic1_loss"][1:] != 0).all())
    assert float(out["critic1_loss"][0]) == 0.0  # 4 < 8: no update yet
    actor0 = [p.detach().clone()
              for p in state.td3_state.actor.parameters()]
    state, out = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 6)
    assert int(state.buf.filled) == 48
    assert bool(torch.isfinite(out["critic1_loss"]).all())
    assert any(not torch.equal(a, b) for a, b in zip(
        actor0, state.td3_state.actor.parameters()))
    assert bool((state.queue[:, 0] != 0).any())
    assert state.steps_host == int(state.td3_state.steps) == 11
    # actor updates on every second update (policy_delay 2), 0 elsewhere
    assert bool((out["actor_loss"][::2] != 0).all())
    assert bool((out["actor_loss"][1::2] == 0).all())


def test_update_losses_hold_every_update(params):
    """`update_losses` (T, U, 3): the last update's column equals the old
    loss keys bit for bit; a critic-only update's actor entry is 0, an
    actor update's is not (policy_delay 2: actor at updates 2 and 4); a
    step before the buffer holds a batch is all 0."""
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=50,
                                updates_per_step=4)
    with torch_threads(1):
        state, out = _run(params, cfg, loop_cfg, 5)
    ul = out["update_losses"]
    assert ul.shape == (5, 4, 3) and ul.dtype == torch.float32
    for j, k in enumerate(ploop.LOSSES):
        assert torch.equal(ul[:, -1, j], out[k]), k
    assert not ul[0].any()  # 4 < 8 envs inserted: no update yet
    assert bool((ul[1:, :, :2] != 0).all())
    assert not ul[1:, 0::2, 2].any()  # critic-only updates 1 and 3
    assert bool((ul[1:, 1::2, 2] != 0).all())
    assert state.steps_host == int(state.td3_state.steps) == 16


def test_shorter_chunk_replays_the_runtime(params, tmp_path):
    """A 1-step chunk after a 100-step one keeps the chunk's runtime (on
    the card: its captured graphs and buffers) and returns the row that a
    100-step chunk from the same state (a checkpoint restored) gives
    first."""
    from tinycarlo_torch.utils import checkpoint

    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=20,
                                total_episodes=3)
    state = ploop.init_loop(params, cfg, loop_cfg, B, seed=5)
    path = str(tmp_path / "loop.pt")
    with torch_threads(1):
        state, _ = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 100)
        checkpoint.save(path, state)
        rt = state.runtime
        state, one = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 1)
        assert state.runtime is rt and rt.steps == 100
        checkpoint.restore(path, state)
        state, whole = ploop.chunk(state, params, cfg, loop_cfg, p_encoder,
                                   100)
    assert set(one) == set(whole)
    for k in one:
        assert one[k].shape == (1,) + whole[k].shape[1:], k
        assert torch.equal(one[k][0], whole[k][0]), k
    assert bool(whole["done"].any())  # episodes end and respawn in it


def test_longer_chunk_captures_anew(params):
    """A chunk longer than the runtime's buffers makes a new runtime (on
    the card: captures its graphs again) of its length."""
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=50)
    with torch_threads(1):
        state, _ = _run(params, cfg, loop_cfg, 2)
        rt = state.runtime
        state, out = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 3)
        assert state.runtime is not rt and state.runtime.steps == 3
        assert out["reward"].shape == (3, B)
        state, out = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 2)
    assert state.runtime.steps == 3 and out["reward"].shape == (2, B)


def test_sigma_per_episode_host_target(params):
    """OU sigma is constant within an episode and adopts sigma_target only
    at episode boundaries (train_td3.py:179)."""
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=2)
    state = ploop.init_loop(params, cfg, loop_cfg, B)
    assert bool((state.sigma == np.float32(0.4)).all())
    ploop.set_sigma_target(state, 0.1)
    state, out = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 1)
    done = out["done"][0]
    assert bool((state.sigma[done] == np.float32(0.1)).all())
    assert bool((state.sigma[~done] == np.float32(0.4)).all())
    state, out = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 1)
    assert bool((state.sigma == np.float32(0.1)).all())


def test_sigma_decays_per_episode(params):
    """LoopConfig.total_episodes: each env's sigma is 0.4 * (1 - e / 5)
    in its e-th episode, changing only at its own boundaries."""
    cfg = ptd3.TD3Config(seq_len=2, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=4,
                                updates_per_step=0, total_episodes=5)
    state, out = _run(params, cfg, loop_cfg, 30, seed=1)
    done, sigma = out["done"].numpy(), out["sigma"].numpy()
    for b in range(B):
        ep = 0
        for t in range(done.shape[0]):
            ep += int(done[t, b])
            assert sigma[t, b] == pytest.approx(
                0.4 * max(0.0, 1.0 - ep / 5), abs=1e-7)
        assert ep >= 5
    np.testing.assert_array_equal(state.ep_count.numpy(), done.sum(axis=0))


def test_updates_per_step_zero_collect_only(params):
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=50,
                                updates_per_step=0)
    state, out = _run(params, cfg, loop_cfg, 3)
    assert int(state.buf.filled) == 3 * B
    assert not out["critic1_loss"].any() and int(state.td3_state.steps) == 0


@pytest.mark.parametrize("pair", [(None, torch.float32),
                                  (torch.float32, torch.bfloat16)])
def test_float_obs_paths_match(params, pair):
    """obs_dtype float32 feeds the encoder the uint8 path's values, and
    bfloat16 float32's (0/1 is exact in both), so the whole chunk --
    outputs and queue -- is equal."""
    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    runs = []
    for obs_dtype in pair:
        loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=50,
                                    obs_dtype=obs_dtype)
        runs.append(_run(params, cfg, loop_cfg, 4))
    (s0, o0), (s1, o1) = runs
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    assert torch.equal(s0.queue, s1.queue)


def test_step_kinds_follow_the_counts(params):
    """The host's step kinds: collect only until the buffer holds a batch,
    then one update a step, an actor update every policy_delay-th."""
    cfg = ptd3.TD3Config(seq_len=3, batch_size=10, policy_delay=3)
    loop_cfg = ploop.LoopConfig(replay_size=64, updates_per_step=2)
    state = ploop.init_loop(params, cfg, loop_cfg, B)
    kinds, filled, steps = ploop.step_kinds(state, cfg, loop_cfg, 4)
    assert kinds == [None, None, (False, False), (True, False)]
    assert (filled, steps) == (16, 4)


def test_td3_bench_runs_on_the_cpu():
    """td3_bench.run at a tiny size on the CPU: the JSON keys of
    baseline_configs.py's config 4 and `device`, no device metric."""
    r = td3_bench.run(device="cpu", n_envs=4, chunk_steps=4, warm=1,
                      repeats=1, pipe_chunks=1, pipe_rounds=1,
                      replay_size=64, resolution=(32, 40),
                      cfg=ptd3.TD3Config(seq_len=3, batch_size=8))
    for key in ("config", "metric", "value", "spread", "pipelined_value",
                "pipelined_spread", "n_envs", "td3_updates_per_s",
                "buffer_filled", "device"):
        assert key in r, key
    assert r["device"] == "cpu" and r["buffer_filled"] == 48
    assert r["busy_ms_per_step"] is None and r["peak_memory_gb"] is None
    assert r["losses_finite"] and r["actor_moved"]
    assert r["eager_steps"] == r["renders"] == 12


def test_chunk_keeps_the_car_fields_apart(params):
    """A fresh loop's car state holds a tensor per field: the chunk writes
    each field back in place, and a reset whose steering angle, radius and
    velocity shared one zeros tensor left all three holding the velocity
    after every step."""
    from tinycarlo_torch.utils import graphs

    cfg = ptd3.TD3Config(seq_len=3, batch_size=8)
    loop_cfg = ploop.LoopConfig(replay_size=64, max_episode_steps=50,
                                updates_per_step=0, steering_shift=0.5)
    state = ploop.init_loop(params, cfg, loop_cfg, B)
    ts = graphs.tensors(state.vstate)
    assert len({t.data_ptr() for t in ts}) == len(ts)
    state, _ = ploop.chunk(state, params, cfg, loop_cfg, p_encoder, 2)
    car = state.vstate.env.car
    assert bool((car.steering_angle != 0).any())
    assert not torch.equal(car.steering_angle, car.velocity)
