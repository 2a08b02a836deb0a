"""The port's `vector.rollout` and `train.evaluate` (temporal_policy, the
rollout-driven evaluate) against the JAX package's.

- rollout: bench.py's config at 32x40, t = 1, B = 6, 20 steps of Stanley
  control in float64 from the same state; no env finishes in 20 steps, so
  no respawn draw is needed. Discrete state equal, floats within 1e-9
  (torch's and XLA's libm differ in the last bits). Frames: the JAX
  package renders through its CPU rasterizer, the port through the masks
  kernel's plain version, whose float32 Bresenham parts from it on
  segments the near plane clips to ~1e6 px (ROADMAP F3): under 0.05% of
  the pixels may differ.
- temporal_policy: the same encoder and temporal actor (flax weights
  converted) over three rolled steps, float32: rtol 1e-5, atol 1e-6.
- evaluate: port-only properties of the rollout-driven harness.
"""
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_common import bench_config, to_numpy_tree
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.models import tinycar_net as pnet
from tinycarlo_torch.train.stanley import stanley_steering as p_stanley
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.models import tinycar_net as jnet
from tinycarlo_tpu.train.stanley import stanley_steering as j_stanley

# the evaluate modules (both train packages export a function of the name)
pev = importlib.import_module("tinycarlo_torch.train.evaluate")
jev = importlib.import_module("tinycarlo_tpu.train.evaluate")

B, STEPS, SPEED, K, ATOL = 6, 20, 0.3, 5.0, 1e-9


def test_rollout_matches_jax_stanley_float64():
    cfg = bench_config((32, 40), thickness=1)
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    jvs, _ = jvec.reset(jp, jax.random.key(5), B, render=False)
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    max_steer = jp.cfg.car.max_steering_angle
    m = jnp.asarray([0, 1, 3, 0, 1, 3], jnp.int32)

    def jpolicy(obs, env_state, key):
        info = jax.vmap(partial(jenv._info, jp))(env_state)
        steer = jnp.clip(j_stanley(info["cte"], info["heading_error"],
                                   SPEED, K, max_steer), -1.0, 1.0)
        return {"car_control": jnp.stack(
            [jnp.full((B,), SPEED), steer], -1), "maneuver": m}

    def ppolicy(obs, env_state, generator):
        info = penv._info(pp, env_state)
        steer = torch.clamp(p_stanley(info["cte"], info["heading_error"],
                                      SPEED, K, max_steer), -1.0, 1.0)
        return {"car_control": torch.stack(
            [torch.full((B,), SPEED, dtype=torch.float64), steer], -1),
            "maneuver": torch.from_numpy(np.array(m))}

    jfinal, jtraj = jax.jit(partial(
        jvec.rollout, jp, policy_fn=jpolicy, n_steps=STEPS,
        max_episode_steps=500))(jvs)
    stats = {}
    pfinal, ptraj = pvec.rollout(pp, pvs, ppolicy, STEPS,
                                 max_episode_steps=500,
                                 info_keys=("position",), stats=stats)
    assert stats == {}  # no graph on the CPU
    assert set(ptraj) == set(jtraj) | {"position"}
    assert not np.asarray(jtraj["terminated"]).any()
    assert not np.asarray(jtraj["truncated"]).any()
    for k, v in jtraj.items():
        want = np.asarray(v)
        got = ptraj[k].numpy()
        assert got.shape == want.shape, k
        if k == "obs":
            assert (got != want).mean() < 5e-4
        elif want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert ptraj["obs"].any()
    np.testing.assert_allclose(pfinal.env.car.position.numpy(),
                               np.asarray(jfinal.env.car.position),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pfinal.episode_step.numpy(),
                                  np.asarray(jfinal.episode_step))


def _temporal_pair(seq_len, n_layers, h, w):
    """The JAX package's (encoder, variables, actor, params) and the
    port's (encoder, actor) with the same weights."""
    rng = np.random.default_rng(1)
    jcombo = jnet.TinycarCombo()
    x = jnp.zeros((1, h, w, n_layers), jnp.float32)
    variables = jcombo.init(jax.random.key(2), x, jnp.zeros((1, 3)))
    # non-trivial running statistics
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jnp.asarray(rng.uniform(0, 1, v.shape),
                                           v.dtype)
        if "batch_stats" in jax.tree_util.keystr(p) else v, variables)
    enc_vars = {"params": variables["params"]["encoder"],
                "batch_stats": variables["batch_stats"]["encoder"]}
    jactor = jnet.TinycarActorTemporal(seq_len=seq_len)
    aparams = jactor.init(jax.random.key(3), jnp.zeros((1, seq_len, 256)),
                          jnp.zeros((1, 3)))["params"]
    sd = convert.combo_state_dict_from_flax(jax.device_get(variables))
    combo = pnet.TinycarCombo(in_channels=n_layers,
                              flat_features=sd["encoder.fc1.weight"].shape[1])
    combo.load_state_dict(sd)
    pactor = pnet.TinycarActorTemporal(seq_len=seq_len)
    convert.load_td3_net_from_flax(pactor, jax.device_get(aparams), True)
    return ((jnet.TinycarEncoder(), enc_vars, jactor, aparams),
            (combo.encoder.eval(), pactor))


def test_temporal_policy_matches_jax():
    seq_len, n_layers, h, w, b = 3, 5, 64, 160, 4
    jparts, (penc, pactor) = _temporal_pair(seq_len, n_layers, h, w)
    jact = jev.temporal_policy(*jparts, seq_len)
    pact = pev.temporal_policy(penc, pactor, seq_len)
    rng = np.random.default_rng(4)
    jq = jnp.zeros((b, seq_len, 256), jnp.float32)
    pq = torch.zeros(b, seq_len, 256)
    m = np.asarray([0, 1, 2, 1], np.int32)
    for _ in range(3):
        obs = (rng.random((b, n_layers, h, w)) < 0.1).astype(np.uint8) * 255
        js, jq = jact(jnp.asarray(obs), jnp.asarray(m), jq, None)
        ps, pq = pact(torch.from_numpy(obs), torch.from_numpy(m), pq)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=1e-5,
                                   atol=1e-6)
    assert pq[:, 2].abs().sum() > 0  # the queue rolled three features in


def test_evaluate_through_rollout_with_temporal_policy():
    """evaluate drives a temporal policy through vector.rollout: the carry
    rolls in place (the caller's carry_init untouched), metrics finite, a
    position per env-step, no graph on the CPU; the sequential protocol
    steps one env steps * episodes times."""
    seq_len = 3
    params = penv.make_env_params(bench_config((64, 160)), device="cpu")
    _, (penc, pactor) = _temporal_pair(seq_len, 5, 64, 160)
    act = pev.temporal_policy(penc, pactor, seq_len)
    carry = torch.zeros(2, seq_len, 256)
    stats = {}
    r = pev.evaluate(act, params, 1, carry, seed=3, steps=4, episodes=2,
                     stats=stats)
    assert not carry.any()
    assert r["positions"].shape == (8, 2)
    assert np.isfinite(r["cte_avg"]) and np.isfinite(r["total_reward"])
    assert stats == {}
    seq = pev.evaluate(act, params, 2, torch.zeros(1, seq_len, 256), seed=3,
                       steps=3, episodes=2, sequential=True)
    assert seq["positions"].shape == (6, 2)
    assert np.isfinite(seq["cte_avg"])
