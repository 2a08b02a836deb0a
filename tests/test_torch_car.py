"""tinycarlo_torch.car against tinycarlo_tpu.car in float64: B = 8 cars,
200 steps on simple_layout (and knuffingen) with maneuver switches including u-turns.

Discrete state (local_path, local_path_len, last_maneuver, truncated) must
be equal; floats agree to 1e-9 absolute. The tolerance is there because
torch's and XLA's CPU sin/cos/tan/atan2 are different libms, whose last
bits differ; the car's arithmetic is otherwise the same operation for
operation.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import REPO, bench_config
from tinycarlo_torch import car as pcar
from tinycarlo_torch import env as penv
from tinycarlo_tpu import car as jcar
from tinycarlo_tpu import env as jenv

B, STEPS, ATOL = 8, 200, 1e-9
FLOATS = ("position", "position_front", "rotation", "steering_angle",
          "radius", "velocity")
DISCRETE = ("local_path", "local_path_len", "last_maneuver")


def _controls(seed):
    """Open-loop commands: smooth random steering and speed, and maneuvers
    held for 5-30 steps each, u-turns (2) included."""
    rng = np.random.default_rng(seed)
    vel = np.clip(
        0.6 + np.cumsum(rng.normal(0, 0.05, (STEPS, B)), 0), -0.3, 1.0
    )
    steer = np.clip(np.cumsum(rng.normal(0, 0.15, (STEPS, B)), 0), -1, 1)
    man = np.zeros((STEPS, B), np.int32)
    for b in range(B):
        t = 0
        while t < STEPS:
            d = int(rng.integers(5, 30))
            man[t: t + d, b] = rng.choice(4, p=[0.4, 0.2, 0.25, 0.15])
            t += d
    return vel, steer, man


_PARAMS = {}


def _params(name):
    """(JAX params, port params) in float64 for bench.py's config or an
    example yaml (knuffingen: one-way roads, so u-turns can dead-end)."""
    if name not in _PARAMS:
        cfg = bench_config() if name == "bench" else os.path.join(
            REPO, "examples", name
        )
        _PARAMS[name] = (
            jenv.make_env_params(cfg, dtype=jnp.float64),
            penv.make_env_params(cfg, dtype=torch.float64, device="cpu"),
        )
    return _PARAMS[name]


def _check_state(js, ps, step):
    for name in FLOATS:
        np.testing.assert_allclose(
            getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
            rtol=0, atol=ATOL, err_msg=f"{name} at step {step}",
        )
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=f"{name} at step {step}",
        )


def _check_info(ji, pi, step):
    for name, want in ji.items():
        got = pi[name].numpy()
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        else:
            np.testing.assert_allclose(
                got, np.asarray(want), rtol=0, atol=ATOL,
                err_msg=f"info {name} at step {step}",
            )


@pytest.mark.parametrize(
    "config,seed",
    [("bench", 0), ("config_knuffingen.yaml", 2)],
)
def test_car_rollout_matches_jax(config, seed):
    jp, pp = _params(config)
    md, cfg, T = jp.map_data, jp.cfg.car, jp.cfg.sim.T
    rows = np.random.default_rng(100 + seed).integers(
        0, md.spawns.count, B
    ).astype(np.int32)
    js = jax.vmap(partial(jcar.car_reset, md, cfg))(jnp.asarray(rows))
    ps = pcar.car_reset(pp.map_data, pp.cfg.car, torch.from_numpy(rows))
    _check_state(js, ps, -1)

    jstep = jax.jit(jax.vmap(
        lambda s, v, st, m: jcar.car_step(md, cfg, T, s, v, st, m)
    ))
    jinfo = jax.jit(jax.vmap(partial(jcar.car_info, md, cfg)))
    vel, steer, man = _controls(seed)
    n_uturn = 0
    for t in range(STEPS):
        js, jtr = jstep(js, jnp.asarray(vel[t]), jnp.asarray(steer[t]),
                        jnp.asarray(man[t]))
        ps, ptr = pcar.car_step(
            pp.map_data, pp.cfg.car, T, ps, torch.from_numpy(vel[t]),
            torch.from_numpy(steer[t]), torch.from_numpy(man[t]),
        )
        _check_state(js, ps, t)
        np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
        _check_info(jinfo(js), pcar.car_info(pp.map_data, pp.cfg.car, ps), t)
        prev = man[t - 1] if t else np.zeros(B, np.int32)
        n_uturn += int(((man[t] == 2) & (prev != 2)).sum())
    # the rollout really switched into u-turns (the re-snap path)
    assert n_uturn >= 3
