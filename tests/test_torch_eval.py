"""The port's serving path against the JAX package: the bundled combo on
rgb observations of examples/config_simple_layout.yaml, driven through
tinycarlo_torch.train.evaluate.

- `evaluate` runs end to end on the CPU (B = 2, 5 steps, and the
  sequential mode) and returns the JAX package's metrics dict.
- A teacher-forced closed loop: B = 4 envs, 20 steps, in float64. Both
  packages start from the same state (carried across with
  tinycarlo_torch.convert), and both step with the JAX package's steering
  (the flax combo on the JAX package's rgb frames), so their states stay
  together. At every step the port's combo is run on the JAX package's
  frames and on the port's own frames, and both steerings are compared
  with the JAX package's.

Tolerances: car states and rewards within 1e-9 absolute (different libms,
see test_torch_slice.py); the port's combo on the JAX package's frames
within 1e-5 absolute (the two combos agree to ~2e-7 on equal frames); rgb
frames may differ on stroke-boundary pixels only (the JAX package renders
through its float64 rasterizer on the CPU, the port through the rank
kernel's float32 plain version), on fewer than 0.5% of the pixels; the
port's steering on its own frames within 1e-2 absolute (one boundary pixel
that differs moves the combo's output by up to ~4e-3 on this loop).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import REPO, port_tree, to_numpy_tree
from tests.test_torch_slice import _boundary_pixel, _respawn_rows
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.models.tinycar_net import load_pretrained
from tinycarlo_torch.train import evaluate as peval
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.models.tinycar_net import TinycarCombo
from tinycarlo_tpu.train.evaluate import combo_policy as j_combo_policy
from tinycarlo_tpu.train.evaluate import standard_stack as j_standard_stack
from tinycarlo_tpu.train.il import load_variables_npz

CONFIG = f"{REPO}/examples/config_simple_layout.yaml"
BUNDLED = (f"{REPO}/tinycarlo_tpu/models/pretrained/"
           "tinycar_combo_flax_3_128_160.npz")
B, STEPS, SPEED = 4, 20, 0.35
MODEL_ATOL, STEER_ATOL, STATE_ATOL = 1e-5, 1e-2, 1e-9


@pytest.fixture(scope="module")
def combo():
    return load_pretrained((128, 160, 3), device="cpu")


@pytest.mark.parametrize("sequential", [False, True])
def test_evaluate_runs_on_cpu(combo, sequential):
    """The metrics dict of the JAX package's evaluate, finite, with one
    position per env-step; the bundled combo keeps the cars in lane."""
    params = penv.make_env_params(CONFIG, device="cpu")
    r = peval.evaluate(peval.combo_policy(combo), params, maneuver=2,
                       carry_init=None, seed=10, steps=5, episodes=2,
                       sequential=sequential)
    keys = {"cte_avg", "cte_var", "heading_error_avg", "heading_error_var",
            "terminations", "steps_per_s", "total_reward", "positions"}
    assert set(r) == keys
    assert r["positions"].shape == (10, 2)
    assert np.isfinite(r["positions"]).all()
    for k in keys - {"positions", "terminations"}:
        assert np.isfinite(r[k]), k
    assert isinstance(r["terminations"], int) and r["terminations"] == 0
    assert 0 <= r["cte_avg"] < 0.02 and r["total_reward"] > 0


def test_teacher_forced_loop_matches_jax(combo):
    jp = jenv.make_env_params(CONFIG, dtype=jnp.float64)
    pp = penv.make_env_params(CONFIG, dtype=torch.float64, device="cpu")
    stack = j_standard_stack()
    jvs, _ = jax.jit(partial(jvec.reset, jp, n_envs=B, stack=stack,
                             render=False))(jax.random.key(10))
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    jrender = jax.jit(partial(jenv.render_observation_batch, jp))
    jproject = jax.jit(partial(jenv._project_packed_batch, jp))
    jact = jax.jit(j_combo_policy(TinycarCombo(),
                                  load_variables_npz(BUNDLED)))
    jstep = jax.jit(partial(jvec.step, jp, stack=stack, render=False))
    pact = peval.combo_policy(combo)
    pstack = peval.standard_stack()
    m = np.array([0, 1, 2, 0], np.int32)
    act_m = np.where(m != 2, m, 3).astype(np.int32)
    key = jax.random.key(0)
    thickness = jp.cfg.camera.line_thickness
    worst, flips = 0.0, 0
    for t in range(STEPS):
        jobs = jrender(jvs.env)
        jsteer, _ = jact(jobs, jnp.asarray(m), None, key)
        jsteer = np.asarray(jsteer)
        same, _ = pact(torch.from_numpy(np.array(jobs)),
                       torch.from_numpy(m), None)
        np.testing.assert_allclose(same.numpy(), jsteer, rtol=0,
                                   atol=MODEL_ATOL, err_msg=f"step {t}")

        pobs = penv.render_observation_batch(pp, pvs.env)
        assert pobs.shape == (B, 128, 160, 3) and pobs.dtype == torch.uint8
        diff = np.argwhere((pobs.numpy() != np.asarray(jobs)).any(-1))
        assert len(diff) < pobs[..., 0].numel() * 0.005
        p0, p1, draw = (np.asarray(x) for x in jproject(jvs.env))
        for b, y, x in diff:
            a = np.trunc(np.clip(p0[b][draw[b]], -1e6, 1e6))
            c = np.trunc(np.clip(p1[b][draw[b]], -1e6, 1e6))
            assert _boundary_pixel(float(x), float(y), a, c, thickness), (
                f"step {t}: non-boundary pixel differs at env {b}, {(y, x)}")
        flips += len(diff)
        psteer, _ = pact(pobs, torch.from_numpy(m), None)
        err = np.abs(psteer.numpy() - jsteer).max()
        worst = max(worst, float(err))
        assert err < STEER_ATOL, f"step {t}: steering differs by {err}"

        control = np.stack([np.full(B, SPEED), jsteer.astype(np.float64)],
                           -1)
        rows = _respawn_rows(jvs.env.key, jp.map_data.spawns.count)
        jvs, _, jrew, jterm, _, _ = jstep(jvs, {
            "car_control": jnp.asarray(control),
            "maneuver": jnp.asarray(act_m)})
        pvs, _, prew, pterm, _, _ = pvec.step(pp, pvs, {
            "car_control": torch.from_numpy(control),
            "maneuver": torch.from_numpy(act_m)},
            stack=pstack, render=False, respawn_rows=torch.from_numpy(rows))
        np.testing.assert_array_equal(pterm.numpy(), np.asarray(jterm))
        np.testing.assert_allclose(prew.numpy(), np.asarray(jrew), rtol=0,
                                   atol=STATE_ATOL)
        car = port_tree(pvs)["env"]["car"]
        for name, want in to_numpy_tree(jvs.env.car).items():
            if want.dtype.kind == "f":
                np.testing.assert_allclose(car[name], want, rtol=0,
                                           atol=STATE_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(car[name], want, err_msg=name)
    print(f"worst steering difference {worst:.3g}, {flips} pixels differ")
