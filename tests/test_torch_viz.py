"""The port's overview renderer (tinycarlo_torch.viz) and the shim's human
render mode against the JAX package's (tinycarlo_tpu.viz), on
tests/test_env.py's config in float64 on the CPU.

Tolerance: frames equal bit for bit. Both draw with cv2 on the host from
the same map arrays and pose; the JAX side is given the port's pose (its
viz reads only the car's position, rotation, radius and local path).
"""
import copy
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_env import CONFIG
from tinycarlo_torch import car as pcar
from tinycarlo_torch import env as penv
from tinycarlo_torch import viz as pviz
from tinycarlo_torch.gym_env import TinyCarloEnv as PortEnv
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import viz as jviz

PPM = 150


@pytest.fixture(scope="module")
def params():
    return (penv.make_env_params(CONFIG, dtype=torch.float64, device="cpu"),
            jenv.make_env_params(CONFIG, dtype=jnp.float64))


def _jax_pose(state):
    """A one-env port state as the JAX viz reads a state."""
    car = state.car
    return SimpleNamespace(car=SimpleNamespace(**{
        k: getattr(car, k)[0].numpy() for k in
        ("position", "rotation", "radius", "local_path", "local_path_len")}))


def _states(pp, n=3, steps=12):
    """n one-env states, each `steps` steps of seeded actions from a spawn
    row, so that the local paths are long."""
    rng = np.random.default_rng(4)
    out = []
    for row in rng.integers(pp.map_data.spawns.count, size=n):
        state = penv.EnvState(car=pcar.car_reset(
            pp.map_data, pp.cfg.car, torch.tensor([int(row)])))
        for _ in range(steps):
            action = {"car_control": torch.tensor(
                [[0.6, rng.uniform(-0.5, 0.5)]], dtype=torch.float64),
                "maneuver": torch.tensor([int(rng.integers(4))])}
            state = penv.step(pp, state, action, render=False)[0]
        out.append(state)
    return out


@pytest.mark.parametrize("names,background", [
    (False, None), (True, None), (False, (255, 255, 255)),
    (True, (30, 60, 90))])
def test_static_overview_matches_jax(params, names, background):
    pp, jp = params
    got = pviz.render_static_overview(pp, PPM, background, 2, names)
    want = jviz.render_static_overview(jp, PPM, background, 2, names)
    assert got.dtype == want.dtype == np.uint8 and got.sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("names,background", [(False, None),
                                              (True, (255, 255, 255))])
def test_overview_matches_jax(params, names, background):
    """Three poses with their local paths, the static cache reused."""
    pp, jp = params
    cache = None
    for i, state in enumerate(_states(pp)):
        assert int(state.car.local_path_len[0]) > 1
        got, cache = pviz.render_overview(pp, state, PPM, background, 1,
                                          names, static_cache=cache)
        want, _ = jviz.render_overview(jp, _jax_pose(state), PPM,
                                       background, 1, names)
        np.testing.assert_array_equal(got, want, err_msg=f"pose {i}")
    assert cache is not None


def test_overview_takes_one_env(params):
    pp, _ = params
    state = penv.EnvState(car=pcar.car_reset(
        pp.map_data, pp.cfg.car, torch.tensor([0, 1])))
    with pytest.raises(ValueError, match="B = 2"):
        pviz.render_overview(pp, state, PPM)


def test_human_mode_matches_jax(params, monkeypatch):
    """render_mode="human" with cv2's window calls stubbed: after the
    reset and each step the "Map" window shows JAX's render_overview of
    the shim's state, the "Camera" window the rgb frame render() gives in
    rgb_array mode; waitKey waits at least 1 ms; close destroys both
    windows."""
    import cv2

    shown, created, destroyed, waits = [], [], [], []
    monkeypatch.setattr(cv2, "namedWindow",
                        lambda name, flags: created.append(name))
    monkeypatch.setattr(cv2, "imshow",
                        lambda name, image: shown.append((name, image)))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: waits.append(ms) or -1)
    monkeypatch.setattr(cv2, "destroyWindow", destroyed.append)
    _, jp = params
    cfg = copy.deepcopy(CONFIG)
    cfg["camera"]["resolution"] = [32, 40]
    env = PortEnv(render_mode="human", config=cfg, dtype=torch.float64,
                  device="cpu")
    twin = PortEnv(render_mode="rgb_array", config=cfg, dtype=torch.float64,
                   device="cpu")
    ppm = env.overview_pixel_per_meter
    env.reset(seed=3)
    twin.reset(seed=3)
    for i in range(4):
        if i:
            action = {"car_control": [0.6, 0.1 * i], "maneuver": 0}
            env.step(action)
            twin.step(action)
        (map_name, overview), (cam_name, camera) = shown[-2:]
        assert (map_name, cam_name) == ("Map", "Camera")
        want, _ = jviz.render_overview(jp, _jax_pose(env.state), ppm,
                                       render_node_names=env.render_node_names)
        np.testing.assert_array_equal(overview, want, err_msg=f"step {i}")
        np.testing.assert_array_equal(camera, twin.render())
    assert env.render() is None and len(shown) == 10
    assert created == ["Map", "Camera"] and min(waits) >= 1
    env.close()
    assert destroyed == ["Map", "Camera"]
    twin.close()
