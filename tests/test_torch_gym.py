"""The port's Gymnasium entry point (tinycarlo_torch.gym_env) against the
JAX package's shim (tinycarlo_tpu.gym_env), both on the CPU in float64, on
tests/test_env.py's config (simple_layout, classes, 128x160, t = 2).

Tolerances: the spawn stream (positions, orientations) is equal exactly;
rewards and infos within 1e-9 absolute (torch's and XLA's libm differ in
the last bits); terminated, truncated and local_path equal; observations
(at 64x64, BASELINE config 1's frame) equal at t = 1 and equal up to
stroke-boundary pixels at t = 2 (the rule of test_torch_slice.py);
camera matrices within 1e-12.
"""
import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import SIMPLE_LAYOUT_MAP
from tests.test_env import CONFIG
from tests.test_torch_slice import _boundary_pixel
from tinycarlo_torch import camera as pcam
from tinycarlo_torch.gym_env import TinyCarloEnv as PortEnv
from tinycarlo_torch.utils import gym_compat
from tinycarlo_tpu import camera as jcam
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu.gym_env import TinyCarloEnv as JaxEnv
from tinycarlo_tpu.ops import rasterize_pallas as rp

ATOL = 1e-9


def _actions(n, seed=7):
    # tests/test_gym_api.py:39-45: python floats, parity is defined on the
    # float64 action stream
    rng = np.random.default_rng(seed)
    steer = rng.uniform(-0.6, 0.6, size=n)
    return [{"car_control": [0.6, float(s)], "maneuver": 0} for s in steer]


def _config(fmt="classes", resolution=(128, 160), thickness=2,
            spawn_points=None):
    cfg = copy.deepcopy(CONFIG)
    cfg["sim"]["observation_space_format"] = fmt
    cfg["camera"]["resolution"] = list(resolution)
    cfg["camera"]["line_thickness"] = thickness
    if spawn_points is not None:
        cfg["map"]["spawn_points"] = list(spawn_points)
    return cfg


def _pair(cfg, no_observation=True):
    port = PortEnv(config=cfg, dtype=torch.float64, device="cpu")
    ref = JaxEnv(config=cfg, dtype=jnp.float64)
    port.no_observation = ref.no_observation = no_observation
    return port, ref


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the port's B = 1 steps are
    small ops, and beside JAX's thread pool in the same process torch's
    intra-op threads mostly wait on each other (several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    port, ref = _pair(_config())
    yield port, ref
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def frame_pairs():
    """(fmt, thickness) -> a pair of 64x64 shims rendering every step,
    built at first use and shared by the tests of this module."""
    pairs = {}

    def get(fmt, thickness):
        if (fmt, thickness) not in pairs:
            pairs[fmt, thickness] = _pair(
                _config(fmt, (64, 64), thickness), no_observation=False)
        return pairs[fmt, thickness]

    yield get
    for port, ref in pairs.values():
        port.close()
        ref.close()


def _assert_info(got, want, what):
    assert set(got) == set(want), what
    for k in ("cte", "heading_error", "orientation", "velocity"):
        assert got[k] == pytest.approx(want[k], abs=ATOL), (what, k)
    np.testing.assert_allclose(got["position"], want["position"], rtol=0,
                               atol=ATOL, err_msg=what)
    assert list(got["laneline_distances"]) == list(want["laneline_distances"])
    for k, v in want["laneline_distances"].items():
        assert got["laneline_distances"][k] == pytest.approx(v, abs=ATOL), (
            what, k)
    assert len(got["local_path"]) == len(want["local_path"]), what
    for g, w in zip(got["local_path"], want["local_path"]):
        np.testing.assert_array_equal(g, w, err_msg=what)


def test_np_random_equals_gymnasium():
    """The port's copy of gymnasium's seeding gives gymnasium's stream."""
    from gymnasium.utils import seeding

    for seed in (0, 1, 42, 1234):
        got, got_seed = gym_compat.np_random(seed)
        want, want_seed = seeding.np_random(seed)
        assert got_seed == want_seed
        np.testing.assert_array_equal(got.integers(0, 300, 50),
                                      want.integers(0, 300, 50))
        assert got.choice(np.arange(16)) == want.choice(np.arange(16))
    with pytest.raises(ValueError):
        gym_compat.np_random(-1)


def test_spaces_equal(envs):
    port, ref = envs
    assert port.observation_space == ref.observation_space
    assert port.action_space == ref.action_space
    assert port.metadata == ref.metadata
    for name in ("fps", "T", "observation_space_format", "no_observation",
                 "wrapped", "render_realtime", "overview_pixel_per_meter",
                 "render_node_names", "config_path", "config"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.car.track_width == ref.car.track_width
    assert port.camera.resolution == ref.camera.resolution


@pytest.mark.parametrize("spawn_points", [None, (57, 143, 112, 121, 138, 157,
                                                 67, 46, 165, 124, 79, 33, 84,
                                                 21, 178, 7)])
def test_spawn_stream(spawn_points):
    """Seeded resets, and 5 more each, land on the JAX shim's spawn poses
    (the reference's rejection sampling, map.py:51-69, replayed draw for
    draw; `spawn_points` takes the `choice` branch)."""
    port, ref = _pair(_config(spawn_points=spawn_points))
    for seed in (0, 1, 42, 1234):
        for i in range(6):
            _, info_p = port.reset(seed=seed if i == 0 else None)
            _, info_r = ref.reset(seed=seed if i == 0 else None)
            np.testing.assert_array_equal(info_p["position"],
                                          info_r["position"])
            assert info_p["orientation"] == info_r["orientation"]
            assert port.car.local_path == ref.car.local_path


def test_unwrapped_steps(envs):
    """Default reward and termination, and the info dict, over 60 steps
    (tests/test_gym_api.py:76-101's rollout)."""
    port, ref = envs
    port.reset(seed=3)
    ref.reset(seed=3)
    for i, action in enumerate(_actions(60)):
        obs_p, rew_p, term_p, trunc_p, info_p = port.step(action)
        obs_r, rew_r, term_r, trunc_r, info_r = ref.step(action)
        assert rew_p == pytest.approx(rew_r, abs=ATOL), i
        assert (term_p, trunc_p) == (term_r, trunc_r), i
        assert isinstance(rew_p, float) and isinstance(term_p, bool)
        _assert_info(info_p, info_r, f"step {i}")
        # no_observation: zeros of the observation's shape
        assert obs_p.shape == obs_r.shape and not obs_p.any()
        assert port.car.local_path == ref.car.local_path
        assert port.car.velocity == pytest.approx(ref.car.velocity, abs=ATOL)
        if term_r or trunc_r:
            port.reset(seed=11)
            ref.reset(seed=11)


def _assert_frame(got, want, ref, thickness):
    """One env's frame, (L, H, W) classes or (H, W, 3) rgb: equal, or at
    t >= 2 equal except on stroke-boundary pixels of a drawn segment (of
    the pixel's layer for classes, of any layer for rgb), fewer than 0.5%
    of the pixels."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.argwhere(got != want)
    assert thickness > 1 or len(diff) == 0, diff[:5]
    assert len(diff) < got.size * 0.005
    if not len(diff):
        return
    state = jax.tree.map(lambda x: x[None], ref.state)
    p0, p1, draw = (np.asarray(x)[0] for x in
                    jenv._project_packed_batch(ref.params, state))
    lay = np.asarray(ref.params.map_data.packed_edge_layer)
    classes = got.ndim == 3 and got.shape[-1] != 3
    for d in diff:
        (l, y, x) = d if classes else (None, d[0], d[1])
        m = draw & (lay == l) if classes else draw
        a = np.trunc(np.clip(p0[m], -1e6, 1e6))
        c = np.trunc(np.clip(p1[m], -1e6, 1e6))
        assert _boundary_pixel(float(x), float(y), a, c, thickness), tuple(d)


@pytest.mark.parametrize("fmt,thickness", [("classes", 1), ("classes", 2),
                                           ("rgb", 1), ("rgb", 2)])
def test_observations(frame_pairs, fmt, thickness):
    """60 steps at 64x64 with observations: the frames of every step, and
    (classes) render() in rgb_array mode, against the JAX shim's."""
    port, ref = frame_pairs(fmt, thickness)
    obs_p, _ = port.reset(seed=5)
    obs_r, _ = ref.reset(seed=5)
    _assert_frame(obs_p, np.asarray(obs_r), ref, thickness)
    lit = 0
    for i, action in enumerate(_actions(60)):
        obs_p, rew_p, term_p, trunc_p, _ = port.step(action)
        obs_r, rew_r, term_r, trunc_r, _ = ref.step(action)
        assert rew_p == pytest.approx(rew_r, abs=ATOL)
        _assert_frame(obs_p, obs_r, ref, thickness)
        lit += int(obs_p.any())
        if term_r or trunc_r:
            port.reset(seed=11)
            ref.reset(seed=11)
    assert lit >= 50
    if fmt == "classes":
        port.render_mode = ref.render_mode = "rgb_array"
        _assert_frame(port.render(), ref.render(), ref, thickness)
        port.render_mode = ref.render_mode = None


@pytest.mark.parametrize("orientation,position,fov", [
    ((22, 0, 0), (0.0, -0.005, 0.04), 80),
    ((10.0, 3.5, -7.25), (0.01, 0.02, 0.05), 120.0),
    ((0, 0, 0), (0, 0, 0), 45.5),
])
def test_matrix_builder(orientation, position, fov):
    """camera.matrix_builder against the JAX package's in float64."""
    want = jcam.matrix_builder((128, 160), jnp.float64)(
        np.asarray(orientation, np.float64), np.asarray(position, np.float64),
        np.asarray(fov, np.float64))
    got = pcam.matrix_builder((128, 160), torch.float64, "cpu")(
        orientation, position, fov)
    np.testing.assert_allclose(got.E.numpy(), np.asarray(want.E), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K), rtol=0,
                               atol=1e-12)


def _near_plane_lines(u0, v0, u1, v1, draw):
    """(a, b - a) of the drawn segments (packed (E,) coordinates) that
    the near plane clips to beyond 1e5 px, clamped to 1e6 and truncated
    as the compaction does."""
    p0, p1 = np.stack([u0, v0], -1), np.stack([u1, v1], -1)
    far = draw & ((np.abs(p0) > 1e5) | (np.abs(p1) > 1e5)).any(-1)
    a = np.trunc(np.clip(p0[far], -1e6, 1e6))
    return a, np.trunc(np.clip(p1[far], -1e6, 1e6)) - a


def _near_plane_pixel(x, y, lines):
    """Is (x, y) within 1.5 px of one of `lines`?"""
    a, ab = lines
    cross = ab[:, 0] * (y - a[:, 1]) - ab[:, 1] * (x - a[:, 0])
    return bool(np.any(np.abs(cross) <= 1.5 * np.hypot(ab[:, 0], ab[:, 1])))


def test_update_params(frame_pairs):
    """Domain randomization: new camera parameters change the rgb view
    (written into the env's camera tensors in place, equal to the JAX
    shim's matrices); restoring them gives the original frame bit for bit.
    The view follows the JAX shim's at t = 1 except on segments the near
    plane clips to ~1e6 px (pitch 10 deg, fov 120 brings one into view):
    there the JAX package's Pallas masks kernel, which the port's kernel
    and its plain version follow, and its CPU renderer (the JAX shim's
    frames, cv2's line on the clamped endpoints) part by a few pixels
    (ROADMAP.md, faults, F3); the masks equal the Pallas kernel's."""
    port, ref = frame_pairs("classes", 1)
    port.reset(seed=21)
    ref.reset(seed=21)
    camera = port.params.camera
    tensors = (camera.E, camera.K)
    before = port._camera_rgb()
    np.testing.assert_array_equal(before, ref._camera_rgb())
    for shim in (port, ref):
        shim.camera.orientation[0] = 10.0
        shim.camera.fov = 120.0
        shim.camera.update_params()
    after = port._camera_rgb()
    assert after.shape == before.shape == (64, 64, 3)
    assert np.any(before != after)
    assert port.params.camera.E is tensors[0]
    assert port.params.camera.K is tensors[1]
    for got, want in ((camera.E, ref.params.camera.E),
                      (camera.K, ref.params.camera.K)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
    # the masks equal the Pallas kernel's (interpret mode) on the JAX
    # package's own compaction of the same state, bit for bit
    state = jax.tree.map(lambda v: v[None], ref.state)
    md = ref.params.map_data
    segs = jax.jit(jenv._project_packed_batch_soa)(ref.params, state)
    *coords, draw = (v.reshape(1, 1, -1) for v in segs)
    bundle = jax.jit(partial(
        rp.compact_env_idx_soa, k=128, gran=16, h=64, thickness=1,
        n_layers=5, w=64,
    ))(*(c.astype(jnp.float32) for c in coords), draw,
       edge_layer=md.packed_edge_layer)
    pallas = np.asarray(rp.rasterize_env_idx(
        bundle, 5, (64, 64), 1, gran=16, split=True, interpret=True))
    # the JAX shim's view: equal but near such segments
    diff = np.argwhere((after != np.asarray(ref._camera_rgb())).any(-1))
    assert len(diff) < 32
    lines = _near_plane_lines(*(np.asarray(v)[0] for v in segs))
    for y, x in diff:
        assert _near_plane_pixel(float(x), float(y), lines), (y, x)
    np.testing.assert_array_equal(port._render_obs()[None], pallas)
    for shim in (port, ref):
        shim.camera.orientation[0] = 22
        shim.camera.fov = 80
        shim.camera.update_params()
    np.testing.assert_array_equal(port._camera_rgb(), before)


def test_debug_staged_step(monkeypatch, capsys):
    """DEBUG=1 prints the JAX shim's lines and returns what the fused step
    returns from the same state; DEBUG=2 adds a line per layer."""
    cfg = _config("classes", (64, 64), 2)
    fused = PortEnv(config=cfg, dtype=torch.float64, device="cpu")
    staged = PortEnv(config=cfg, dtype=torch.float64, device="cpu")
    fused.reset(seed=7)
    staged.reset(seed=7)
    for i, action in enumerate(_actions(3, seed=2)):
        want = fused.step(action)
        monkeypatch.setenv("DEBUG", "2" if i == 2 else "1")
        got = staged.step(action)
        monkeypatch.delenv("DEBUG")
        out = capsys.readouterr().out
        assert "all:" in out and "obs render" in out and "car step" in out
        assert "obs projection:" in out
        assert ("camera layer outer: project" in out) == (i == 2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        assert isinstance(got[1], float) and isinstance(got[2], bool)
        assert got[4]["cte"] == want[4]["cte"]
        _assert_info(got[4], want[4], f"step {i}")


def test_human_render_and_device(monkeypatch):
    """render_mode="human" builds and shows its two windows (cv2's window
    calls stubbed: no display here); an unknown mode raises."""
    import cv2

    shown = []
    monkeypatch.setattr(cv2, "namedWindow", lambda name, flags: None)
    monkeypatch.setattr(cv2, "imshow",
                        lambda name, image: shown.append(name))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    monkeypatch.setattr(cv2, "destroyWindow", lambda name: None)
    env = PortEnv(render_mode="human", config=_config("classes", (32, 40)),
                  device="cpu")
    assert env.render() is None and shown == ["Map", "Camera"]
    env.close()
    with pytest.raises(ValueError):
        PortEnv(render_mode="nope", config=_config(), device="cpu")


def test_gym_make_registers_the_port():
    """gym.make("tinycarlo-torch-v2") builds the port's shim; the JAX
    package keeps "tinycarlo-v2"."""
    import gymnasium as gym

    import tinycarlo_torch  # noqa: F401

    env = gym.make("tinycarlo-torch-v2", config=_config(
        "classes", (64, 64), 2), device="cpu")
    assert isinstance(env.unwrapped, PortEnv)
    assert gym.spec("tinycarlo-v2").entry_point.startswith("tinycarlo_tpu")
    obs, info = env.reset(seed=0)
    assert obs.shape == (5, 64, 64) and set(info) >= {"cte", "local_path"}
    obs, rew, term, trunc, info = env.step(
        {"car_control": np.array([0.3, 0.0], np.float32), "maneuver": 0})
    assert obs.shape == (5, 64, 64) and isinstance(rew, float)
    env.close()
    assert SIMPLE_LAYOUT_MAP in str(env.unwrapped.config)


def test_gym_bench_run_on_cpu():
    """tinycarlo_torch.benchmarks.gym_bench's workload on a CPU shim of
    BASELINE config 1: every step renders (resets included), and the CPU
    launches no kernel."""
    from tinycarlo_torch.benchmarks import gym_bench as gb

    env = gb.make_env(gb.CONFIG1, "cpu")
    assert env.observation_space.shape == (5, 64, 64) and not env.graphs
    launches = [k.launches for k in gb.RENDER_KERNELS]
    r = gb.run(env, steps=6)
    assert r["renders"] == r["resets"] + 7 and r["steps_per_s"] > 0
    assert [k.launches for k in gb.RENDER_KERNELS] == launches
    acts = gb.actions(3)
    assert acts[0]["car_control"].dtype == np.float32
    assert all(0 <= a["maneuver"] < 4 for a in acts)
