"""The port's digital twin (tinycarlo_torch.real_world) against the JAX
package's (tinycarlo_tpu.real_world), both on the CPU in float64, each
twin on its own LoopbackCar from the same start, on tests/test_env.py's
config (simple_layout, classes, t = 2) at 64x64.

Tolerances: positions equal (the loopback car is numpy on both sides);
observations equal up to stroke-boundary pixels (t = 2, the rule of
test_torch_slice.py); infos within 1e-9 absolute (torch's and XLA's libm
differ in the last bits); reward, terminated, truncated, edges and local
paths equal; the pose functions' floats within 1e-9.
"""
import copy
import math
import socket
import struct
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_env import CONFIG
from tests.test_torch_gym import _assert_frame, _assert_info
from tinycarlo_torch import car as pcar
from tinycarlo_torch import env as penv
from tinycarlo_torch.real_world import base as pbase
from tinycarlo_torch.real_world.env import TinyCarloRealWorldEnv as PortTwin
from tinycarlo_torch.real_world.environments import env_loopback as ploop
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu.real_world import base as jbase
from tinycarlo_tpu.real_world.env import TinyCarloRealWorldEnv as JaxTwin
from tinycarlo_tpu.real_world.environments import env_loopback as jloop

ATOL = 1e-9
START = (0.9, 1.2, 0.0)
N_POSES = 16
SPAWN_ROW = 5


def _config(json_path=None):
    cfg = copy.deepcopy(CONFIG)
    cfg["camera"]["resolution"] = [64, 64]
    cfg["sim"]["real_world_env"] = "loopback"
    if json_path is not None:
        cfg["map"]["json_path"] = json_path
    return cfg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in test_torch_gym.py: B = 1 steps beside
    JAX's thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    """(port twin, its car), (JAX twin, its car): one JAX twin for the
    module (building it takes ~10 s)."""
    pc = ploop.LoopbackCar(start=START)
    port = PortTwin(config=_config(), dtype=torch.float64,
                    backend=(pc, ploop.LoopbackCamera()), device="cpu")
    jc = jloop.LoopbackCar(start=START)
    ref = JaxTwin(config=_config(), dtype=jnp.float64,
                  backend=(jc, jloop.LoopbackCamera()))
    yield (port, pc), (ref, jc)
    port.close()
    ref.close()


def test_reset_matches_jax(twins):
    (port, pc), (ref, jc) = twins
    pobs, pinfo = port.reset(seed=0)
    jobs, jinfo = ref.reset(seed=0)
    assert (pc.x, pc.y, pc.rot) == (jc.x, jc.y, jc.rot)
    _assert_frame(pobs, jobs, ref, 2)
    _assert_info(pinfo, jinfo, "reset")


@pytest.mark.parametrize("wrapped", [False, True])
def test_steps_match_jax(twins, wrapped):
    """20 identical steps, with the default shaping and `wrapped` (zero
    reward, no termination)."""
    (port, pc), (ref, jc) = twins
    port.wrapped = ref.wrapped = wrapped
    try:
        port.reset(seed=1)
        ref.reset(seed=1)
        rng = np.random.default_rng(2)
        for i in range(20):
            action = {"car_control": [0.5, float(rng.uniform(-0.5, 0.5))],
                      "maneuver": int(rng.integers(4))}
            got, want = port.step(action), ref.step(action)
            assert (pc.x, pc.y, pc.rot) == (jc.x, jc.y, jc.rot)
            _assert_frame(got[0], want[0], ref, 2)
            assert got[1:4] == want[1:4], (i, got[1:4], want[1:4])
            assert isinstance(got[1], float) and isinstance(got[2], bool)
            _assert_info(got[4], want[4], f"step {i}")
            if got[2] or got[3]:
                port.reset()
                ref.reset()
    finally:
        port.wrapped = ref.wrapped = False


def _straight_map(path):
    """A map whose lanepath runs in +x only: a pose facing -x has no edge
    within +/-90 degrees."""
    import json

    nodes = [[100.0 + 60.0 * i, 200.0] for i in range(6)]
    edges = [[i, i + 1] for i in range(5)]
    with open(path, "w") as f:
        json.dump({"width": 600, "height": 400,
                   "lanelines": {"outer": {
                       "layer_color": [255, 255, 255],
                       "nodes": [[n[0], n[1] - 20.0] for n in nodes],
                       "edges": edges}},
                   "lanepath": {"layer_color": [50, 50, 50],
                                "nodes": nodes, "edges": edges}}, f)
    return str(path)


@pytest.fixture(scope="module")
def pose_cases(twins, tmp_path_factory):
    """(JAX params, port params, JAX state, port state) on the test map
    (the twins' params) and on the straight map, and the poses, the last
    one facing -x for the straight map. Each state is spawn row
    SPAWN_ROW's."""
    (port, _), (ref, _) = twins
    cfg = _config(_straight_map(tmp_path_factory.mktemp("map") / "m.json"))
    cases = []
    for jp, pp in ((ref.params, port.params),
                   (jenv.make_env_params(cfg, dtype=jnp.float64),
                    penv.make_env_params(cfg, dtype=torch.float64,
                                         device="cpu"))):
        row = min(SPAWN_ROW, pp.map_data.spawns.count - 1)
        js, _, _ = jenv.reset(jp, jax.random.PRNGKey(0),
                              spawn_row=jnp.asarray(row), render=False)
        ps = penv.EnvState(car=pcar.car_reset(
            pp.map_data, pp.cfg.car, torch.tensor([row])))
        cases.append((jp, pp, js, ps))
    rng = np.random.default_rng(11)
    h, w = np.asarray(cases[0][0].map_data.dimension)
    poses = [(rng.uniform([0.0, 0.0], [w, h]), float(rng.uniform(-3.2, 3.2)),
              float(rng.uniform(-0.1, 0.15)), int(rng.integers(4)))
             for _ in range(N_POSES - 1)]
    return cases, poses + [(np.asarray([0.5, 0.45]), math.pi, 0.1, 0)]


def _assert_car(got, want, what):
    """A port CarState (B = 1) against a JAX CarState (one env)."""
    for name in ("local_path", "local_path_len", "last_maneuver"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{what} {name}")
    for name in ("position", "position_front", "rotation",
                 "steering_angle", "radius", "velocity"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=ATOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("index", range(N_POSES))
def test_pose_functions_match_jax(pose_cases, index):
    """snap_to_lanepath, pose_reset, pose_step and make_guidance at seeded
    poses; the last faces -x on a +x-only lanepath, where both fall back
    to edge 0."""
    cases, poses = pose_cases
    jp, pp, js, ps = cases[index == N_POSES - 1]
    position, rotation, velocity, maneuver = poses[index]
    pt, pr, pe = pbase.snap_to_lanepath(pp, position, rotation)
    jt, jr, je = jbase.snap_to_lanepath(jp, position, rotation)
    np.testing.assert_array_equal(pe, je)
    assert pe.dtype == je.dtype
    np.testing.assert_allclose(pt, jt, rtol=0, atol=ATOL)
    assert pr == pytest.approx(jr, abs=ATOL)
    if index == N_POSES - 1:
        lp = jp.map_data.lanepath
        idx = int(jbase.geo.nearest_edge_with_orientation_idx(
            lp.nodes, lp.edges, lp.edge_mask, jnp.asarray(position),
            jnp.asarray(rotation), margin_deg=90.0))
        assert idx == -1 and list(pe) == list(np.asarray(lp.edges[0]))

    before = {k: v.clone() for k, v in vars(ps.car).items()}
    preset = pbase.pose_reset(pp, ps, position, rotation)
    jreset = jbase.pose_reset(jp, js, position, rotation)
    _assert_car(preset.car, jreset.car, "pose_reset")
    pstep, ptrunc = pbase.pose_step(pp, preset, position, rotation, velocity,
                                    maneuver)
    jstep, jtrunc = jbase.pose_step(jp, jreset, position, rotation, velocity,
                                    maneuver)
    _assert_car(pstep.car, jstep.car, "pose_step")
    assert bool(ptrunc[0]) == bool(jtrunc)
    for k, v in before.items():  # functional: the input state is as it was
        assert torch.equal(getattr(ps.car, k), v), k

    got = pbase.make_guidance(pp, ps)(position, rotation, maneuver)
    want = jbase.make_guidance(jp, js)(position, rotation, maneuver)
    assert got[0] == pytest.approx(want[0], abs=ATOL)
    assert got[1] == pytest.approx(want[1], abs=ATOL)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=ATOL)
    assert got[4] == pytest.approx(want[4], abs=ATOL)


def test_guidance_leaves_the_twin_untouched(twins):
    """The drive-back guidance works on a clone: calling it leaves the
    twin's state tensors (the ones its captured steps read) as they
    were."""
    (port, _), _ = twins
    port.reset(seed=0)
    before = {k: v.clone() for k, v in vars(port.state.car).items()}
    guidance = pbase.make_guidance(port.params, port.state)
    rng = np.random.default_rng(5)
    for _ in range(4):
        cte, _, _, target, _ = guidance(rng.uniform(0.2, 1.5, 2),
                                        float(rng.uniform(-3, 3)), 0)
        assert math.isfinite(cte) and target.shape == (2,)
    for k, v in before.items():
        assert torch.equal(getattr(port.state.car, k), v), k


def test_resolve_and_register_backend():
    from tinycarlo_torch.real_world import env as penv_rw

    assert penv_rw._resolve("loopback") == (ploop.LoopbackCar,
                                            ploop.LoopbackCamera)
    assert penv_rw._resolve("LoopBack")[0] is ploop.LoopbackCar
    car, cam = penv_rw._resolve("autosys")
    assert car.__name__ == "AutosysCar" and cam.__name__ == "AutosysCamera"

    class Car(pbase.RealWorldCar):
        pass

    class Cam(pbase.RealWorldCamera):
        pass

    penv_rw.register_backend("TestRig", Car, Cam)
    try:
        assert penv_rw._resolve("testrig") == (Car, Cam)
    finally:
        penv_rw._REGISTRY.pop("testrig")
    with pytest.raises(ModuleNotFoundError):
        penv_rw._resolve("nope")


def test_pose_tracker_roundtrip():
    """One multicast packet through a real socket pair (the JAX test's,
    tests/test_realworld.py, on another port)."""
    from tinycarlo_torch.real_world.tracking import PoseTracker

    tracker = PoseTracker(port=15566)
    tracker.start()
    try:
        sender = socket.socket(socket.AF_INET, socket.SOCK_DGRAM,
                               socket.IPPROTO_UDP)
        sender.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        packet = struct.pack("BHHf", 2, 123, 456, 1.5)
        sample = None
        for _ in range(20):
            sender.sendto(packet, ("239.255.255.250", 15566))
            time.sleep(0.05)
            sample = tracker.get()
            if sample is not None:
                break
        assert sample is not None, "no packet received"
        assert sample[:3] == (2, 123.0, 456.0)
        assert sample[3] == pytest.approx(1.5)
        assert tracker.get() is None  # consume-on-read
    finally:
        tracker.stop()


def test_autosys_driveback_converges(pose_cases):
    """The port's AutosysCar, stranded 8 cm off the path with no history,
    its hardware faked by a LoopbackRig (tests/test_realworld.py's
    FakeRig), Stanley-drives back on the port's guidance to within the
    reference's 0.02 m / 20 degrees."""
    from tinycarlo_torch.real_world.environments.env_autosys import (
        AutosysCar,
    )

    cases, _ = pose_cases
    _, pp, _, ps = cases[0]
    target, trot, _ = pbase.snap_to_lanepath(pp, np.asarray([0.9, 1.2]), 0.0)
    off = np.asarray([-math.sin(trot), math.cos(trot)]) * 0.08
    rig = ploop.LoopbackRig((float(target[0] + off[0]),
                             float(target[1] + off[1]), trot))
    car = AutosysCar(pixel_per_meter=450)
    car.transport = car.tracker = rig
    car.pose()
    assert not car.history
    guidance = pbase.make_guidance(pp, ps)
    assert abs(guidance(car._position, car._rotation, 0)[0]) > 0.05
    car.reposition(target, trot, guidance=guidance)
    assert abs(guidance(car._position, car._rotation, 0)[0]) < 0.02
    _, final_rot, _ = pbase.snap_to_lanepath(pp, car._position,
                                             car._rotation)
    d = final_rot - car._rotation
    assert abs(math.atan2(math.sin(d), math.cos(d))) < math.radians(20)


def test_hardware_frame_is_preferred(twins):
    """A camera frame replaces the simulated view (cast to uint8); the
    step's device work runs without the render."""
    (port, _), _ = twins

    class Cam(pbase.RealWorldCamera):
        def capture(self):
            return np.full(port.observation_space.shape, 7.9)

    saved = port._hw_camera
    port._hw_camera = Cam()
    try:
        obs, _ = port.reset(seed=0)
        assert obs.dtype == np.uint8 and (obs == 7).all()
        obs, reward, _, _, info = port.step({"car_control": [0.5, 0.0],
                                             "maneuver": 0})
        assert obs.dtype == np.uint8 and (obs == 7).all()
        assert math.isfinite(reward) and math.isfinite(info["cte"])
    finally:
        port._hw_camera = saved


def test_gym_make_registers_the_twin():
    """gym.make("tinycarlo-torch-realworld-v2") builds the port's twin."""
    import gymnasium as gym

    import tinycarlo_torch  # noqa: F401

    env = gym.make("tinycarlo-torch-realworld-v2", config=_config(),
                   backend=(ploop.LoopbackCar(start=START),
                            ploop.LoopbackCamera()), device="cpu")
    assert isinstance(env.unwrapped, PortTwin)
    obs, info = env.reset(seed=0)
    assert obs.shape == (5, 64, 64) and abs(info["cte"]) < 0.05
    env.close()
