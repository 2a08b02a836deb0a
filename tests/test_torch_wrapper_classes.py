"""The port's Gymnasium wrapper classes (tinycarlo_torch.wrapper) around its
shim against the JAX package's around its own, and the batched blob noise
(wrapper/functional.py) against the JAX package's, on the CPU in float64.

Tolerances: rewards within 1e-9 absolute (the shims' infos agree to 1e-9:
torch's and XLA's libm differ in the last bits); terminations equal. Blob
noise given the draws the JAX package makes from a key: equal bit for bit.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinycarlo_torch.wrapper as pw
import tinycarlo_tpu.wrapper as jw
from tests.test_torch_common import bench_config
from tests.test_torch_gym import _actions, _config, _pair
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.wrapper import functional as pwf
from tinycarlo_tpu.wrapper import functional as jwf

ATOL = 1e-9


def _stack(env, w):
    """tests/test_gym_api.py:110-116: the reference TD3 stack
    (train_td3.py:60-62) and laneline shaping."""
    env = w.CTELinearRewardWrapper(env, min_cte=0.03, max_reward=1.0,
                                   min_reward=-1.0)
    env = w.LanelineSparseRewardWrapper(env, {"outer": -2.0})
    env = w.CTETerminationWrapper(env, max_cte=0.1, number_of_steps=5)
    env = w.LanelineCrossingTerminationWrapper(env, ["outer"])
    env = w.CrashTerminationWrapper(env, number_of_steps=10)
    return env


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


def _run(port_w, ref_w, steps, seed=9, reset_seed=13):
    """Both wrapped shims through the same actions; returns the number of
    episodes that ended."""
    port_w.reset(seed=5)
    ref_w.reset(seed=5)
    ends = 0
    for i, action in enumerate(_actions(steps, seed=seed)):
        _, rew_p, term_p, trunc_p, _ = port_w.step(action)
        _, rew_r, term_r, trunc_r, _ = ref_w.step(action)
        assert rew_p == pytest.approx(rew_r, abs=ATOL), i
        assert (term_p, trunc_p) == (term_r, trunc_r), i
        if term_r or trunc_r:
            ends += 1
            port_w.reset(seed=reset_seed)
            ref_w.reset(seed=reset_seed)
    return ends


def test_wrapped_stack(envs):
    """The five-wrapper stack over 120 steps: equal rewards and
    terminations, with at least one termination."""
    port, ref = envs
    port_w, ref_w = _stack(port, pw), _stack(ref, jw)
    assert port.wrapped and ref.wrapped
    assert _run(port_w, ref_w, 120) >= 1


WRAPPERS = [
    ("LanelineSparseRewardWrapper", ({"outer": -2.0, "solid": 0.5},), {}),
    ("LanelineLinearRewardWrapper", ({"outer": 1.0, "dashed": -0.5,
                                      "solid": 0.25, "hold": 2.0,
                                      "area": -1.0},), {}),
    ("CTESparseRewardWrapper", (), dict(min_cte=0.01, sparse_reward=0.7)),
    ("CTELinearRewardWrapper", (), dict(min_cte=0.03, max_reward=-1.0)),
    ("LanelineCrossingTerminationWrapper", ("outer",), {}),
    ("CTETerminationWrapper", (), dict(max_cte=0.02, number_of_steps=3)),
    ("CrashTerminationWrapper", (), dict(velcoity_threshold=0.2,
                                         number_of_steps=4)),
]


@pytest.mark.parametrize("name,args,kwargs", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_wrapper_class(envs, name, args, kwargs):
    """Each wrapper class alone over 60 steps; the consecutive
    terminations' `steps_true` counters stay equal."""
    port, ref = envs
    port_w = getattr(pw, name)(port, *args, **kwargs)
    ref_w = getattr(jw, name)(ref, *args, **kwargs)
    assert port_w.unwrapped is port and port.wrapped
    assert port_w.observation_space == ref_w.observation_space
    _run(port_w, ref_w, 60, seed=3)
    assert getattr(port_w, "steps_true", 0) == getattr(ref_w, "steps_true", 0)


def _jax_draws(key, c, h, w, blob_max_radius, n_blobs):
    """The draws of tinycarlo_tpu's add_blob_noise_classes
    (functional.py:177-183), as numpy arrays."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    shape = (c, n_blobs)
    return tuple(np.asarray(x) for x in (
        jax.random.randint(k1, shape, 0, w),
        jax.random.randint(k2, shape, 0, h),
        jax.random.randint(k3, shape, 1, max(2, blob_max_radius)),
        jax.random.uniform(k4, shape) < 0.3,
        jax.random.randint(k5, shape, 0, c),
    ))


def _masks(seed, shape):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < 0.15) * 255).astype(np.uint8)


@pytest.mark.parametrize("radius,n_blobs", [(100, 10), (20, 5), (3, 40)])
def test_blob_noise_given_jax_draws(radius, n_blobs):
    """apply_blob_noise on the JAX package's draws equals its
    add_blob_noise_classes, one env and a batch of three."""
    c, h, w = 5, 48, 64
    obs = _masks(radius, (3, c, h, w))
    keys = jax.random.split(jax.random.PRNGKey(radius + n_blobs), 3)
    want = np.stack([np.asarray(jwf.add_blob_noise_classes(
        k, jnp.asarray(o), radius, n_blobs)) for k, o in zip(keys, obs)])
    draws = [np.stack(d) for d in zip(*(
        _jax_draws(k, c, h, w, radius, n_blobs) for k in keys))]
    got = pwf.apply_blob_noise(torch.from_numpy(obs),
                               *(torch.from_numpy(d) for d in draws))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    one = pwf.apply_blob_noise(torch.from_numpy(obs[1]),
                               *(torch.from_numpy(d[1]) for d in draws))
    np.testing.assert_array_equal(one.numpy(), want[1])
    assert not np.array_equal(want, obs)


def test_blob_noise_draws_and_identity():
    """The port's own draws: in range and of the JAX draws' shapes; values
    stay in {0, 255}; n_blobs = 0 is the identity."""
    obs = torch.from_numpy(_masks(1, (2, 5, 48, 64)))
    gen = torch.Generator().manual_seed(4)
    xs, ys, radius, copy_mode, src = pwf.blob_noise_draws(gen, obs, 30, 7)
    for d in (xs, ys, radius, copy_mode, src):
        assert d.shape == (2, 5, 7)
    assert 0 <= xs.min() and xs.max() < 64 and 0 <= ys.min() and ys.max() < 48
    assert 1 <= radius.min() and radius.max() < 30 and copy_mode.dtype == torch.bool
    assert 0 <= src.min() and src.max() < 5
    out = pwf.add_blob_noise_classes(gen, obs, 30, 7)
    assert set(np.unique(out.numpy())) <= {0, 255}
    assert not torch.equal(out, obs)
    assert torch.equal(pwf.add_blob_noise_classes(gen, obs, 30, 0), obs)


def test_vector_step_applies_observation_fns():
    """vector.step with a stack carrying blob noise: the rendered
    observations keep their shape and dtype, are noised (the plain render
    of the same state differs) and draw from the state's generator; an
    observation-only stack keeps the default reward."""
    params = penv.make_env_params(bench_config((32, 48)), device="cpu")
    stack = pwf.WrapperStack(observation_fns=(
        lambda g, o: pwf.add_blob_noise_classes(g, o, 20, 10),))
    plain_stack = pwf.WrapperStack()
    action = {"car_control": torch.tensor([[0.5, 0.1]] * 4),
              "maneuver": torch.zeros(4, dtype=torch.int32)}
    rows = torch.arange(4)
    vs, _ = pvec.reset(params, 4, seed=1, stack=stack, spawn_rows=rows)
    ps, _ = pvec.reset(params, 4, seed=1, stack=plain_stack, spawn_rows=rows)
    vs, obs, rew, *_ = pvec.step(params, vs, action, stack=stack)
    ps, pobs, prew, *_ = pvec.step(params, ps, action, stack=plain_stack)
    assert obs.shape == pobs.shape == (4, 5, 32, 48)
    assert obs.dtype == torch.uint8
    assert set(np.unique(obs.numpy())) <= {0, 255}
    assert not torch.equal(obs, pobs)
    assert torch.equal(rew, prew)
    assert not torch.equal(vs.generator.get_state(), ps.generator.get_state())


def test_noise_observation_wrapper(envs):
    """NoiseObservationWrapper around the port's classes shim: uint8 frames
    of the observation's shape, values in {0, 255}, reproducible from
    numpy's global seed; it sets the wrapped flag (zero reward)."""
    cfg = _config("classes", (64, 64), 2)
    frames = []
    for _ in range(2):
        from tinycarlo_torch.gym_env import TinyCarloEnv

        env = TinyCarloEnv(config=copy.deepcopy(cfg), dtype=torch.float64,
                           device="cpu")
        np.random.seed(17)
        wrapped = pw.NoiseObservationWrapper(env, blob_max_radius=20,
                                             n_blobs=5)
        wrapped.reset(seed=0)
        obs, rew, *_ = wrapped.step(
            {"car_control": np.array([0.3, 0.0], np.float32), "maneuver": 0})
        assert obs.shape == env.observation_space.shape
        assert obs.dtype == np.uint8 and rew == 0.0
        assert set(np.unique(obs)) <= {0, 255}
        frames.append(obs)
    np.testing.assert_array_equal(frames[0], frames[1])
