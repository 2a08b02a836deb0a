"""tinycarlo_torch's shaping (wrapper/functional.py), Stanley controller,
geometry queries and vector.step options against the JAX package, in
float64 on numpy-seeded inputs. Rewards and terminations are equal
(elementwise arithmetic in the same order); counters are equal.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import bench_config, to_numpy_tree
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch import geometry as pgeo
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.train import stanley as pst
from tinycarlo_torch.wrapper import functional as pwf
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import geometry as jgeo
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.train import stanley as jst
from tinycarlo_tpu.wrapper import functional as jwf

NAMES = ("outer", "dashed", "solid", "area", "holding")


def _info(seed, b=64):
    rng = np.random.default_rng(seed)
    return {
        "cte": rng.normal(0, 0.03, b),
        "velocity": rng.choice([0.0, 0.001, 0.1], b),
        "laneline_distances": rng.uniform(0, 0.05, (b, len(NAMES))),
    }


SHAPERS = [
    ("laneline_sparse_reward", dict(track_width=0.027, layer_names=NAMES,
                                    rewards={"outer": -1.0, "solid": 0.5})),
    ("laneline_linear_reward", dict(
        track_width=0.027, layer_names=NAMES,
        max_rewards={n: 0.2 * (i - 2) for i, n in enumerate(NAMES)})),
    ("cte_sparse_reward", dict(min_cte=0.02, sparse=0.7)),
    ("cte_linear_reward", dict(min_cte=0.03, max_reward=1.0,
                               min_reward=-1.0)),
    ("cte_linear_reward", dict(min_cte=0.03, max_reward=-1.0)),
    ("laneline_crossing_termination", dict(
        track_width=0.027, lanelines=("outer", "solid"), layer_names=NAMES)),
]


@pytest.mark.parametrize("name,kwargs", SHAPERS)
def test_shapers_equal(name, kwargs):
    info = _info(1)
    want = np.asarray(getattr(jwf, name)(
        {k: jnp.asarray(v) for k, v in info.items()}, **kwargs))
    got = getattr(pwf, name)(
        {k: torch.from_numpy(v) for k, v in info.items()}, **kwargs).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kwargs", [
    ("cte_termination", dict(max_cte=0.02, number_of_steps=3)),
    ("crash_termination", dict(velocity_threshold=0.005, number_of_steps=2)),
])
def test_counting_terminators_equal(name, kwargs):
    jc = jnp.zeros(64, jnp.int32)
    pc = torch.zeros(64, dtype=torch.int32)
    for step in range(8):
        info = _info(10 + step)
        jf, jc = getattr(jwf, name)(
            {k: jnp.asarray(v) for k, v in info.items()}, jc, **kwargs)
        pf, pc = getattr(pwf, name)(
            {k: torch.from_numpy(v) for k, v in info.items()}, pc, **kwargs)
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_stanley_equal_and_ou_step():
    rng = np.random.default_rng(2)
    cte, he = rng.normal(0, 0.05, 64), rng.normal(0, 0.3, 64)
    want = np.asarray(jst.stanley_steering(jnp.asarray(cte), jnp.asarray(he),
                                           0.5, 5.0, 30.0))
    got = pst.stanley_steering(torch.from_numpy(cte), torch.from_numpy(he),
                               0.5, 5.0, 30.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)  # atan2 libm
    noise = torch.from_numpy(rng.normal(0, 1, 64))
    out = pst.ou_step(noise, torch.Generator().manual_seed(3), 0.1, 0.2, 0.4)
    eps = torch.randn(64, generator=torch.Generator().manual_seed(3),
                      dtype=noise.dtype)
    torch.testing.assert_close(out, noise + 0.1 * (0.2 - noise) + 0.4 * eps,
                               rtol=0, atol=0)


def test_geometry_queries_equal():
    """The queries car.py does not reach: nearest edge and node by index,
    and distance to a node."""
    cfg = bench_config()
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    lp = jp.map_data.lanepath
    nodes, edges, emask, nmask = lp.nodes, lp.edges, lp.edge_mask, lp.node_mask
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 2.0, (64, 2))

    def t(x):
        return torch.from_numpy(np.array(x))

    want = np.asarray(jax.vmap(
        lambda p: jgeo.nearest_edge_idx(nodes, edges, emask, p))(pos))
    got = pgeo.nearest_edge_idx(t(nodes), t(edges), t(emask), t(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.vmap(
        lambda p: jgeo.nearest_node_idx(nodes, nmask, p))(pos))
    got = pgeo.nearest_node_idx(t(nodes), t(nmask), t(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    idx = rng.integers(0, lp.n_nodes, 64)
    want = np.asarray(jax.vmap(
        lambda i, p: jgeo.distance_to_node(nodes, i, p))(idx, pos))
    got = pgeo.distance_to_node(t(nodes), t(idx), t(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


def test_vector_stack_and_no_auto_reset():
    """A fused wrapper stack (default shaping off, counters carried) and
    auto_reset=False through vector.step, 20 steps at B=8 without
    rendering."""
    cfg = bench_config()
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    names = jp.map_data.laneline_names

    def stack(wf):
        return wf.WrapperStack(
            reward_fns=(partial(wf.cte_linear_reward, min_cte=0.01,
                                max_reward=1.0, min_reward=-1.0),),
            termination_fns=(
                partial(wf.cte_termination, max_cte=0.005, number_of_steps=3),
                lambda info, c: (wf.laneline_crossing_termination(
                    info, 0.027, ("outer",), names), c),
            ),
        )

    jstack, pstack = stack(jwf), stack(pwf)
    jvs, _ = jvec.reset(jp, jax.random.key(5), 8, stack=jstack, render=False)
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    jstep = jax.jit(partial(jvec.step, jp, stack=jstack, render=False,
                            auto_reset=False, max_episode_steps=12))
    rng = np.random.default_rng(6)
    fired = 0
    for step in range(20):
        control = np.stack([np.full(8, 0.6), rng.uniform(-1, 1, 8)], -1)
        man = np.zeros(8, np.int32)
        jvs, _, jr, jte, jtr, _ = jstep(
            jvs, {"car_control": jnp.asarray(control),
                  "maneuver": jnp.asarray(man)})
        pvs, pobs, pr, pte, ptr, _ = pvec.step(
            pp, pvs, {"car_control": torch.from_numpy(control),
                      "maneuver": torch.from_numpy(man)},
            stack=pstack, render=False, auto_reset=False,
            max_episode_steps=12,
        )
        assert pobs is None
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(pte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
        for pc, jc in zip(pvs.counters, jvs.counters):
            np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(pvs.env.car.position.numpy(),
                                   np.asarray(jvs.env.car.position),
                                   rtol=0, atol=1e-9)
        fired += int(np.asarray(jte).sum())
    assert fired > 0
    # without auto-reset the step counter keeps running past the limit
    assert int(pvs.episode_step.min()) == 20
