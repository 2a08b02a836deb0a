"""The rank path of tinycarlo_torch against the JAX package: the rank
kernel's plain version (rasterize_kernels.rasterize_rank_env_plain) against
the Pallas `_kernel_env_rank` in interpret mode, the decodes against
tinycarlo_tpu.ops.rasterize's, and the rgb / rgb_planar / rank observations
of env.render_observation_batch against the decodes of the port's own rank
map.

Tolerance: none. Rank maps, decodes and observations are equal bit for
bit (the rank map is an integer function of the bundle, and on these
inputs the stamps agree exactly at t = 1 and t = 2).

The CUDA rank kernel itself is held against the plain version on the card
by chip_smoke.py and tests/test_torch_cuda.py.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import bench_config
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.ops import rasterize as pras
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu.ops import rasterize as jras
from tinycarlo_tpu.ops import rasterize_pallas as rp


def _segments_564(seed=23):
    """tests/test_rasterize_pallas.py:574-585: B=4, E=30, 32x160 (the lane
    split), L=3, overlapping layers, env 3 empty."""
    rng = np.random.default_rng(seed)
    B, E, H, W, L = 4, 30, 32, 160, 3
    u0 = rng.uniform(-5, W + 5, (B, E)).astype(np.float32)
    v0 = rng.uniform(-5, H + 5, (B, E)).astype(np.float32)
    u1 = u0 + rng.uniform(-40, 40, (B, E)).astype(np.float32)
    v1 = v0 + rng.uniform(-12, 12, (B, E)).astype(np.float32)
    draw = rng.random((B, E)) < 0.7
    draw[3] = False
    edge_layer = rng.integers(0, L, (E,)).astype(np.int32)
    return (u0, v0, u1, v1, draw, edge_layer), L, (H, W)


def _segments_605(seed=31):
    """tests/test_rasterize_pallas.py:614-621: B=2, E=20, odd h = 30, w =
    40, L=2, every segment drawn."""
    rng = np.random.default_rng(seed)
    B, E, H, W, L = 2, 20, 30, 40, 2
    u0 = rng.uniform(0, W, (B, E)).astype(np.float32)
    v0 = rng.uniform(0, H, (B, E)).astype(np.float32)
    u1 = u0 + rng.uniform(-8, 8, (B, E)).astype(np.float32)
    v1 = v0 + rng.uniform(-8, 8, (B, E)).astype(np.float32)
    draw = np.ones((B, E), bool)
    edge_layer = rng.integers(0, L, (E,)).astype(np.int32)
    return (u0, v0, u1, v1, draw, edge_layer), L, (H, W)


# (segments, thickness, max_visible): t = 1 and 2 with the lane split and
# an empty env; odd h = 30 with the full budget and an oversubscribed one
CASES = [
    (_segments_564, 1, None),
    (_segments_564, 2, None),
    (_segments_564, 2, 4),
    (_segments_605, 2, None),
    (_segments_605, 2, 6),
]


@pytest.mark.parametrize("make,t,max_visible", CASES)
def test_rank_packed_matches_jax_kernel(make, t, max_visible):
    """The port's rasterize_rank_packed_soa on the CPU (its compaction and
    the plain rank version) equals JAX's rasterize_rank_packed_soa in
    interpret mode, bit for bit."""
    (u0, v0, u1, v1, draw, lay), L, res = make()
    want = np.asarray(rp.rasterize_rank_packed_soa(
        *(jnp.asarray(x) for x in (u0, v0, u1, v1, draw, lay)), L, res, t,
        max_visible=max_visible, interpret=True,
    ))
    got = rk.rasterize_rank_packed_soa(
        *(torch.from_numpy(x) for x in (u0, v0, u1, v1, draw, lay)), L, res,
        t, max_visible=max_visible,
    )
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0
    if make is _segments_564:
        assert not want[3].any()  # the empty env


@pytest.mark.parametrize("t", [1, 2])
def test_rank_plain_on_jax_bundle(t):
    """The plain version fed JAX's own compaction bundle equals
    `rasterize_env_rank(interpret=True)` on it, and rank_from_masks of the
    masks plain version on the same bundle."""
    (u0, v0, u1, v1, draw, lay), L, (h, w) = _segments_564(40 + t)
    k = 8 * rk._n_xblocks(w)  # oversubscribed: some copies are dropped
    bundle = jax.jit(partial(
        rp.compact_env_idx_soa, k=k, gran=16, h=h, thickness=t, n_layers=L,
        w=w,
    ))(*(jnp.asarray(x)[:, None] for x in (u0, v0, u1, v1, draw)),
       edge_layer=jnp.asarray(lay))
    want = np.asarray(rp.rasterize_env_rank(
        bundle, L, (h, w), t, gran=16, split=True, interpret=True,
    ))
    tb = tuple(torch.from_numpy(np.array(x)) for x in bundle)
    got = rk.rasterize_rank_env_plain(tb, L, (h, w), t)
    np.testing.assert_array_equal(got.numpy(), want)
    masks = rk.rasterize_masks_env_plain(tb, L, (h, w), t)
    assert torch.equal(got, pras.rank_from_masks(masks))
    assert np.asarray(bundle[-1])[3].sum() > 0 and want.max() > 0


def test_rank_wrapper_dispatch_and_counter():
    """On CPU tensors the rank wrapper takes the plain version and counts
    no launch; the exact stroke at t >= 2 is not the rank kernel's: it
    raises and names the masks route (the JAX package's env never calls
    the rank kernel under exact, env.py:274-275)."""
    (u0, v0, u1, v1, draw, lay), L, (h, w) = _segments_564()
    f = lambda x: torch.from_numpy(x)  # noqa: E731
    bundle = rk.compact_env_idx_soa(
        f(u0), f(v0), f(u1), f(v1), f(draw), 60, h, 2, edge_layer=f(lay),
        n_layers=L, w=w,
    )
    before = rk.rank_kernel.launches
    out = rk.rank_kernel(bundle, L, (h, w), 2)
    assert rk.rank_kernel.launches == before
    assert torch.equal(out, rk.rasterize_rank_env_plain(bundle, L, (h, w), 2))
    with pytest.raises(ValueError, match="masks route"):
        rk.rasterize_rank_packed_soa(f(u0), f(v0), f(u1), f(v1), f(draw),
                                     f(lay), L, (h, w), 2, stroke="exact")


def test_rank_binding_matches_c_signature():
    """RankKernel.ARGTYPES follows tc_rank_launch's parameter list in
    rank.cu, one for one."""
    from tests.test_torch_masks import c_argtypes

    assert c_argtypes("rank.cu", "tc_rank_launch") == rk.RankKernel.ARGTYPES


def _random_rank(seed, shape, n_layers):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_layers + 1, shape).astype(np.uint8)


def _colors(seed, n_layers):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n_layers, 3)).astype(np.int32)


@pytest.mark.parametrize("shape", [(4, 16, 24), (2, 3, 8, 10)])
def test_decodes_match_jax(shape):
    """rgb_from_rank, rgb_planar_from_rank and classes_from_rank (uint8
    and float32) of a random rank map, rank_from_masks and
    rasterize_rgb_planar of random masks: equal to the JAX decodes."""
    L = 5
    rank = _random_rank(sum(shape), shape, L)
    colors = _colors(7, L)
    tr, tc, jr, jc = (torch.from_numpy(rank), torch.from_numpy(colors),
                      jnp.asarray(rank), jnp.asarray(colors))
    pairs = [
        (pras.rgb_from_rank(tr, tc), jras.rgb_from_rank(jr, jc)),
        (pras.rgb_planar_from_rank(tr, tc), jras.rgb_planar_from_rank(jr, jc)),
        (pras.classes_from_rank(tr, L), jras.classes_from_rank(jr, L)),
        (pras.classes_from_rank(tr, L, torch.float32),
         jras.classes_from_rank(jr, L, jnp.float32)),
    ]
    rng = np.random.default_rng(3)
    masks = (rng.random(shape[:-2] + (L,) + shape[-2:]) < 0.3).astype(
        np.uint8) * 255
    tm, jm = torch.from_numpy(masks), jnp.asarray(masks)
    pairs += [
        (pras.rank_from_masks(tm), jras.rank_from_masks(jm)),
        (pras.rasterize_rgb_planar(tm, tc), jras.rasterize_rgb_planar(jm, jc)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def rank_env():
    """Port params of bench.py's config at 48x160 and 6 spawn states."""
    params = penv.make_env_params(bench_config((48, 160)), device="cpu")
    vstate, _ = pvec.reset(params, 6, seed=2, render=False)
    return params, vstate


def _with_format(params, fmt, **camera):
    cfg = params.cfg
    return dataclasses.replace(params, cfg=dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, observation_space_format=fmt),
        camera=dataclasses.replace(cfg.camera, **camera),
    ))


def test_rendered_formats_decode_the_rank_map(rank_env):
    """rank / rgb / rgb_planar observations equal the decodes of the port's
    own rank map, which equals rank_from_masks of its classes render; each
    has env.observation_shape and the JAX package's shape for the format."""
    params, vstate = rank_env
    colors = params.map_data.laneline_colors
    classes = penv.render_observation_batch(params, vstate.env)
    rank = penv.render_observation_batch(params, vstate.env, fmt="rank")
    assert rank.dtype == torch.uint8 and rank.shape == (6, 48, 160)
    assert torch.equal(rank, pras.rank_from_masks(classes))
    assert rank.max() > 0
    want = {"rank": rank, "rgb": pras.rgb_from_rank(rank, colors),
            "rgb_planar": pras.rgb_planar_from_rank(rank, colors)}
    jparams = jenv.make_env_params(bench_config((48, 160)))
    for fmt, obs in want.items():
        p = _with_format(params, fmt)
        got = penv.render_observation_batch(p, vstate.env)
        assert torch.equal(got, obs), fmt
        jp = jparams.replace(cfg=dataclasses.replace(
            jparams.cfg, sim=dataclasses.replace(
                jparams.cfg.sim, observation_space_format=fmt)))
        assert penv.observation_shape(p) == jenv.observation_shape(jp)
        assert tuple(got.shape[1:]) == penv.observation_shape(p)


def test_vector_obs_follow_the_format(rank_env):
    """vector.reset / vector.step return observations in the configured
    format; a float out_dtype is only defined for classes, an unknown
    format raise; with the exact stroke at t >= 2 the rgb frame is the
    composite of the exact masks' rank map."""
    params, vstate = rank_env
    p = _with_format(params, "rgb")
    rows = torch.arange(6) % p.map_data.spawns.count
    vs, obs = pvec.reset(p, 6, spawn_rows=rows)
    assert obs.shape == (6, 48, 160, 3) and obs.dtype == torch.uint8
    action = {"car_control": torch.full((6, 2), 0.3),
              "maneuver": torch.zeros(6, dtype=torch.int32)}
    _, obs2, *_ = pvec.step(p, vs, action)
    assert obs2.shape == obs.shape and obs2.dtype == torch.uint8
    with pytest.raises(ValueError, match="classes"):
        penv.render_observation_batch(p, vs.env, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="observation_space_format"):
        penv.render_observation_batch(p, vs.env, fmt="depth")
    exact = _with_format(params, "rgb", stroke="exact")
    masks = penv.render_observation_batch(exact, vs.env, fmt="classes")
    rgb = penv.render_observation_batch(exact, vs.env)
    assert torch.equal(rgb, pras.rgb_from_rank(
        pras.rank_from_masks(masks), exact.map_data.laneline_colors))
    assert rgb.shape == obs.shape and rgb.sum() > 0
