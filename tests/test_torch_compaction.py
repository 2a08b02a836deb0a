"""tinycarlo_torch's compaction against the JAX package's
`compact_env_idx_soa(pre=False)` and `segment_overflow`: given the same
projected coordinates, the bundles are equal element for element (values
and dtypes) -- the torch.topk selection, the lane split at w > 128, the
t=1 clip, the budget's oversubscription and both per-layer count paths.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import bench_config, to_numpy_tree
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.ops import rasterize_pallas as rp


def random_segments(seed, b, e, h, w, n_layers):
    """Numpy-seeded segments: short, long, tall, off-frame and block-
    crossing, with a random (non-contiguous) layer per edge."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, 1, e))
    v0 = rng.uniform(-40, h + 40, (b, 1, e))
    u1 = u0 + rng.uniform(-90, 90, (b, 1, e))
    v1 = v0 + rng.uniform(-50, 50, (b, 1, e))
    draw = rng.random((b, 1, e)) < 0.7
    draw[0] = False  # an env with nothing to draw
    edge_layer = rng.integers(0, n_layers, e).astype(np.int32)
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(u0), f32(v0), f32(u1), f32(v1), draw, edge_layer


def bundles(u0, v0, u1, v1, draw, edge_layer, n_layers, k, h, w, t,
            layer_bounds=None):
    """(JAX bundle, port bundle) as numpy arrays. The inputs carry JAX's
    (B, 1, E) packed layout; the port takes (B, E)."""
    jfn = jax.jit(partial(
        rp.compact_env_idx_soa, k=k, gran=16, h=h, thickness=t,
        n_layers=n_layers, w=w, layer_bounds=layer_bounds,
    ))
    want = jfn(jnp.asarray(u0), jnp.asarray(v0), jnp.asarray(u1),
               jnp.asarray(v1), jnp.asarray(draw),
               edge_layer=jnp.asarray(edge_layer))
    got = rk.compact_env_idx_soa(
        *(torch.from_numpy(np.array(x)[:, 0]) for x in (u0, v0, u1, v1, draw)),
        k, h, t, edge_layer=torch.from_numpy(np.array(edge_layer)),
        n_layers=n_layers, w=w, layer_bounds=layer_bounds,
    )
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


NAMES = ("idx", "ax", "ay", "abx", "aby", "inv", "bw", "counts")


def _inv_fma(abx, aby):
    """1/len^2 with the denominator contracted into one fused multiply-add,
    fma(abx, abx, aby*aby), computed exactly in float64 and rounded once:
    what XLA's CPU backend emits for `abx * abx + aby * aby`."""
    a = abx.astype(np.float64)
    c = (aby * aby).astype(np.float64)
    denom = (a * a + c).astype(np.float32)
    return np.float32(1.0) / np.where(denom == 0, np.float32(1.0), denom)


def assert_bundles_equal(got, want, thickness=2):
    """Equal element for element. The one exception is `inv` at t >= 2:
    XLA's CPU backend contracts the denominator abx*abx + aby*aby into a
    fused multiply-add, which the port (like the CUDA kernel's inputs)
    rounds as two operations. The two differ only once the squares pass
    2^24, i.e. for segments longer than 4096 px (near-plane clipped ones);
    there the JAX value must be exactly the contracted one."""
    assert len(got) == len(want) == 8
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if name == "inv" and thickness >= 2:
            fused = _inv_fma(got[3], got[4])
            np.testing.assert_array_equal(
                np.where(g == w, g, fused), w, err_msg=name
            )
            differ = g != w
            assert np.all(np.maximum(np.abs(got[3]), np.abs(got[4]))[differ]
                          > 4096)
            continue
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("w", [48, 160])
@pytest.mark.parametrize("oversub", [False, True])
def test_random_bundle_equal(t, w, oversub):
    h, e, n_layers = 40, 48, 3
    segs = random_segments(t * 100 + w, 6, e, h, w, n_layers)
    nxb = rk._n_xblocks(w)
    k = (6 if oversub else e) * nxb
    want, got = bundles(*segs, n_layers, k, h, w, t)
    assert_bundles_equal(got, want, t)
    dropped = want[-1][3]
    assert (dropped.sum() > 0) == oversub


@pytest.fixture(scope="module")
def real_frames():
    """Packed projections of 32 spawn states of bench.py's config at
    64x160, from the JAX package."""
    cfg = bench_config((64, 160))
    jp = jenv.make_env_params(cfg)
    vstate, _ = jax.jit(partial(jvec.reset, jp, n_envs=32, render=False))(
        jax.random.key(0)
    )
    return cfg, jp, vstate


def test_real_frames_bundle_equal(real_frames):
    """Real frames through the production call: packed edge axis, static
    layer bounds, the max_visible_segments budget."""
    cfg, jp, vstate = real_frames
    md = jp.map_data
    u0, v0, u1, v1, draw = (
        np.asarray(x)[:, None]
        for x in jenv._project_packed_batch_soa(jp, vstate.env)
    )
    h, w = cfg["camera"]["resolution"]
    e = u0.shape[-1]
    for k in (128 * 2, 12):  # the production budget, and oversubscribed
        want, got = bundles(
            u0, v0, u1, v1, draw, np.asarray(md.packed_edge_layer),
            md.n_layers, min(k, 2 * e), h, w, 2,
            layer_bounds=md.packed_layer_bounds,
        )
        assert_bundles_equal(got, want)
        assert want[-1][0].max() > 0


def test_segment_overflow_equal(real_frames):
    cfg, jp, vstate = real_frames
    pp = convert.env_params_from_numpy(to_numpy_tree(jp), cfg, device="cpu")
    pstate = convert.vec_state_from_numpy(to_numpy_tree(vstate), "cpu")
    for budget in (128, 4):
        jcfg = dataclasses.replace(
            jp.cfg, camera=dataclasses.replace(
                jp.cfg.camera, max_visible_segments=budget
            )
        )
        pcfg = dataclasses.replace(
            pp.cfg, camera=dataclasses.replace(
                pp.cfg.camera, max_visible_segments=budget
            )
        )
        want = np.asarray(jenv.check_segment_overflow(
            jp.replace(cfg=jcfg), vstate.env
        ))
        got = penv.check_segment_overflow(
            dataclasses.replace(pp, cfg=pcfg), pstate.env
        ).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want.sum() > 0) == (budget == 4)
