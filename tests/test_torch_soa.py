"""The port's older SoA compactions (tinycarlo_torch.ops.rasterize_kernels
`compact_soa`, `compact_env_soa`, `compact_env_seg`) against the JAX
package's, and the point-form projections (`camera.project_layer`,
`env._project_packed_batch`).

Bundles: given the same segments, equal element for element (values and
dtypes) -- the direct routing (torch.topk / argsort plus indexing against
the JAX package's one-hot matmul, which turns -0.0 into +0.0; the
comparison treats the two as equal), gran 8 and 16, k below and above E,
odd k, oversubscription, h not a multiple of the band, 1-3 lane blocks,
split and unsplit, t = 1, 2, 3, per-layer and packed axes. The one
exception is `inv` at t >= 2 where XLA's CPU backend contracts abx*abx +
aby*aby into a fused multiply-add (segments longer than 4096 px;
test_torch_compaction.assert_bundles_equal's rule).

project_layer: given the JAX package's matrices and car poses, the draw
mask is equal and endpoints in front of the camera agree within
tests/test_torch_camera.py's FRONT_TOL (float32; scaled by the machine
epsilon in float64). Neither dtype is bit-identical: the pose and K
products are matrix products on both sides, summed and contracted in their
own orders. A near-plane clipped endpoint keeps the depth its clip
computes (p_move + t * direction), off the plane z = -1e-7 by a few ulps
of the edge's depths, which the divide by |z| amplifies: its coordinates
agree to a relative eps * (|z0| + |z1|) / 1e-7 (measured <= 0.26 of it in
both dtypes; up to 2.5% in float32 at ~1e9 px, where the compaction clamps
to 1e6 px).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_camera import FRONT_TOL
from tests.test_torch_common import bench_config, to_numpy_tree
from tests.test_torch_compaction import _inv_fma
from tinycarlo_torch import camera as pcam
from tinycarlo_torch import car as pcar
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu import camera as jcam
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.ops import rasterize_pallas as rp


def soa_segments(seed, b, nl, e, h, w):
    """Numpy-seeded per-layer segments (b, nl, e): short, tall, off-frame
    and block-crossing; env 0 draws nothing."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, nl, e))
    v0 = rng.uniform(-40, h + 40, (b, nl, e))
    u1 = u0 + rng.uniform(-90, 90, (b, nl, e))
    v1 = v0 + rng.uniform(-70, 70, (b, nl, e))
    draw = rng.random((b, nl, e)) < 0.7
    draw[0] = False
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(u0), f32(v0), f32(u1), f32(v1), draw


def points(u0, v0, u1, v1):
    return np.stack([u0, v0], -1), np.stack([u1, v1], -1)


def assert_soa_equal(got, want, thickness, inv_at):
    """Equal element for element (dtypes too; -0.0 == +0.0), except `inv`
    (at position inv_at, abx and aby before it) at t >= 2, which may be
    XLA's FMA-contracted value, and only for segments longer than 4096
    px."""
    assert len(got) == len(want)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype,
                                                            w.dtype)
        if i == inv_at and thickness >= 2:
            abx, aby = got[i - 2], got[i - 1]
            np.testing.assert_array_equal(
                np.where(g == w, g, _inv_fma(abx, aby)), w, err_msg="inv")
            differ = g != w
            assert np.all(np.maximum(np.abs(abx), np.abs(aby))[differ] > 4096)
            continue
        np.testing.assert_array_equal(g, w, err_msg=f"field {i}")


# (seed, B, L, E, h, w, t, gran, k per layer)
CASES = [
    (1, 4, 3, 24, 40, 48, 1, 8, 24),     # t = 1, one lane block, k = E
    (2, 4, 3, 24, 30, 160, 2, 16, 7),    # odd k < E, oversubscribed, h % 16
    (3, 4, 3, 24, 44, 200, 3, 8, 31),    # k > E, h % 8, two blocks
    (4, 4, 2, 30, 64, 300, 2, 8, 13),    # three blocks, oversubscribed
    (5, 3, 2, 20, 32, 160, 1, 16, 5),    # t = 1 split, odd k, oversubscribed
]
IDS = [f"t{c[6]}-g{c[7]}-{c[4]}x{c[5]}-k{c[8]}" for c in CASES]
# (case, split): unsplit needs no w, which the t = 1 clip requires
SPLITS = [(c, s) for c in CASES for s in (True, False) if s or c[6] >= 2]
SPLIT_IDS = [f"{IDS[CASES.index(c)]}-{'split' if s else 'unsplit'}"
             for c, s in SPLITS]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compact_soa_equal(case):
    seed, b, nl, e, h, w, t, gran, k = case
    u0, v0, u1, v1, draw = soa_segments(seed, b, nl, e, h, w)
    p0, p1 = points(u0, v0, u1, v1)
    want = jax.jit(partial(rp.compact_soa, k=k, gran=gran, h=h, thickness=t,
                           w=w))(jnp.asarray(p0), jnp.asarray(p1),
                                 jnp.asarray(draw))
    got = rk.compact_soa(torch.from_numpy(p0), torch.from_numpy(p1),
                         torch.from_numpy(draw), k, gran, h, t, w=w)
    assert_soa_equal(got, want, t, inv_at=4)
    counts = got[-1].numpy()
    assert counts[0].max() > 0 and counts[0, :nl].max() == 0
    assert (counts[2].sum() > 0) == (k < e)
    assert got[0].shape[-1] == min(k, e) + min(k, e) % 2


@pytest.mark.parametrize("case,split", SPLITS, ids=SPLIT_IDS)
def test_compact_env_soa_equal(case, split):
    seed, b, nl, e, h, w, t, gran, k = case
    u0, v0, u1, v1, draw = soa_segments(seed, b, nl, e, h, w)
    p0, p1 = points(u0, v0, u1, v1)
    wk = w if split else None
    kk = k * nl * (rk._n_xblocks(w) if split else 1)
    want = jax.jit(partial(rp.compact_env_soa, k=kk, gran=gran, h=h,
                           thickness=t, w=wk))(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(draw))
    got = rk.compact_env_soa(torch.from_numpy(p0), torch.from_numpy(p1),
                             torch.from_numpy(draw), kk, gran, h, t, w=wk)
    assert_soa_equal(got, want, t, inv_at=4)
    assert got[-1].shape == (3, b) and got[-1][0].max() > 0


@pytest.mark.parametrize("case,split", SPLITS, ids=SPLIT_IDS)
def test_compact_env_seg_equal(case, split):
    seed, b, nl, e, h, w, t, gran, k = case
    segs = soa_segments(seed, b, nl, e, h, w)
    wk = w if split else None
    want = jax.jit(partial(rp.compact_env_seg, k=k * nl, gran=gran, h=h,
                           thickness=t, w=wk))(*(jnp.asarray(x) for x in segs))
    got = rk.compact_env_seg(*(torch.from_numpy(x) for x in segs), k * nl,
                             gran, h, t, w=wk)
    assert_soa_equal(got, want, t, inv_at=5)
    assert got[-1].shape == (4 + nl, b) and got[-1][0].max() > 0


@pytest.mark.parametrize("w", [200, 300])
def test_packed_axis_bundles_equal(w):
    """The packed edge axis (B, 1, E) with per-edge layers, as the
    rasterizer benchmark compacts it: compact_env_soa (lane-split) and
    compact_env_seg, whose per-layer counts come from a one-hot of the
    layers; two and three lane blocks."""
    b, nl, e, h, t = 4, 3, 40, 48, 2
    segs = soa_segments(7, b, 1, e, h, w)
    lay = np.sort(np.random.default_rng(8).integers(0, nl, e)).astype(np.int32)
    p0, p1 = points(*segs[:4])
    want = rp.compact_env_soa(jnp.asarray(p0), jnp.asarray(p1),
                              jnp.asarray(segs[4]), 50, 16, h, t,
                              edge_layer=jnp.asarray(lay), n_layers=nl, w=w)
    got = rk.compact_env_soa(torch.from_numpy(p0), torch.from_numpy(p1),
                             torch.from_numpy(segs[4]), 50, 16, h, t,
                             edge_layer=torch.from_numpy(lay), n_layers=nl,
                             w=w)
    assert_soa_equal(got, want, t, inv_at=4)
    want = rp.compact_env_seg(*(jnp.asarray(x) for x in segs), 12, 8, h, t,
                              edge_layer=jnp.asarray(lay), n_layers=nl, w=w)
    got = rk.compact_env_seg(*(torch.from_numpy(x) for x in segs), 12, 8, h, t,
                             edge_layer=torch.from_numpy(lay), n_layers=nl,
                             w=w)
    assert_soa_equal(got, want, t, inv_at=5)
    assert got[-1][3].sum() > 0  # 12 slots per env: oversubscribed


@pytest.fixture(scope="module")
def layer_poses():
    """bench.py's config at 64x160 in float32 and float64, 8 reset states
    of the JAX package with numpy-seeded offsets in position and yaw
    (some cameras look across the near plane)."""
    out = {}
    for dtype in ("float32", "float64"):
        cfg = bench_config((64, 160))
        jp = jenv.make_env_params(cfg, dtype=getattr(jnp, dtype))
        vstate, _ = jax.jit(partial(jvec.reset, jp, n_envs=8, render=False))(
            jax.random.key(0))
        rng = np.random.default_rng(3)
        car = vstate.env.car
        car = car.replace(
            position=car.position + jnp.asarray(rng.normal(0, 0.03, (8, 2)),
                                                car.position.dtype),
            rotation=car.rotation + jnp.asarray(rng.normal(0, 0.4, 8),
                                                car.rotation.dtype),
        )
        out[dtype] = (cfg, jp, car)
    return out


def jax_project_layers(jp, car, resolution):
    """The JAX package's per-layer projection, as
    benchmarks/rasterize_bench.py:66-81 runs it: (B, L, E, 2) x2 and
    (B, L, E)."""
    md = jp.map_data

    @jax.jit
    def project(position, rotation):
        body = jax.vmap(jcam.car_world_to_body_matrix)(position, rotation)
        pose = jnp.einsum("ij,bjk->bik", jp.camera.E, body)
        return jax.vmap(lambda m: jax.vmap(
            lambda n, e, msk: jcam.project_layer(
                n, e, msk, m, jp.camera.K, resolution,
                jp.cfg.camera.max_range))(
            md.laneline_nodes, md.laneline_edges, md.laneline_edge_mask))(pose)

    return [np.asarray(x) for x in project(car.position, car.rotation)]


def port_project_layers(pp, car, resolution):
    position = torch.from_numpy(np.array(car.position))
    rotation = torch.from_numpy(np.array(car.rotation))
    pose = torch.matmul(pp.camera.E,
                        pcam.car_world_to_body_matrix(position, rotation))
    md = pp.map_data
    return pcam.project_layer(
        md.laneline_nodes, md.laneline_edges, md.laneline_edge_mask,
        pose[:, None], pp.camera.K, resolution, pp.cfg.camera.max_range)


def _layer_depths(jp, car):
    """Camera-frame depth z of both endpoints of every padded layer edge,
    before clipping, in float64: (B, L, E) each (z < 0 in front)."""
    body = np.asarray(jax.vmap(jcam.car_world_to_body_matrix)(
        car.position, car.rotation), np.float64)
    pose = np.einsum("ij,bjk->bik", np.asarray(jp.camera.E, np.float64), body)
    nodes = np.asarray(jp.map_data.laneline_nodes, np.float64)  # (L, N, 2)
    edges = np.asarray(jp.map_data.laneline_edges)  # (L, E, 2)
    z = []
    for i in (0, 1):
        x = np.take_along_axis(nodes[..., 0], edges[..., i], -1)
        y = np.take_along_axis(nodes[..., 1], edges[..., i], -1)
        z.append(pose[:, 2, 0, None, None] * x + pose[:, 2, 1, None, None] * y
                 + pose[:, 2, 3, None, None])
    return z


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_project_layer(layer_poses, dtype):
    """Equal draw masks; endpoints within the tolerances of the module's
    docstring."""
    cfg, jp, car = layer_poses[dtype]
    res = (64, 160)
    pp = convert.env_params_from_numpy(to_numpy_tree(jp), cfg, device="cpu")
    want = jax_project_layers(jp, car, res)
    got = [x.numpy() for x in port_project_layers(pp, car, res)]
    assert got[0].dtype == want[0].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got[2], want[2])
    assert want[2].any()
    eps = np.finfo(dtype).eps
    front_tol = FRONT_TOL * eps / np.finfo(np.float32).eps
    z0, z1 = _layer_depths(jp, car)
    near0, near1 = (z0 >= 0) & (z1 < 0), (z0 < 0) & (z1 >= 0)
    assert near0.any() and near1.any()
    near_tol = eps * (np.abs(z0) + np.abs(z1)) / 1e-7
    for g, w, z, near in ((got[0], want[0], z0, near0),
                          (got[1], want[1], z1, near1)):
        for c, size in ((0, res[1]), (1, res[0])):
            diff = np.abs(g[..., c] - w[..., c])
            front = z < 0
            err = diff / ((np.abs(w[..., c]) + size)
                          * np.maximum(1.0, 0.1 / np.abs(z)))
            assert err[front].max() <= front_tol, err[front].max()
            assert np.all(diff[near] <= near_tol[near] * np.abs(w[..., c])[near])


def test_point_views_stack_the_soa(layer_poses):
    """`env._project_packed_batch` is the SoA projection stacked into
    points, as the JAX package's."""
    cfg, jp, car = layer_poses["float64"]
    pp = convert.env_params_from_numpy(to_numpy_tree(jp), cfg, device="cpu")
    pcs = pcar.car_reset(pp.map_data, pp.cfg.car, torch.zeros(8, dtype=torch.long))
    pcs.position = torch.from_numpy(np.array(car.position))
    pcs.rotation = torch.from_numpy(np.array(car.rotation))
    state = penv.EnvState(car=pcs)
    u0, v0, u1, v1, draw = penv._project_packed_batch_soa(pp, state)
    p0, p1, pdraw = penv._project_packed_batch(pp, state)
    assert torch.equal(p0, torch.stack([u0, v0], -1))
    assert torch.equal(p1, torch.stack([u1, v1], -1)) and torch.equal(pdraw,
                                                                        draw)
    want = jenv._project_packed_batch(jp, jenv.EnvState(car=car, key=None))
    for g, w in zip((p0, p1, pdraw), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
