"""tinycarlo_torch.camera against tinycarlo_tpu.camera in float32.

The matrices agree to rtol 1e-6 (torch's and XLA's sin/cos/tan may differ
in the last bit). Given the JAX package's matrices, the packed projection
of the same car poses is bit-identical in float64; in float32 it agrees to
within float32 rounding as the perspective divide conditions it (see
test_packed_projection), and the draw mask is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import bench_config, to_numpy_tree
from tinycarlo_torch import camera as pcam
from tinycarlo_torch import car as pcar
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_tpu import camera as jcam
from tinycarlo_tpu import car as jcar
from tinycarlo_tpu import env as jenv

RTOL = 1e-6
# float32 projection: endpoints in front of the camera, relative to
# (|u| + frame size) * max(1, 0.1 m / |z|), and endpoints clipped onto the
# near plane, relative to |u| (see test_packed_projection).
FRONT_TOL = 2e-6
NEAR_RTOL = 2e-4


def _poses(md_count, b, seed):
    """Spawn rows plus numpy-seeded offsets in position and yaw."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, md_count, b).astype(np.int32)
    dpos = rng.normal(0, 0.03, (b, 2))
    dyaw = rng.normal(0, 0.4, b)
    return rows, dpos, dyaw


@pytest.mark.parametrize("fov,orientation", [(80, [22, 0, 0]),
                                             (100, [15, 3, -7])])
def test_camera_matrices(fov, orientation):
    cfg = bench_config()
    cfg["camera"] = dict(cfg["camera"], fov=fov, orientation=orientation)
    jp = jenv.make_env_params(cfg)
    pp = penv.make_env_params(cfg, device="cpu")
    for name in ("E", "K"):
        got = getattr(pp.camera, name).numpy()
        want = np.asarray(getattr(jp.camera, name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def _depths(jp, jcs):
    """Camera-frame depth z of both endpoints of every packed edge, before
    clipping, in float64: (B, Ep) each. In front of the camera is z < 0."""
    body = np.asarray(jax.vmap(jcam.car_world_to_body_matrix)(
        jcs.position, jcs.rotation), np.float64)
    pose = np.einsum("ij,bjk->bik", np.asarray(jp.camera.E, np.float64), body)
    pn = np.asarray(jp.map_data.packed_nodes[0], np.float64)
    pe = np.asarray(jp.map_data.packed_edges[0])
    return [
        pose[:, 2, 0, None] * pn[pe[:, i], 0]
        + pose[:, 2, 1, None] * pn[pe[:, i], 1] + pose[:, 2, 3, None]
        for i in (0, 1)
    ]


def _stacked_projection(cam, p, car_state, body, matmul):
    """The packed edge axis through `cam.project_layers_batch`, its
    stacked endpoints split back into (B, Ep) u0, v0, u1, v1 and draw."""
    md = p.map_data
    pose = matmul(p.camera.E, body(car_state.position, car_state.rotation))
    p0, p1, draw = cam.project_layers_batch(
        md.packed_nodes, md.packed_edges, md.packed_edge_mask, pose,
        p.camera.K, tuple(p.cfg.camera.resolution), p.cfg.camera.max_range)
    assert p0.shape == p1.shape == (*draw.shape, 2)
    return (p0[:, 0, :, 0], p0[:, 0, :, 1], p1[:, 0, :, 0], p1[:, 0, :, 1],
            draw[:, 0])


@pytest.mark.parametrize("resolution,dtype,stacked", [
    pytest.param((128, 160), "float32", False, id="resolution0-float32"),
    pytest.param((64, 48), "float32", False, id="resolution1-float32"),
    pytest.param((128, 160), "float64", False, id="resolution2-float64"),
    pytest.param((128, 160), "float32", True, id="stacked-float32"),
    pytest.param((128, 160), "float64", True, id="stacked-float64"),
])
def test_packed_projection(resolution, dtype, stacked):
    """`stacked`: the same projection through `project_layers_batch`, the
    (B, L, E, 2) point form, under the same rule. float64: bit-identical. float32: XLA contracts the pose products
    into fused multiply-adds where torch rounds each product, so the
    camera-frame coordinates differ in the last bit, and the perspective
    divide amplifies that by 1/|z|. Endpoints in front of the camera must
    agree to FRONT_TOL = 2e-6 * (|u| + frame size) * max(1, 0.1 m / |z|)
    (measured <= 1.3e-6); endpoints clipped onto the near plane z = -1e-7
    to rtol NEAR_RTOL = 2e-4 (measured <= 4.2e-5); endpoints behind the
    camera on both ends are never drawn. The draw mask is equal."""
    cfg = bench_config(resolution)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jenv.make_env_params(cfg, dtype=jdt)
    pp = convert.env_params_from_numpy(to_numpy_tree(jp), cfg, device="cpu")
    md = jp.map_data
    rows, dpos, dyaw = _poses(md.spawns.count, 32, seed=resolution[0])
    jcs = jax.vmap(lambda r: jcar.car_reset(md, jp.cfg.car, r))(
        jnp.asarray(rows)
    )
    jcs = jcs.replace(
        position=jcs.position + jnp.asarray(dpos, jdt),
        rotation=jcs.rotation + jnp.asarray(dyaw, jdt),
    )
    pcs = pcar.car_reset(pp.map_data, pp.cfg.car, torch.from_numpy(rows))
    pcs.position = torch.from_numpy(np.array(jcs.position))
    pcs.rotation = torch.from_numpy(np.array(jcs.rotation))
    if stacked:
        want = _stacked_projection(
            jcam, jp, jcs, jax.vmap(jcam.car_world_to_body_matrix),
            lambda e, b: jnp.einsum("ij,bjk->bik", e, b))
        got = _stacked_projection(pcam, pp, pcs,
                                  pcam.car_world_to_body_matrix, torch.matmul)
    else:
        want = jenv._project_packed_batch_soa(
            jp, jenv.EnvState(car=jcs, key=None))
        got = penv._project_packed_batch_soa(pp, penv.EnvState(car=pcs))
    z0, z1 = _depths(jp, jcs)
    near0, near1 = (z0 >= 0) & (z1 < 0), (z0 < 0) & (z1 >= 0)
    h, w = resolution
    for name, g, want_c, z, near, size in zip(
        ("u0", "v0", "u1", "v1"), got[:4], want[:4], (z0, z0, z1, z1),
        (near0, near0, near1, near1), (w, h, w, h),
    ):
        g, want_c = g.numpy(), np.asarray(want_c)
        assert g.dtype == want_c.dtype == np.dtype(dtype)
        if dtype == "float64":
            np.testing.assert_array_equal(g, want_c, err_msg=name)
            continue
        front = z < 0
        err = np.abs(g - want_c) / (
            (np.abs(want_c) + size) * np.maximum(1.0, 0.1 / np.abs(z))
        )
        assert err[front].max() <= FRONT_TOL, (name, err[front].max())
        np.testing.assert_allclose(g[near], want_c[near], rtol=NEAR_RTOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].any() and near0.any()


def test_world_to_body_matches():
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 2, (16, 2)).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    want = np.asarray(jax.vmap(jcam.car_world_to_body_matrix)(pos, rot))
    got = pcam.car_world_to_body_matrix(
        torch.from_numpy(pos), torch.from_numpy(rot)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
