"""The exact stroke's render route of tinycarlo_torch: the whole route
against the port's dense exact rasterizer and its cv2 host oracle, and an
env rollout whose classes and rgb frames equal the JAX package's.

Tolerance: none. In float64 every frame is equal bit for bit (at t >= 2
the exact stroke leaves no boundary allowance). Segment generators and
the float32 rules are in tests/test_torch_exact.py (which also holds the
dense rasterizer and the host oracle against cv2.polylines); the exact
kernel's plain version against the Pallas kernel in
tests/test_torch_exact_kernel.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_common import bench_config, port_tree, to_numpy_tree
from tests.test_torch_exact import exact_segments
from tests.test_torch_slice import _respawn_rows
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.ops import rasterize as pras
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.ops.cv2_stroke import thick_stroke_mask_ref
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.train.stanley import stanley_steering as j_stanley


def test_exact_packed_matches_dense():
    """The port's whole exact route on the CPU (compaction at the full
    budget, then the plain version) equals its dense exact rasterizer and
    the host oracle drawn segment by segment on the truncated endpoints,
    layer by layer, bit for bit in float64 (t = 3, the lane split). The
    dense rasterizer of the JAX package is held against the port's through
    the rollout below."""
    t, h, w, L, B, E = 3, 48, 160, 3, 4, 16
    u0, v0, u1, v1, draw, lay = exact_segments(50 + t, B, E, h, w, L)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x[:, 0]))  # noqa
    got = rk.rasterize_masks_packed_soa(
        f(u0), f(v0), f(u1), f(v1), f(draw), torch.from_numpy(lay), L,
        (h, w), t, stroke="exact",
    )
    onehot = lay[None, :] == np.arange(L)[:, None]
    for b in range(B):
        p0 = np.broadcast_to(np.stack([u0[b, 0], v0[b, 0]], -1), (L, E, 2))
        p1 = np.broadcast_to(np.stack([u1[b, 0], v1[b, 0]], -1), (L, E, 2))
        dr = draw[b, 0][None] & onehot
        dense = pras.rasterize_masks(
            torch.from_numpy(p0.copy()), torch.from_numpy(p1.copy()),
            torch.from_numpy(dr), (h, w), t, stroke="exact",
        ).numpy()
        np.testing.assert_array_equal(got[b].numpy(), dense)
        a, c = (x.long().numpy() for x in pras._int_endpoints(
            torch.from_numpy(p0[0].copy()), torch.from_numpy(p1[0].copy()),
            torch.float64))
        for l in range(L):
            want = np.zeros((h, w), bool)
            for e in np.flatnonzero(dr[l]):
                want |= thick_stroke_mask_ref(a[e], c[e], t, (h, w))
            np.testing.assert_array_equal(dense[l] > 0, want,
                                          err_msg=f"env {b}, layer {l}")
    assert got.numpy().sum() > 0


SPEED, K = 0.5, 5.0


def test_exact_slice_rollout_matches_jax():
    """bench.py's config at 48x160 with camera.stroke: exact, B = 8 envs,
    6 steps of Stanley control with auto-reset at 3 steps (the JAX
    package's respawn rows injected), float64: every classes frame equal
    to the JAX package's render_observation_batch bit for bit (JAX renders
    the exact stroke through its dense tiled rasterizer on the CPU, the
    port through its compaction and the exact kernel's plain version), and
    every rgb frame -- the port's rgb_from_rank(rank_from_masks(masks)) --
    equal to the JAX package's masks composite of those frames
    (env.py:317-319). Positions within 1e-9 (test_torch_slice.py)."""
    B, steps, max_steps = 8, 6, 3
    cfg = bench_config((48, 160))
    cfg["camera"] = dict(cfg["camera"], stroke="exact")
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    jvs, _ = jax.jit(partial(jvec.reset, jp, n_envs=B, render=False))(
        jax.random.key(5))
    jstep = jax.jit(partial(jvec.step, jp, max_episode_steps=max_steps))
    jinfo = jax.jit(jax.vmap(partial(jenv._info, jp)))(jvs.env)
    jrgb = jax.jit(jax.vmap(
        lambda m: jenv._masks_to_obs(jp, m, (None, None, None), "rgb")))
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    assert int(penv.check_segment_overflow(pp, pvs.env).sum()) == 0
    max_steer = jp.cfg.car.max_steering_angle
    resets = 0
    for i in range(steps):
        steer = np.asarray(jnp.clip(j_stanley(
            jinfo["cte"], jinfo["heading_error"], SPEED, K, max_steer),
            -1.0, 1.0))
        control = np.stack([np.full(B, SPEED), steer], -1)
        maneuver = np.zeros(B, np.int32)
        rows = _respawn_rows(jvs.env.key, jp.map_data.spawns.count)
        jvs, jobs, _, jterm, jtrunc, jinfo = jstep(
            jvs, {"car_control": jnp.asarray(control),
                  "maneuver": jnp.asarray(maneuver)})
        pvs, pobs, *_ = pvec.step(
            pp, pvs, {"car_control": torch.from_numpy(control),
                      "maneuver": torch.from_numpy(maneuver)},
            max_episode_steps=max_steps, respawn_rows=torch.from_numpy(rows),
        )
        np.testing.assert_allclose(
            port_tree(pvs)["env"]["car"]["position"],
            np.asarray(jvs.env.car.position), rtol=0, atol=1e-9)
        assert pobs.dtype == torch.uint8 and pobs.shape == jobs.shape
        np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs),
                                      err_msg=f"classes at step {i}")
        rgb = penv.render_observation_batch(pp, pvs.env, fmt="rgb")
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb(jobs)),
                                      err_msg=f"rgb at step {i}")
        resets += int(np.asarray(jterm | jtrunc).sum())
    # the float32 0/1 masks carry the same pixels
    pobs_f = penv.render_observation_batch(pp, pvs.env,
                                           out_dtype=torch.float32)
    assert torch.equal(pobs_f, (pobs > 0).float())
    assert resets >= B and pobs.numpy().sum() > 0
