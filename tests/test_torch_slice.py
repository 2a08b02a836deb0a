"""The port's main path end to end against the JAX package: bench.py's
config at 64x160, B = 8 envs, 40 steps of Stanley control with
max_episode_steps=15 so that in-graph auto-reset fires, in float64.

Both packages start from the same state (carried across with
tinycarlo_torch.convert) and get the same actions, computed from the JAX
package's info. The JAX package's respawn rows are derived in the test
from its PRNG keys and injected into the port as `respawn_rows`.

Tolerances: observations by the stroke-boundary rule of
tests/test_rasterize_pallas.py:84-122, evaluated in float64 (the JAX
package renders through its tiled float64 rasterizer on the CPU, the port
through the masks kernel's float32 plain version, see _boundary_pixel);
rewards, infos and car states to 1e-9 absolute
(torch's and XLA's libm differ in the last bits, see test_torch_car.py);
terminated, truncated and discrete state equal.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_common import bench_config, port_tree, to_numpy_tree
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch import vector as pvec
from tinycarlo_torch.train.stanley import stanley_steering as p_stanley
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.ops import rasterize as jras
from tinycarlo_tpu.train.stanley import stanley_steering as j_stanley

B, STEPS, MAX_STEPS, ATOL = 8, 40, 15, 1e-9
SPEED, K = 0.5, 5.0


def _respawn_rows(keys, count):
    """The spawn rows jvec.step's auto-reset draws from these per-env keys
    (vector.py:132-133 -> env.reset, env.py:356-358)."""
    def one(k):
        sub = jax.random.split(jax.random.split(k)[1])[1]
        return jax.random.randint(sub, (), 0, count)

    return np.asarray(jax.vmap(one)(keys)).astype(np.int64)


def _assert_close(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _assert_close(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{what}[{i}]")
        return
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _boundary_pixel(x, y, a, b, thickness):
    """The rule of `_assert_equal_up_to_stroke_boundary` for one pixel,
    evaluated in float64 from the integer endpoints a, b (n, 2): is it on a
    stroke radius or on the body/cap seam of some segment? The tolerances
    are the rule's (1e-3 on d2, 1e-5 on tu) widened by the float32
    rounding of the stamp at the segment's coordinate scale S, 2^-20 * S:
    near-plane clipped segments reach |coord| = 1e6 px, where float32
    resolves d2 only to ~0.1 (the rule's own float32 arithmetic cannot
    classify those pixels at all)."""
    lat, cap = (np.float64(r) for r in jras._split_radii(thickness))
    lat2, cap2 = lat * lat, cap * cap
    abx, aby = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    apx, apy = x - a[:, 0], y - a[:, 1]
    denom = np.maximum(abx * abx + aby * aby, 1.0)
    tu = (apx * abx + apy * aby) / denom
    tc = np.clip(tu, 0.0, 1.0)
    d2 = (apx - tc * abx) ** 2 + (apy - tc * aby) ** 2
    scale = np.max(np.abs(np.concatenate([a, b], 1)), axis=1) + max(x, y)
    tol = 1e-3 + scale * 2.0 ** -20
    tol_t = 1e-5 + 2.0 ** -20
    on_radius = (np.abs(d2 - lat2) < tol) | (np.abs(d2 - cap2) < tol)
    seam = ((np.minimum(np.abs(tu), np.abs(tu - 1.0)) < tol_t)
            & (d2 >= cap2 - tol) & (d2 <= lat2 + tol))
    return bool(np.any(on_radius | seam))


def _assert_obs(got, want, jp, jproject, jstate):
    """(B, L, H, W) observations: equal except on stroke-boundary pixels
    (at t >= 2), and those fewer than 0.5% of the pixels."""
    t = jp.cfg.camera.line_thickness
    p0, p1, draw = (np.asarray(x) for x in jproject(jstate))
    lay = np.asarray(jp.map_data.packed_edge_layer)
    diff = np.argwhere(got != want)
    assert t > 1 or len(diff) == 0, diff[:5]
    assert len(diff) < got.size * 0.005
    for b, l, y, x in diff:
        m = draw[b] & (lay == l)
        a = np.trunc(np.clip(p0[b][m], -1e6, 1e6))
        c = np.trunc(np.clip(p1[b][m], -1e6, 1e6))
        assert _boundary_pixel(float(x), float(y), a, c, t), (
            f"non-boundary pixel differs at env {b}, {(l, y, x)}"
        )


def test_slice_rollout_matches_jax():
    cfg = bench_config((64, 160))
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    jvs, jobs = jax.jit(partial(jvec.reset, jp, n_envs=B))(jax.random.key(3))
    jproject = jax.jit(partial(jenv._project_packed_batch, jp))
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")

    pobs = penv.render_observation_batch(pp, pvs.env)
    _assert_obs(pobs.numpy(), np.asarray(jobs), jp, jproject, jvs.env)
    # float32 0/1 masks (the in-graph feature dtype) carry the same pixels
    pobs_f = penv.render_observation_batch(pp, pvs.env,
                                           out_dtype=torch.float32)
    assert pobs_f.dtype == torch.float32
    assert torch.equal(pobs_f, (pobs > 0).float())
    jstep = jax.jit(partial(jvec.step, jp, max_episode_steps=MAX_STEPS))
    jinfo = jax.jit(jax.vmap(partial(jenv._info, jp)))(jvs.env)
    pinfo = penv._info(pp, pvs.env)
    _assert_close(pinfo, jinfo, "info")
    max_steer = jp.cfg.car.max_steering_angle
    resets = 0
    for t in range(STEPS):
        steer = jnp.clip(j_stanley(jinfo["cte"], jinfo["heading_error"],
                                   SPEED, K, max_steer), -1.0, 1.0)
        psteer = torch.clamp(p_stanley(pinfo["cte"], pinfo["heading_error"],
                                       SPEED, K, max_steer), -1.0, 1.0)
        np.testing.assert_allclose(psteer.numpy(), np.asarray(steer),
                                   rtol=0, atol=ATOL)
        control = np.stack([np.full(B, SPEED), np.asarray(steer)], -1)
        maneuver = np.zeros(B, np.int32)
        rows = _respawn_rows(jvs.env.key, jp.map_data.spawns.count)

        jvs, jobs, jrew, jterm, jtrunc, jinfo = jstep(
            jvs, {"car_control": jnp.asarray(control),
                  "maneuver": jnp.asarray(maneuver)},
        )
        pvs, pobs, prew, pterm, ptrunc, pinfo = pvec.step(
            pp, pvs,
            {"car_control": torch.from_numpy(control),
             "maneuver": torch.from_numpy(maneuver)},
            max_episode_steps=MAX_STEPS, respawn_rows=torch.from_numpy(rows),
        )
        what = f"step {t}"
        np.testing.assert_array_equal(pterm.numpy(), np.asarray(jterm), what)
        np.testing.assert_array_equal(ptrunc.numpy(), np.asarray(jtrunc), what)
        _assert_close(prew, jrew, f"reward at {what}")
        _assert_close(pinfo, jinfo, f"info at {what}")
        state = port_tree(pvs)
        _assert_close(state["env"], to_numpy_tree(jvs.env), f"state at {what}")
        _assert_close(state["episode_step"], jvs.episode_step, what)
        assert pobs.dtype == torch.uint8 and pobs.shape == jobs.shape
        _assert_obs(pobs.numpy(), np.asarray(jobs), jp, jproject, jvs.env)
        resets += int(np.asarray(jterm | jtrunc).sum())
    assert resets >= B  # every env was respawned at least once
