"""The port's headline bench (tinycarlo_torch.benchmarks.bench) against
bench.py, the JAX package's.

The bench body (`make_body`) on the CPU at B = 8 in float64 with line
thickness 1, where the port's masks equal the JAX package's bit for bit,
against the same body built from the JAX package's public functions as
bench.py:78-103 builds it, from one state over 10 steps, with the JAX
package's respawn rows injected into the port (the two random streams
differ): checksums equal, car states and infos within 1e-9 (torch's and
XLA's libm differ in the last bits, see test_torch_car.py). Then the
bench's copy of bench.py's CONFIG and its JSON line's keys, and the bench
run eagerly on the CPU.

The CUDA graph (capture, replay against eager steps) needs the card:
tests/test_torch_cuda.py and chip_smoke.py.
"""
import ast
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from tests.test_torch_common import REPO, port_tree, to_numpy_tree
from tests.test_torch_slice import _assert_close, _respawn_rows
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.benchmarks import bench as pbench
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.train.stanley import stanley_steering as j_stanley

B, STEPS = 8, 10


def _config(thickness):
    cfg = dict(pbench.CONFIG)
    cfg["camera"] = dict(cfg["camera"], line_thickness=thickness)
    return cfg


def _jax_body(params, n, max_episode_steps):
    """bench.py's body (bench.py:78-103) with a uint32 checksum."""
    max_steer = params.cfg.car.max_steering_angle

    def body(vstate, info, checksum):
        obs = jenv.render_observation_batch(params, vstate.env)
        checksum = checksum + jnp.sum(obs[..., 60:64, :], dtype=jnp.uint32)
        steering = jnp.clip(j_stanley(info["cte"], info["heading_error"],
                                      pbench.SPEED, pbench.K, max_steer),
                            -1.0, 1.0)
        action = {
            "car_control": jnp.stack(
                [jnp.full((n,), pbench.SPEED, jnp.float32),
                 steering.astype(jnp.float32)], axis=-1),
            "maneuver": jnp.zeros((n,), jnp.int32),
        }
        vstate, _, _, _, _, info = jvec.step(
            params, vstate, action, render=False,
            max_episode_steps=max_episode_steps)
        return vstate, info, checksum

    return jax.jit(body)


@pytest.mark.parametrize("max_episode_steps", [pbench.MAX_EPISODE_STEPS, 4])
def test_bench_body_matches_jax(max_episode_steps):
    """bench.py's max_episode_steps (no respawn in 10 steps) and 4, where
    every env respawns twice at the injected rows."""
    jp = jenv.make_env_params(_config(1), dtype=jnp.float64)
    pp = penv.make_env_params(_config(1), dtype=torch.float64, device="cpu")
    jvs, _ = jax.jit(partial(jvec.reset, jp, n_envs=B, render=False))(
        jax.random.key(5))
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    jinfo = jax.jit(jax.vmap(partial(jenv._info, jp)))(jvs.env)
    pinfo = penv._info(pp, pvs.env)
    jbody = _jax_body(jp, B, max_episode_steps)
    pbody = pbench.make_body(pp, B, max_episode_steps)
    jsum = jnp.zeros((), jnp.uint32)
    psum = torch.zeros((), dtype=torch.int64)
    respawns = 0
    for t in range(STEPS):
        rows = _respawn_rows(jvs.env.key, jp.map_data.spawns.count)
        jvs, jinfo, jsum = jbody(jvs, jinfo, jsum)
        pvs, pinfo, psum, obs, _ = pbody(pvs, pinfo, psum,
                                         respawn_rows=torch.from_numpy(rows))
        assert obs.shape == (B, 5, 128, 160) and obs.dtype == torch.uint8
        assert int(psum) == int(jsum), f"checksum at step {t}"
        state = port_tree(pvs)
        _assert_close(state["env"], to_numpy_tree(jvs.env), f"state at {t}")
        _assert_close(state["episode_step"], jvs.episode_step, f"step {t}")
        _assert_close(pinfo, jinfo, f"info at {t}")
        respawns += int((np.asarray(jvs.episode_step) == 0).sum())
    assert int(psum) > 0
    assert respawns == (2 * B if max_episode_steps == 4 else 0)


def test_bench_config_is_bench_py_config():
    assert pbench.CONFIG == jbench.CONFIG
    assert (pbench.N_ENVS, pbench.CHUNK, pbench.SPEED, pbench.K) == (
        jbench.N_ENVS, jbench.CHUNK, jbench.SPEED, jbench.K)
    assert pbench.REPEATS == max(jbench.REPEATS, 5)
    assert pbench.RECORDED_REFERENCE_SPS == jbench.RECORDED_REFERENCE_SPS


def _bench_py_keys():
    """The keys of the dict bench.py's main prints (bench.py:204-223)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Dict))
    return {k.value for k in line.keys}


def test_bench_runs_eagerly_on_cpu():
    """`measure(device="cpu")` at 8 envs, 2-step chunks: no graph, at least
    5 repeats, a checksum > 0, and a JSON line with bench.py's keys plus
    `device`, flagged as the recorded baseline."""
    r = pbench.measure("cpu", n_envs=8, chunk=2, repeats=1)
    assert r["graph"] is None and r["checksum"] > 0
    assert len(r["rates"]) == 5 and r["min"] <= r["median"] <= r["max"]
    line = pbench.result_line(r, 8, 1, "cpu")
    assert set(line) == _bench_py_keys() | {"device"}
    assert line["baseline_measured_live"] is False
    assert line["baseline_reference_steps_per_s"] == 132.8
    assert line["repeats"] == 5 and line["n_envs"] == 8
    assert line["vs_baseline"] == round(r["median"] / 132.8, 2)


def test_bench_main_runs_on_the_card_only():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        pbench.main([])
