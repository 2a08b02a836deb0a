"""BASELINE configs on the port (tinycarlo_torch.benchmarks.baseline_configs)
against benchmarks/baseline_configs.py, the JAX package's.

(a) Config 3's body against the script's (baseline_configs.py:114-135),
built from the JAX package's public functions: knuffingen, B = 8, float64,
line thickness 1 (where the two packages' masks are equal bit for bit),
10 steps from one state, the JAX package's respawn rows injected into the
port. One cut: the frame is 120x160 instead of 480x640, with the checksum
band (rows 238:242 of 480) scaled to rows 59:60 of 120. Checksums equal
(the JAX package sums in uint32, which wraps: the port's int64 is taken
modulo 2^32), car states and infos within 1e-9 (torch's and XLA's libm
differ in the last bits, test_torch_car.py), maneuvers cycling through
u-turn entries. F3's near-plane case (ROADMAP §3) does not show on these
states: the checksums are equal. The overflow count at the reset states
of the uncut config (512 envs, 480x640, float32) equals the JAX
package's, env by env. One JAX body is compiled per module and shared.

(b) The port's copies of the scripts' configs and constants, read from
the scripts with `ast` (no script is imported: they import JAX at the top
or run on import).

(c) `measure3(device="cpu")` at a tiny size, the config-3 JSON line's
keys (the script's and `device`), `config1`'s line shape, and every
entry point raising without a GPU.
"""
import ast
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import REPO, port_tree, to_numpy_tree
from tests.test_torch_slice import _assert_close, _respawn_rows
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.benchmarks import baseline_configs as pbc
from tinycarlo_torch.benchmarks import gym_bench
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec

B, STEPS, RES = 8, 10, (120, 160)
SCRIPT = os.path.join(REPO, "benchmarks", "baseline_configs.py")


def _script_function(name):
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def script_cfg(name, **names):
    """The `cfg = {...}` dict of the script's function `name`, evaluated
    with `names` bound (REPO and os given)."""
    fn = _script_function(name)
    node = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "cfg"
                and isinstance(n.value, ast.Dict))
    return eval(compile(ast.Expression(node), SCRIPT, "eval"),
                {"os": os, "REPO": REPO, **names})


def script_env_defaults(name):
    """{variable: default} of the script function's
    os.environ.get(VAR, default) calls."""
    out = {}
    for n in ast.walk(_script_function(name)):
        if (isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "get"
                and len(n.args) == 2
                and isinstance(n.args[0], ast.Constant)
                and isinstance(n.args[1], ast.Constant)):
            out[n.args[0].value] = n.args[1].value
    return out


def script_line_keys(name):
    """The keys of the dict the script's function prints."""
    fn = _script_function(name)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "dumps")
    return {k.value for k in call.args[0].keys}


def _jax_body(params, n, band):
    """baseline_configs.py:114-135, one step."""
    lo, hi = band

    def body(vstate, checksum, i):
        obs = jenv.render_observation_batch(params, vstate.env)
        checksum = checksum + jnp.sum(obs[..., lo:hi, :], dtype=jnp.uint32)
        man = jnp.mod(i + jnp.arange(n, dtype=jnp.int32), 4).astype(jnp.int32)
        action = {
            "car_control": jnp.tile(
                jnp.asarray([0.5, 0.05], jnp.float32), (n, 1)),
            "maneuver": man,
        }
        vstate, _, _, _, _, _ = jvec.step(
            params, vstate, action, render=False, max_episode_steps=1000)
        return vstate, checksum

    return jax.jit(body)


@pytest.fixture(scope="module")
def jax_config3():
    """The JAX package's config-3 params (120x160, t = 1, float64), its
    compiled body and its compiled batched info."""
    cfg = pbc.config3_dict("classes")
    cfg["camera"] = dict(cfg["camera"], resolution=list(RES),
                         line_thickness=1)
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    return (jp, _jax_body(jp, B, pbc.band_rows(RES[0])),
            jax.jit(jax.vmap(partial(jenv._info, jp))))


def test_config3_body_matches_jax(jax_config3):
    jp, jbody, jinfo = jax_config3
    pp = pbc.make_params3("cpu", "classes", RES, thickness=1,
                          dtype=torch.float64)
    jvs, _ = jax.jit(partial(jvec.reset, jp, n_envs=B, render=False))(
        jax.random.key(3))
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    pbody = pbc.make_body3(pp, B)
    jsum = jnp.zeros((), jnp.uint32)
    psum = torch.zeros((), dtype=torch.int64)
    pi = torch.zeros((), dtype=torch.int32)
    entries = 0
    for t in range(STEPS):
        man = (t + np.arange(B)) % 4
        entries += int(((man == 2)
                        & (np.asarray(jvs.env.car.last_maneuver) != 2)).sum())
        rows = _respawn_rows(jvs.env.key, jp.map_data.spawns.count)
        jvs, jsum = jbody(jvs, jsum, jnp.int32(t))
        pvs, psum, pi, obs = pbody(pvs, psum, pi,
                                   respawn_rows=torch.from_numpy(rows))
        assert obs.shape == (B, 5, *RES) and obs.dtype == torch.uint8
        assert int(pi) == t + 1
        assert int(psum) % 2 ** 32 == int(jsum), f"checksum at step {t}"
        state = port_tree(pvs)
        _assert_close(state["env"], to_numpy_tree(jvs.env), f"state at {t}")
        _assert_close(state["episode_step"], jvs.episode_step, f"step {t}")
        _assert_close(penv._info(pp, pvs.env), jinfo(jvs.env),
                      f"info at {t}")
    assert int(psum) > 0
    assert entries > 0  # the schedule entered u-turns


def test_config3_overflow_at_reset_matches_jax():
    """The uncut config's reset states (512 envs, 480x640, t = 2,
    float32): the port's per-env dropped copies equal the JAX
    package's."""
    cfg = pbc.config3_dict("classes")
    jp = jenv.make_env_params(cfg)
    pp = pbc.make_params3("cpu", "classes")
    jvs, _ = jax.jit(partial(jvec.reset, jp, n_envs=pbc.N_ENVS3,
                             render=False))(jax.random.key(0))
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    want = np.asarray(jax.jit(partial(jenv.check_segment_overflow, jp))(
        jvs.env))
    got = penv.check_segment_overflow(pp, pvs.env).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["classes", "rank"])
def test_config3_copy_is_the_scripts(fmt):
    assert pbc.config3_dict(fmt) == script_cfg("config3", fmt3=fmt)
    env = script_env_defaults("config3")
    assert (pbc.N_ENVS3, pbc.CHUNK3, pbc.FORMAT3) == (
        int(env["BENCH_ENVS3"]), int(env["BENCH_CHUNK3"]),
        env["BENCH_OBS_FORMAT3"])


def test_config1_and_config4_copies_are_the_scripts():
    assert gym_bench.CONFIG1 == script_cfg("config1")
    assert script_env_defaults("config4") == pbc.CONFIG4_ENV


@pytest.mark.parametrize("fmt", ["classes", "rank"])
def test_measure3_runs_eagerly_on_cpu(fmt):
    """`measure3(device="cpu")` at 4 envs, 2-step chunks and 120x160: no
    graph, 5 timed chunks, a checksum > 0, and the script's JSON keys plus
    `device`."""
    r = pbc.measure3("cpu", n_envs=4, chunk=2, fmt=fmt, resolution=RES)
    assert r["graph"] is None and r["checksum"] > 0
    assert len(r["rates"]) == 5 and r["min"] <= r["median"] <= r["max"]
    assert int(r["state"][2]) == 2  # the index restarted with the chunk
    line = pbc.line3(r, 4, fmt, "cpu")
    assert set(line) == script_line_keys("config3") | {"device"}
    assert line["max_visible_overflow_at_reset"] == r["overflow"] == 0
    assert fmt in line["metric"]


def test_config1_line_shape(monkeypatch):
    """config1's line: the script's keys and `device`, `reference` null
    without the reference checkout (the shim run stubbed: it needs the
    card)."""
    monkeypatch.setattr(gym_bench, "measure",
                        lambda name, mode, steps: {"steps_per_s": 12.34})
    monkeypatch.setattr(pbc, "REFERENCE", "")
    monkeypatch.setattr(pbc, "card_line", lambda: "cpu")
    line = pbc.config1(steps=2)
    assert set(line) == script_line_keys("config1") | {"device"}
    assert line["ours"] == 12.3 and line["reference"] is None


@pytest.mark.parametrize("which", ["1", "3", "4"])
def test_baseline_main_runs_on_the_card_only(which):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        pbc.main([which])
