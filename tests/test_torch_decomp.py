"""The step decomposition (tinycarlo_torch.benchmarks.step_decomp) against
benchmarks/step_decomp.py, the JAX package's.

- The raw values behind the `proj` and `comp` checksums at B = 8 in
  float64, from one state: the port's packed projection equal bit for bit
  to the JAX package's `_project_packed_batch`, and its bundle at the
  script's budget equal to the JAX package's `compact_env_idx_soa` (the
  port's one fast-stroke compaction; gran 16) on those coordinates under
  tests/test_torch_compaction.py's rule (`inv` may be XLA's contracted
  value for segments past 4096 px). The JAX projection runs op by op
  (jitted, XLA contracts float64 products into fused multiply-adds, as
  test_torch_camera.py notes); its compaction is compiled once for the
  module.
- The port's copy of the script's config and constants, read with `ast`.
- `run(device="cpu")` at 4 envs and 64x80 in every mode: its JSON keys,
  the `car` checksum in every later mode's (each mode adds its stage to
  the same step), and the stages by difference.
"""
import ast
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import REPO, to_numpy_tree
from tests.test_torch_compaction import assert_bundles_equal
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.benchmarks import step_decomp as psd
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.ops import rasterize_pallas as rp

B = 8
SCRIPT = os.path.join(REPO, "benchmarks", "step_decomp.py")


def script_globals(path):
    """The script's module-level constants that evaluate without JAX."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {"os": os, "REPO": REPO}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            try:
                value = eval(compile(ast.Expression(node.value), path,
                                     "eval"), names)
            except NameError:
                continue
            for target in node.targets:
                if isinstance(target, ast.Tuple):
                    names.update(zip((t.id for t in target.elts), value))
                else:
                    names[target.id] = value
    return names


@pytest.fixture(scope="module")
def jax_decomp():
    """The JAX package's params (the script's config, float64), a state of
    B envs, its projection and its compiled compaction."""
    jp = jenv.make_env_params(psd.CONFIG, dtype=jnp.float64)
    jvs, _ = jax.jit(partial(jvec.reset, jp, n_envs=B, render=False))(
        jax.random.key(7))
    md = jp.map_data
    # op by op: jitted, XLA contracts float64 products into fused
    # multiply-adds (test_torch_camera.py compares op by op too)
    project = partial(jenv._project_packed_batch, jp)
    compact = jax.jit(partial(
        rp.compact_env_idx_soa, k=psd.budget(jp), gran=16, h=psd.H,
        thickness=psd.THICK, n_layers=md.n_layers, w=psd.W))
    return jp, jvs, project, compact


def test_proj_and_comp_values_match_jax(jax_decomp):
    jp, jvs, project, compact = jax_decomp
    pp = penv.make_env_params(psd.CONFIG, dtype=torch.float64, device="cpu")
    pvs = convert.vec_state_from_numpy(to_numpy_tree(jvs), device="cpu")
    assert psd.budget(pp) == psd.budget(jp) == min(
        psd.MAXVIS * 2, jp.map_data.packed_edges.shape[-2] * 2)
    p0, p1, draw = psd.stage_values(pp, pvs.env, "proj")
    j0, j1, jdraw = (np.asarray(x) for x in project(jvs.env))
    assert p0.dtype == torch.float64
    np.testing.assert_array_equal(p0.numpy(), j0)
    np.testing.assert_array_equal(p1.numpy(), j1)
    np.testing.assert_array_equal(draw.numpy(), jdraw)
    assert draw.any()

    got = [x.numpy() for x in psd.stage_values(pp, pvs.env, "comp")]
    want = compact(*(jnp.asarray(x)[:, None] for x in (
        j0[..., 0], j0[..., 1], j1[..., 0], j1[..., 1], jdraw)),
        edge_layer=jp.map_data.packed_edge_layer)
    assert_bundles_equal(got, [np.asarray(x) for x in want],
                         psd.CONFIG["camera"]["line_thickness"])


def test_config_is_the_scripts():
    script = script_globals(SCRIPT)
    assert psd.CONFIG == script["CONFIG"]
    for name in ("N_ENVS", "ITERS", "H", "W", "THICK", "GRAN", "MAXVIS",
                 "SPEED", "K"):
        assert getattr(psd, name) == script[name], name


@pytest.fixture(scope="module")
def cpu_run():
    cfg = dict(psd.CONFIG, camera=dict(psd.CONFIG["camera"],
                                       resolution=[64, 80]))
    return psd.run("cpu", modes=psd.MODES, n_envs=4, iters=2, repeats=2,
                   config=cfg)


def test_run_on_cpu_gives_the_lines_keys(cpu_run):
    assert set(cpu_run) == {"metric", "n_envs", "iters", "modes",
                            "stages_ms", "device"}
    assert cpu_run["device"] == "cpu"
    assert [r["mode"] for r in cpu_run["modes"]] == list(psd.MODES)
    for r in cpu_run["modes"]:
        assert set(r) == {"mode", "ms", "all", "checksum"}
        assert len(r["all"]) == 2 and r["ms"] > 0
    assert set(cpu_run["stages_ms"]) == {
        "car_step", "car_info", "step_rest", "projection", "compaction",
        "kernel_and_frame_checksum"}


@pytest.mark.parametrize("mode", ["proj", "comp", "full", "bench"])
def test_later_modes_add_to_the_car_checksum(cpu_run, mode):
    """Every mode past `car` runs the same vector.step from the same
    inputs and adds its stage's sum, so its checksum is at least `car`'s,
    and the rendering modes' masks add more than nothing."""
    sums = {r["mode"]: r["checksum"] for r in cpu_run["modes"]}
    assert sums[mode] >= sums["car"]
    if mode in psd.RENDERING:
        assert sums[mode] > sums["car"]


def test_default_modes_are_the_scripts():
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    default = next(n for n in ast.walk(main) if isinstance(n, ast.List)
                   and all(isinstance(e, ast.Constant) for e in n.elts))
    assert tuple(e.value for e in default.elts) == psd.DEFAULT_MODES


def test_step_decomp_main_runs_on_the_card_only():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        psd.main([])


def test_unknown_mode_raises():
    pp = penv.make_env_params(psd.CONFIG, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        psd.make_step(pp, "geom", 4)
