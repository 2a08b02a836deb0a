"""The port's measurement scripts other than the configs and the step
decomposition (tinycarlo_torch.benchmarks profile_step, profile_td3,
exp_r4_rgb, exp_r3c, policy_parity) against the JAX package's scripts in
benchmarks/.

- exp_r4_rgb: the composite frames of every composite probe equal bit for
  bit to the script's `jnp` expression (exp_r4_rgb.py:77-87, with its
  reshapes), at B = 2 and counters that wrap; the byte counts and
  constants the script's.
- profile_step.aggregate on a synthetic event list (names cut to 60
  characters and merged, the threshold, the rest, records a step) and on
  a CPU torch.profiler trace of known operators.
- Each module's `run(device="cpu")` (or `our_eval`, `main` on the CPU for
  policy_parity) at a tiny size: its JSON keys; and every entry point
  raising without a GPU.
- The copies of the scripts' configs and constants, read with `ast`.
"""
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import REPO
from tests.test_torch_decomp import script_globals
from tinycarlo_torch.benchmarks import exp_r3c, exp_r4_rgb
from tinycarlo_torch.benchmarks import policy_parity, profile_step
from tinycarlo_torch.benchmarks import profile_td3
from tinycarlo_torch.models.tinycar_net import load_pretrained
from tinycarlo_torch.train import td3

SCRIPTS = os.path.join(REPO, "benchmarks")


def _script(name):
    return os.path.join(SCRIPTS, name)


def _script_palette():
    """exp_r4_rgb.py's PALETTE literal."""
    with open(_script("exp_r4_rgb.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "PALETTE")
    return ast.literal_eval(node.value.args[0])


def _jax_comp(i, n, planar, palette):
    """exp_r4_rgb.py:77-87 at n envs."""
    shape = (n, exp_r4_rgb.H, exp_r4_rgb.W)
    rank = jax.lax.rem(jax.lax.broadcasted_iota(jnp.uint8, shape, 2) + i,
                       jnp.uint8(6))
    frame = jnp.zeros(shape + (3,), jnp.uint8)
    for layer in range(5):
        frame = jnp.where((rank == layer + 1)[..., None], palette[layer],
                          frame)
    return jnp.moveaxis(frame, -1, 1) if planar else frame


@pytest.mark.parametrize("i", [1, 7, 250])
def test_rgb_composites_match_the_scripts(i):
    """The composite probes' frames (comp-hwc, comp-planar, comp-flat3,
    comp-flat3r) against the script's expressions, bit for bit."""
    n = 2
    palette = jnp.asarray(_script_palette(), jnp.uint8)
    hwc = np.asarray(_jax_comp(jnp.uint8(i), n, False, palette))
    planar = np.asarray(_jax_comp(jnp.uint8(i), n, True, palette))
    flat3 = hwc.reshape(n, exp_r4_rgb.H, exp_r4_rgb.W * 3)
    want = {"comp-hwc": hwc, "comp-planar": planar, "comp-flat3": flat3,
            "comp-flat3r": flat3.reshape(hwc.shape)}
    probes = {p[0]: p for p in exp_r4_rgb.probes(n, torch.device("cpu"))}
    ti = torch.tensor(i, dtype=torch.uint8)
    for name, frame in want.items():
        _, shape, fn, _, _ = probes[name]
        got = fn(ti)
        assert tuple(got.shape) == shape == frame.shape, name
        np.testing.assert_array_equal(got.numpy(), frame, err_msg=name)


def test_rgb_probes_are_the_scripts():
    script = script_globals(_script("exp_r4_rgb.py"))
    for name in ("N_ENVS", "CHUNK", "H", "W"):
        assert getattr(exp_r4_rgb, name) == script[name], name
    assert exp_r4_rgb.PALETTE == tuple(map(tuple, _script_palette()))
    n, h, w = 4, exp_r4_rgb.H, exp_r4_rgb.W
    nbytes = {p[0]: p[3] for p in exp_r4_rgb.probes(n, torch.device("cpu"))}
    assert list(nbytes) == list(exp_r4_rgb.PROBES)
    hwc, rank = n * h * w * 3, n * h * w
    assert nbytes == {"fill-hwc": hwc, "fill-planar": hwc,
                      "fill-rank": rank, "comp-hwc": hwc + rank,
                      "comp-planar": hwc + rank, "fill-flat3": hwc,
                      "comp-flat3": hwc + rank, "comp-flat3r": hwc + rank}


def test_rgb_run_on_cpu():
    r = exp_r4_rgb.run("cpu", n_envs=2, chunk=2, repeats=1)
    assert set(r) == {"metric", "n_envs", "chunk", "probes", "device"}
    assert [p["name"] for p in r["probes"]] == list(exp_r4_rgb.PROBES)
    for p in r["probes"]:
        assert set(p) == {"name", "ms", "gb_s", "all", "checksum"}
        assert p["checksum"] > 0
    # the frame of i, then i + 1, from i = 1: a warm and a timed repeat of
    # 2 steps end on the fill of 4 (2 envs x 2 rows x 160 x 3 bytes)
    fill = {p["name"]: p["checksum"] for p in r["probes"]}
    assert fill["fill-hwc"] == 4 * 2 * 160 * 3 * 2


def test_aggregate_synthetic_events():
    long_a = "k" * 60 + "_variant_a"
    long_b = "k" * 60 + "_variant_b"
    events = [(long_a, 300.0, 10), (long_b, 100.0, 10),
              ("small", 40.0, 20), ("mid", 600.0, 10)]
    # the two long names merge into one 60-character key, 0.04 ms a step:
    # under a 0.05 ms threshold, over a 0.03 ms one
    agg = profile_step.aggregate(events, steps=10, threshold=0.05)
    assert [r[1] for r in agg["rows"]] == ["mid"]
    assert agg["other_ms"] == pytest.approx(0.044)
    agg = profile_step.aggregate(events, steps=10, threshold=0.03)
    assert [r[1] for r in agg["rows"]] == ["mid", "k" * 60]
    assert agg["rows"][1] == (pytest.approx(0.04), "k" * 60, 2.0)
    assert agg["other_ms"] == pytest.approx(0.004)
    assert agg["total_ms"] == pytest.approx(0.104)
    assert agg["records"] == 5.0
    assert profile_step.records_of(events, "variant") == 20


def test_aggregate_cpu_trace():
    """A CPU trace of 3 steps of known operators: every matmul's record
    counted, the total the operators' self time."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            y = x @ x
            y = torch.relu(y) + 1.0
    events = profile_step.kernel_events(prof, cuda=False)
    agg = profile_step.aggregate(events, steps=3, threshold=0.0)
    names = [r[1] for r in agg["rows"]]
    assert "aten::mm" in names and "aten::relu" in names
    assert profile_step.records_of(events, "aten::mm") == 3
    self_us = sum(e.self_cpu_time_total for e in prof.key_averages())
    assert agg["total_ms"] == pytest.approx(self_us / 1e3 / 3)
    assert agg["other_ms"] == pytest.approx(0.0, abs=1e-9)


def test_profile_step_run_on_cpu():
    r = profile_step.run("cpu", n_envs=4, steps=2, resolution=(64, 80))
    assert set(r) == {"metric", "n_envs", "steps", "threshold_ms",
                      "kernels", "other_ms", "busy_ms_per_step",
                      "records_per_step", "render_kernel",
                      "render_kernel_records_per_step", "wall_ms_per_step",
                      "idle_share", "device"}
    assert r["device"] == "cpu" and r["idle_share"] is None
    assert r["kernels"] and r["render_kernel"] == "masks"
    assert json.loads(json.dumps(r)) == r
    script = script_globals(_script("profile_step.py"))
    assert (profile_step.N_ENVS, profile_step.STEPS) == (
        script["N_ENVS"], script["STEPS"])


def test_profile_td3_run_on_cpu():
    """A warm chunk, a traced one, an eager one and two under the tracer
    (the graphs' stage split) of 2 steps at 4 envs, 64x80, a 64-slot
    replay and batch 8 (updates from the second step): the keys, the
    stages of td3_loop.STAGES that ran, both ways, and the script's
    constants."""
    import dataclasses

    cfg = dataclasses.replace(td3.TD3Config(), batch_size=8)
    r = profile_td3.run("cpu", n_envs=4, steps=2, warm_chunks=0,
                        replay_size=64, resolution=(64, 80), cfg=cfg)
    assert set(r) == {"metric", "n_envs", "steps", "obs_dtype",
                      "threshold_ms", "kernels", "other_ms",
                      "busy_ms_per_step", "env_steps_per_s_device",
                      "records_per_step", "render_kernel_records_per_step",
                      "wall_ms_per_step", "idle_share", "stages_ms_eager",
                      "stages_ms_graph",
                      "eager_busy_ms_per_step", "eager_records_per_step",
                      "eager_top_kernels", "buffer_filled", "device"}
    assert r["env_steps_per_s_device"] is None and r["device"] == "cpu"
    assert r["obs_dtype"] == "uint8" and r["buffer_filled"] == 4 * 2 * 5
    stages = r["stages_ms_eager"]
    assert {"td3.policy", "td3.env_step", "td3.encoder", "td3.replay_add",
            "td3.update", "vector.render", "other"} <= set(stages)
    assert all(v >= 0 for k, v in stages.items() if k != "other")
    graph_stages = r["stages_ms_graph"]
    assert set(graph_stages) == set(stages) - {"other"}
    assert all(v >= 0 for v in graph_stages.values())
    script = script_globals(_script("profile_td3.py"))
    assert (profile_td3.N_ENVS, profile_td3.STEPS) == (
        script["N_ENVS"], script["STEPS"])


def test_exp_r3c_run_on_cpu():
    r = exp_r3c.run("cpu", n_envs=2, chunk=2, resolution=(64, 80))
    assert set(r) == {"metric", "n_envs", "chunk", "unroll", "fill",
                      "device"}
    assert [u["unroll"] for u in r["unroll"]] == [1, 2, 4]
    for u in r["unroll"]:
        assert set(u) == {"unroll", "ms_step", "env_steps_per_s",
                          "launches"}
    assert [f["name"] for f in r["fill"]] == [
        "uint8 fill_ (carried)", "uint8 iota+i (carried)",
        "float32 fill_ (carried)", "uint8 fill_ (constant)",
        "float32 fill_ (constant)"]
    with pytest.raises(ValueError, match="not ported"):
        exp_r3c.run("cpu", probes=("geom",))


def test_exp_r3c_config_is_the_scripts():
    with open(_script("exp_r3c.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_config")
    want = eval(compile(ast.Expression(fn.body[0].value), "exp_r3c.py",
                        "eval"), {"os": os, "REPO": REPO})
    assert exp_r3c.config() == want
    script = script_globals(_script("exp_r3c.py"))
    assert (exp_r3c.N_ENVS, exp_r3c.CHUNK) == (script["N_ENVS"],
                                               script["CHUNK"])


def test_policy_parity_our_eval_on_cpu(capsys, monkeypatch):
    """`our_eval` through evaluate on the CPU (2 sequential episodes of 3
    steps), and `main` on the CPU printing one line a maneuver, with the
    reference absent."""
    model = load_pretrained((3, 128, 160), device="cpu")
    stats = {}
    r = policy_parity.our_eval(model, 1, 3, 2, device="cpu", stats=stats)
    assert {"cte_avg", "cte_var", "heading_error_avg", "heading_error_var",
            "terminations", "total_reward"} <= set(r)
    assert "positions" not in r and np.isfinite(r["cte_avg"])
    assert policy_parity.config("exact")["camera"]["stroke"] == "exact"
    monkeypatch.setattr(policy_parity, "REFERENCE", "")
    capsys.readouterr()
    assert policy_parity.main(["--steps", "2", "--episodes", "1",
                               "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["maneuver"] for x in lines] == [0, 1, 2]
    assert all(x["reference"] is None for x in lines)


@pytest.mark.parametrize("module", [profile_step, profile_td3, exp_r4_rgb,
                                    exp_r3c, policy_parity])
def test_measurement_mains_run_on_the_card_only(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
