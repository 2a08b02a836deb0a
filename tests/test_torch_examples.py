"""The port's examples (tinycarlo_torch.examples.<name>.main) in-process on
the CPU at a tiny size: each runs to its end and returns what it measured;
render_map's PNG equals the JAX package's `render_static_overview` of the
same config bit for bit. The examples run on examples/config_simple_layout
.yaml (rgb 128x160), as by default.
"""
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinycarlo_torch.examples import (benchmark_tinycar_net, random_control,
                                      render_map, stanley_control, train_td3)
from tinycarlo_torch.examples._common import default_config
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu.viz import render_static_overview


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as in test_torch_gym.py: B = 1 steps beside
    JAX's thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_td3_without_matplotlib(tmp_path, monkeypatch, capsys):
    """4 envs, one 5-step chunk, a 5-step evaluation of one maneuver, with
    matplotlib blocked: the CSVs are written, the plot is skipped and
    said so."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setenv("IL_MODEL", str(tmp_path / "absent.npz"))
    out = train_td3.main([
        "--envs", "4", "--chunks", "1", "--steps", "5", "--replay", "64",
        "--out", str(tmp_path), "--eval-steps", "5", "--eval-episodes", "2",
        "--eval-maneuvers", "1", "--device", "cpu"])
    assert len(out["env_steps_per_s"]) == 1 and out["plot"] is None
    printed = capsys.readouterr().out
    assert "skipped the plot" in printed
    assert out["encoder"] == "pretrained" and "loaded pretrained" in printed
    assert len(out["chunk_seconds"]) == len(out["rewards"]) == 1
    assert out["filled"] == [20] and out["peak_memory"]["end"]["host_gb"] > 0
    assert out["wall_s"] >= out["train_wall_s"] > 0
    assert np.isfinite(out["eval"][0]["cte_avg"])
    for name in ("critic_loss", "actor_loss", "rew", "cte",
                 "actor_weight_changes"):
        assert (tmp_path / f"{name}_without_shift.csv").exists(), name


def test_time_to_policy_on_the_jax_curve():
    """The JAX package's 1024-env run (docs/training_artifacts/td3_1024/
    rew_without_shift.csv) reached 300 a episode first in chunk 132; its
    20-chunk means and last-20 mean, as docs/TRAINING.md reads them."""
    from tinycarlo_torch.benchmarks import learning_curve

    rewards = learning_curve.rewards(os.path.join(
        os.path.dirname(__file__), "..", "docs", "training_artifacts",
        "td3_1024", "rew_without_shift.csv"))
    assert train_td3.time_to_policy(rewards, [0.5] * 200) == (132, 66.0)
    assert train_td3.time_to_policy(rewards[:131], [1.0] * 131) == (None,
                                                                    None)
    r = learning_curve.summary(rewards)
    assert r["chunks"] == 200 and r["first_chunk_at_policy"] == 132
    assert [round(m, 1) for m in r["window_means"]] == [
        24.6, 31.7, 53.3, 70.9, 104.5, 155.1, 225.3, 282.4, 360.2, 459.0]
    assert round(r["last_window_mean"], 1) == 459.0
    assert round(r["max"], 1) == 683.7


@pytest.mark.parametrize("argv", [["--steps", "5"],
                                  ["--batch", "8", "--steps", "5"]])
def test_stanley_control(argv):
    out = stanley_control.main(argv + ["--device", "cpu"])
    rate = out.get("steps_per_s", out.get("env_steps_per_s"))
    assert rate > 0
    if "--batch" in argv:
        assert out["mean_abs_cte"] < 0.05


def test_random_control():
    out = random_control.main(["--steps", "5", "--device", "cpu"])
    assert out["steps"] == 5 and out["steps_per_s"] > 0


@pytest.mark.parametrize("nodes", [False, True])
def test_render_map_matches_jax(tmp_path, nodes):
    png = str(tmp_path / "map.png")
    argv = ["--out", png, "--device", "cpu"] + (["--nodes"] if nodes else [])
    out = render_map.main(argv)
    jp = jenv.make_env_params(default_config(), dtype=jnp.float32)
    want = render_static_overview(jp, jp.cfg.sim.overview_pixel_per_meter,
                                  render_node_names=nodes)
    got = cv2.imread(png)
    assert out["path"] == png and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_benchmark_tinycar_net(tmp_path):
    out = benchmark_tinycar_net.main([
        "--steps", "10", "--maneuvers", "1", "--traces", str(tmp_path),
        "--device", "cpu"])
    r = out["eval"][0]
    assert np.isfinite(r["cte_avg"]) and r["positions"].shape == (50, 2)
    assert os.path.exists(tmp_path / "positions_m0.npy")
