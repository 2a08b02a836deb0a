"""The import guard: nothing a run loads may be JAX, its libraries, the JAX
package or the JAX-era scripts, compared by whole top-level names."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run as harness

DRIVERS = sorted(f[:-3] for f in os.listdir(os.path.join(harness.PB,
                                                         "drivers"))
                 if f.endswith(".py") and not f.startswith("_"))

PROBE = """
import importlib, json, os, sys
sys.path.insert(0, {root!r})
from portbench import run as harness
harness.load_module(os.path.join(harness.PB, "drivers", {driver!r} + ".py"),
                    "driver")
for f in sorted(os.listdir(os.path.join(harness.PB, "layer_metrics"))):
    if f.endswith(".py"):
        harness.load_module(os.path.join(harness.PB, "layer_metrics", f),
                            "m_" + f[:-3].replace(".", "_"))
importlib.import_module("portbench.tools.readings")
print(json.dumps(sorted(sys.modules)))
"""


def test_whole_top_level_names():
    mods = ["tinycarlo_torch", "tinycarlo_torch.benchmarks.bench",
            "portbench.run", "jaxtyping", "examples_x", "benchmarks_y"]
    assert harness.forbidden_loaded(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "optax",
           "orbax.checkpoint", "tinycarlo_tpu", "tinycarlo_tpu.env",
           "benchmarks.step_decomp", "bench", "examples.train_td3"]
    assert harness.forbidden_loaded(bad) == sorted(bad)


@pytest.mark.parametrize("driver", DRIVERS)
def test_driver_loads_nothing_forbidden(driver):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=harness.ROOT,
                                            driver=driver)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=harness.ROOT, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tinycarlo_torch" in loaded
    assert harness.forbidden_loaded(loaded) == []


def test_no_card_exits_without_a_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "simple_layout.gym-rgb-1", "--seed",
                       "2147483659", "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""
