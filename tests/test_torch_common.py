"""The PyTorch port (tinycarlo_torch) against the JAX package: shared
helpers, plus the port's packaging rules -- no JAX anywhere in it, the
device policy, and the copied config loader.

The port's parity tests live in tests/test_torch_*.py. They run on the CPU
with device="cpu": the same numpy-seeded inputs go through the JAX
function and its port, and each test states its tolerance.
"""
import dataclasses
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import SIMPLE_LAYOUT_MAP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's CONFIG (simple_layout, classes, t=2) with the map path
# resolved; tests shrink the resolution.
BENCH_CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {
        "wheelbase": 0.0487,
        "track_width": 0.027,
        "max_velocity": 0.15,
        "max_steering_angle": 30,
        "steering_speed": 30,
        "max_acceleration": 0.1,
        "max_deceleration": 1.0,
    },
    "camera": {
        "position": [0.0, -0.005, 0.04],
        "orientation": [22, 0, 0],
        "resolution": [128, 160],
        "fov": 80,
        "max_range": 0.5,
        "line_thickness": 2,
    },
    "map": {"json_path": SIMPLE_LAYOUT_MAP, "pixel_per_meter": 450},
}


def bench_config(resolution=(128, 160), thickness=2):
    cfg = dict(BENCH_CONFIG)
    cfg["camera"] = dict(
        BENCH_CONFIG["camera"], resolution=list(resolution),
        line_thickness=thickness,
    )
    return cfg


def to_numpy_tree(obj):
    """A JAX package dataclass (flax struct) as a nested dict of numpy
    arrays and static values -- the input format of tinycarlo_torch.convert.
    Config objects, None fields and PRNG keys (the port's respawn stream is
    a torch.Generator) are dropped."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None or f.name in ("cfg", "key"):
                continue
            out[f.name] = to_numpy_tree(v)
        return out
    if isinstance(obj, (tuple, list)):
        return [to_numpy_tree(x) for x in obj]
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return np.asarray(obj)
    return obj


def port_tree(obj):
    """The port's dataclass as the same nested dict of numpy arrays."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: port_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), torch.Generator)
        }
    if isinstance(obj, (tuple, list)):
        return [port_tree(x) for x in obj]
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    return obj


def assert_trees_equal(got, want, path="", skip=()):
    """Every array equal (values and dtype) and every static value equal;
    keys of `want` missing from `got` must be in `skip`."""
    if isinstance(want, dict):
        for k, v in want.items():
            if k in skip:
                continue
            assert k in got, f"{path}.{k} missing from the port"
            assert_trees_equal(got[k], v, f"{path}.{k}", skip)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    if isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]", skip)
        return
    assert got == want, (path, got, want)


def port_modules():
    import pkgutil

    import tinycarlo_torch

    return ["tinycarlo_torch"] + [
        m.name for m in pkgutil.walk_packages(
            tinycarlo_torch.__path__, "tinycarlo_torch."
        )
    ]


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax and tinycarlo_tpu
    blocked."""
    modules = port_modules()
    for name in ("models.tinycar_net", "train.evaluate", "ops.rasterize",
                 "ops.rasterize_kernels", "ops.cv2_stroke", "env",
                 "convert"):
        assert f"tinycarlo_torch.{name}" in modules
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'tinycarlo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_import_no_jax():
    """No source of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|tinycarlo_tpu)\b", re.MULTILINE
    )
    files = glob.glob(os.path.join(REPO, "tinycarlo_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_entry_points_default_to_cuda():
    """Entry points default to "cuda" and raise without a GPU instead of
    carrying on on the CPU."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import rasterize_bench
    from tinycarlo_torch.utils.helper import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fenv.make_env_params(bench_config())
        with pytest.raises(RuntimeError, match="CUDA"):
            rasterize_bench.main(["full"])


def _config_sources():
    import bench

    return sorted(glob.glob(os.path.join(REPO, "examples", "config_*.yaml"))) + [
        bench.CONFIG, BENCH_CONFIG
    ]


@pytest.mark.parametrize("index", range(5))
def test_config_fields_equal(index):
    """The port's copy of the config loader gives the same fields as the
    JAX package's for every example yaml and bench.py's CONFIG."""
    from tinycarlo_torch.config import load_config as port_load
    from tinycarlo_tpu.config import load_config as jax_load

    source = _config_sources()[index]
    jcfg, jpath = jax_load(source)
    pcfg, ppath = port_load(source)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert ppath == jpath


def test_config_sources_covered():
    assert len(_config_sources()) == 5
