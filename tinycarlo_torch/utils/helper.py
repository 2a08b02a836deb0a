"""Small scalar/angle helpers, the port's device policy, and the card's
name and peaks for the benchmarks' bounds.

Semantics mirror the reference helpers (reference: tinycarlo/helper.py:4-24)
as batched torch ops; counterpart of tinycarlo_tpu/utils/helper.py.
"""
from __future__ import annotations

import dataclasses
import math
import os
import subprocess

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# int32 rate: 132 SMs x 64 INT32 lanes per SM per clock (half the float32
# lanes; NVIDIA's Hopper architecture white paper) x 1.98 GHz boost.
PEAK_I32_PER_S = 132 * 64 * 1.98e9
# float32 instruction rate: 132 SMs x 128 FP32 lanes x 1.98 GHz, one
# multiply or one add a lane a clock. PEAK_F32_PER_S counts a fused
# multiply-add as two operations; work whose multiply and add are rounded
# apart (built with -fmad=false) issues each as an instruction of its own.
PEAK_F32_INSTR_PER_S = 132 * 128 * 1.98e9


def getenv(key: str) -> bool:
    """True iff the environment variable is set to "1".

    Reference: tinycarlo/helper.py:4-9.
    """
    v = os.environ.get(key)
    return v is not None and v.lower() == "1"


def clip_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to the [-pi, pi] interval.

    Two sequential conditional corrections per direction, exactly as
    tinycarlo_tpu.utils.helper.clip_angle (exact for |a| <= 5*pi, which
    covers every angle the simulation produces), so the reference's
    while-loop semantics hold bit for bit: +pi and -pi are fixed points.
    """
    for _ in range(2):
        a = torch.where(a > math.pi, a - TWO_PI, a)
    for _ in range(2):
        a = torch.where(a < -math.pi, a + TWO_PI, a)
    return a


def angle(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Angle of the vector (x, y) in radians. Reference: tinycarlo/helper.py:21-24."""
    return torch.atan2(y, x)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default everywhere)
    requires a GPU and raises without one: the port never carries on on
    the CPU unless the caller asks for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tinycarlo_torch: a CUDA device was requested but torch sees no "
            "GPU; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch floating dtype (host-side map building)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def to_device(obj, device):
    """Recursively move a dataclass of numpy arrays / tensors to `device`
    as tensors (numpy dtypes kept: float64 stays float64, int32 stays
    int32). Non-array fields (static ints, tuples, names) pass through."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{
                f.name: to_device(getattr(obj, f.name), device)
                for f in dataclasses.fields(obj)
                if f.init
            },
        )
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


def bound(n_bytes: int, n_ops: int, peak_ops: float = PEAK_F32_PER_S
          ) -> tuple:
    """(least ms on the H100, "bytes" or "operations", the bytes' ms, the
    operations' ms) of work that moves n_bytes and does n_ops operations
    at peak_ops a second: the larger of the two times binds."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    return _smi("name,power.limit")


def card_clocks() -> str:
    """nvidia-smi's SM clock, memory clock, power draw and temperature of
    the card, as it reads them now."""
    return _smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
