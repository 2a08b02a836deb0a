"""The H100's published peaks and the least-time rule, the yardstick's own
copy (frozen from tinycarlo_torch/utils/helper.py at commit 6c117b9), and
the card's name and power limit.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
"""
from __future__ import annotations

import subprocess

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores, an FMA as 2
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12


def least_s(n_bytes: float, n_ops: float = 0.0,
            peak_ops: float = PEAK_F32_PER_S) -> float:
    """The least seconds the card needs to move `n_bytes` and do `n_ops`
    operations at `peak_ops` a second: the larger of the two times."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops)


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
