"""Training observability: CSV writers, moving averages, plot helpers.

Counterpart of tinycarlo_tpu/train/logging.py, which mirrors the
reference's logging surface (reference: examples/rl_utils.py:59-114 and
examples/domain_randomization/vis_utils.py:9-48) without its hardcoded
user paths: every writer takes an explicit output directory. The CSVs are
the JAX package's byte for byte; `snapshot_params` keys a torch net by
its flax paths. matplotlib is imported only by `plot_series`.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Optional, Sequence


def avg_w(x: Sequence[float], w: int = 100) -> float:
    """Mean of the trailing window; inf until the window fills
    (reference rl_utils.py:108-111)."""
    if len(x) < w:
        return float("inf")
    return sum(x[-w:]) / w


def ma(x: Sequence[float], w: int = 100) -> List[float]:
    """Simple moving average (reference rl_utils.py:113-114)."""
    return [sum(x[i : i + w]) / w for i in range(len(x) - w)]


def write_csv(
    path: str, header: Sequence[str], rows: Iterable[Sequence]
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def save_losses(
    out_dir: str,
    c1_loss: Sequence[float],
    c2_loss: Sequence[float],
    a_loss: Sequence[float],
    suffix: str = "",
) -> None:
    """Critic/actor loss CSVs (reference rl_utils.py:59-99)."""
    sfx = f"_{suffix}" if suffix else ""
    write_csv(
        os.path.join(out_dir, f"critic_loss{sfx}.csv"),
        ["Step", "Critic 1 Loss", "Critic 2 Loss"],
        list(zip(range(1, len(c1_loss) + 1), c1_loss, c2_loss)),
    )
    write_csv(
        os.path.join(out_dir, f"actor_loss{sfx}.csv"),
        ["Step", "Loss"],
        list(enumerate(a_loss, start=1)),
    )


def save_rewards(
    out_dir: str, ep_rews: Sequence[float], suffix: str = ""
) -> None:
    sfx = f"_{suffix}" if suffix else ""
    write_csv(
        os.path.join(out_dir, f"rew{sfx}.csv"),
        ["Episode", "Reward"],
        list(enumerate(ep_rews, start=1)),
    )


def save_series(
    out_dir: str, name: str, values: Sequence[float], suffix: str = ""
) -> None:
    """Generic per-step series (CTE, laneline distances -- reference
    vis_utils.py:9-32)."""
    sfx = f"_{suffix}" if suffix else ""
    write_csv(
        os.path.join(out_dir, f"{name}{sfx}.csv"),
        ["Step", name],
        list(enumerate(values, start=1)),
    )


def weight_changes(
    history: Dict[int, Dict[str, "np.ndarray"]],
) -> Dict[str, List[float]]:
    """Per-layer mean |delta| between consecutive snapshots (reference
    vis_utils.py calculate_weight_changes)."""
    import numpy as np

    steps = sorted(history)
    out: Dict[str, List[float]] = {}
    for prev, cur in zip(steps, steps[1:]):
        for name, w in history[cur].items():
            d = float(np.abs(w - history[prev][name]).mean())
            out.setdefault(name, []).append(d)
    return out


def save_weight_changes(
    out_dir: str,
    net_name: str,
    changes: Dict[str, List[float]],
    step_interval: int = 1,
    suffix: str = "",
) -> None:
    """Long-format per-layer weight-change CSV, the schema the reference
    dashboard plots (pages/layout_utils.py:63-69: columns Step, Layer,
    Mean Absolute Weight Change, one line per (snapshot, layer))."""
    sfx = f"_{suffix}" if suffix else ""
    rows = []
    for layer, vals in changes.items():
        for i, v in enumerate(vals, start=1):
            rows.append((i * step_interval, layer, v))
    rows.sort(key=lambda r: (r[0], r[1]))
    write_csv(
        os.path.join(out_dir, f"{net_name}_weight_changes{sfx}.csv"),
        ["Step", "Layer", "Mean Absolute Weight Change"],
        rows,
    )


def snapshot_params(params, step: int, history: Dict[int, Dict[str, "np.ndarray"]]):
    """Record a flat {path: array} view of a net's parameters (the
    reference's save_weights, train_td3.py:151-153, every-200-steps
    tracking). `params` is a TinycarCombo or its state dict, keyed and laid
    out as its flax params (`convert.combo_state_dict_to_flax`), or a TD3
    actor or critic module, keyed by its flax paths
    (`convert.td3_param_paths`) -- the keys of the JAX package's
    snapshot of the same net, so the CSVs share its columns."""
    import numpy as np
    import torch

    from tinycarlo_torch import convert

    if isinstance(params, torch.nn.Module) and not hasattr(params,
                                                           "encoder"):
        paths = convert.td3_param_paths(params, hasattr(params, "temporal"))
        flat = {}
        for name, t in params.named_parameters():
            path, kind = paths[name]
            flat["/".join(path)] = convert._to_flax(
                t.detach().cpu().numpy(), kind)
    else:
        tree = convert.combo_state_dict_to_flax(params)["params"]
        flat = convert.flat_paths(tree)
    history[step] = {k: np.asarray(v) for k, v in flat.items()}


def plot_series(
    out_path: str,
    series: Dict[str, Sequence[float]],
    xlabel: str = "Step",
    ylabel: str = "Value",
    window: Optional[int] = None,
) -> None:
    """Matplotlib PNG of one or more series (reference rl_utils.py:59-99)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    for name, values in series.items():
        v = ma(list(values), window) if window else list(values)
        plt.plot(v, label=name)
    if len(series) > 1:
        plt.legend()
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path)
    plt.close()
