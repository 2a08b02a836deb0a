"""Imitation learning from a Stanley expert with camera domain
randomization, on the port.

The port of examples/train_stanley_il.py: batched expert data collection
(pitch/fov randomized per chunk, reference train_stanley_il.py:53-57; OU
noise :66; every-2nd-frame sampling :68-74), an npz dataset cache
(`Xn`, `Mn`, `Yn`, :100-110), supervised MSE training of TinycarCombo
(:117-124) in chunks of 500 replayed steps, an optional DAgger round, and
per-maneuver evaluation (:139-142).

Usage: python -m tinycarlo_torch.examples.train_stanley_il [--samples 25000]
  [--steps 10000] [--envs 16] [--m2x N] [--chunk-steps 128] [--balance]
  [--no-dr] [--turn-weight W*100] [--dagger N [--dagger-steps M]]
and, beyond the JAX example's flags: [--config PATH] [--device cuda|cpu]
  [--batch 32] [--eval-steps 1000] [--eval-episodes 5]
($IL_DATA names the dataset cache and $IL_MODEL the model file, by
default in the temporary directory; $IL_LOSS_CSV, if set, the losses.)

Two faults of the JAX example are repaired here:
- its cache is reused whatever the collection flags (:82). This one
  records the flags that collected it and refuses a cache whose flags
  differ (or that records none): delete it, or name another --data.
- `--steps` / `--dagger-steps` below the 500-step chunk trained zero steps
  (:135). Here a step count is rounded up to whole chunks, and the
  rounding is printed.
The model is written in the JAX package's flat npz format
(`train.il.save_variables_npz`).
"""
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch.examples import _common as common
from tinycarlo_torch.examples._common import default_config
from tinycarlo_torch.train import evaluate as evaluate_mod
from tinycarlo_torch.train.evaluate import combo_policy
from tinycarlo_torch.train.il import (
    ILConfig,
    collect_dataset,
    collect_dataset_dagger,
    create,
    save_variables_npz,
    train_chunk,
)
from tinycarlo_torch.utils.helper import resolve_device

CHUNK = 500  # train steps per replayed chunk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def whole_chunks(n_steps: int, flag: str) -> int:
    """`n_steps` rounded up to whole chunks of CHUNK steps, the rounding
    printed."""
    n = CHUNK * math.ceil(n_steps / CHUNK)
    if n != n_steps:
        print(f"{flag} {n_steps}: training {n} steps (whole chunks of "
              f"{CHUNK})")
    return n


def load_cache(path: str, flags: Dict):
    """(X, M, Y) of a cache collected with `flags`; raises if it records
    other flags, or none."""
    with np.load(path) as data:
        recorded = (json.loads(str(data["flags"])) if "flags" in data.files
                    else None)
        if recorded != flags:
            raise ValueError(
                f"the dataset cache {path} was collected with {recorded}, "
                f"not {flags}: delete it or set IL_DATA to another file")
        return data["Xn"], data["Mn"], data["Yn"]


def make_data(X, M, Y, device, balance: bool):
    """The dataset on the device; with `balance`, per-maneuver index
    pools, repeat-padded to equal length (train.il.draw_indices)."""
    data = {
        "x": torch.from_numpy(np.ascontiguousarray(X)).to(device),
        "m": torch.from_numpy(np.asarray(M)).to(device, torch.int64),
        "y": torch.from_numpy(np.asarray(Y, np.float32)).to(device),
    }
    if balance:
        pools, pool_n = [], []
        mx = max((M == m).sum() for m in range(3))
        for m in range(3):
            ids = np.where(M == m)[0]
            pool_n.append(len(ids))
            pools.append(np.resize(ids, mx))
        data["pools"] = torch.tensor(np.stack(pools), dtype=torch.int32,
                                     device=device)
        data["pool_n"] = torch.tensor(pool_n, dtype=torch.int32,
                                      device=device)
        print(f"balanced batches; per-maneuver samples: {pool_n}")
    return data


def train(state, cfg, data, n_steps: int, generator,
          device) -> Tuple[List[float], Optional[float]]:
    """`n_steps` (whole chunks) of `train_chunk`; prints each chunk's mean
    loss and the steps/s so far. Returns the losses and the rate."""
    losses: List[float] = []
    _sync(device)
    st = time.perf_counter()
    rate = None
    for i in range(n_steps // CHUNK):
        state, chunk_losses = train_chunk(state, cfg, data, CHUNK,
                                          generator=generator)
        losses += chunk_losses.float().cpu().tolist()
        rate = (i + 1) * CHUNK / (time.perf_counter() - st)
        print(f"step {(i + 1) * CHUNK}/{n_steps} loss "
              f"{np.mean(losses[-CHUNK:]):.6f} ({rate:.0f} steps/s)")
    return losses, rate


def main(argv=None) -> Dict:
    """Run the example with `argv` (default sys.argv[1:]). Returns what it
    measured: samples, split (the samples per maneuver),
    collect_samples_per_s (None when the cache was read), losses,
    train_steps_per_s, dagger_samples, eval (per maneuver), the model's
    path and, on the card, peak_memory_gb (before the evaluation)."""
    argv = sys.argv[1:] if argv is None else list(argv)

    def arg(flag, default, cast=int):
        return common.arg(argv, flag, default, cast)

    device = resolve_device(arg("--device", "cuda", str))
    n_samples = arg("--samples", 25_000)
    n_envs = arg("--envs", 16)
    # --m2x N repeats the left maneuver N times per collection cycle
    cycle = (0, 1, 2) + (2,) * (arg("--m2x", 1) - 1)
    config = os.path.abspath(arg("--config", default_config(), str))
    params = fenv.make_env_params(config, device=device)
    cfg = ILConfig(steps=arg("--steps", 10_000),
                   turn_weight=arg("--turn-weight", 0) / 100.0,
                   camera_dr="--no-dr" not in argv,
                   batch_size=arg("--batch", 32))
    obs_shape = fenv.observation_shape(params)
    chunk_steps = arg("--chunk-steps", 128)
    tmp = tempfile.gettempdir()
    cache = os.environ.get(
        "IL_DATA", os.path.join(tmp, "stanley_training_data_torch.npz"))
    flags = {"config": config, "samples": n_samples, "envs": n_envs,
             "cycle": list(cycle), "chunk_steps": chunk_steps,
             "camera_dr": cfg.camera_dr, "seed": 0}
    out = {"collect_samples_per_s": None}
    if os.path.exists(cache):
        print(f"Loading training data from disk: {cache}")
        X, M, Y = load_cache(cache, flags)
    else:
        print("Collecting training data:")
        _sync(device)
        st = time.perf_counter()
        X, M, Y = collect_dataset(
            params, cfg, torch.Generator(device=device).manual_seed(0),
            n_samples, n_envs=n_envs, maneuver_cycle=cycle,
            chunk_steps=chunk_steps)
        secs = time.perf_counter() - st
        out["collect_samples_per_s"] = len(X) / secs
        print(f"collected {len(X)} samples in {secs:.1f}s "
              f"({len(X) / secs:,.0f} samples/s)")
        np.savez_compressed(cache, Xn=X, Mn=M, Yn=Y,
                            flags=json.dumps(flags))
    print(f"Training data: "
          f"{sum(a.size * a.itemsize for a in (X, M, Y)) / 1e9:.2f} GB | "
          f"type: {X.dtype} | shape: {X.shape}")
    out["samples"] = len(X)
    out["split"] = [int((M == m).sum()) for m in range(3)]

    state = create(obs_shape, cfg, seed=1, device=device)
    balance = "--balance" in argv
    print("Training:")
    losses, rate = train(
        state, cfg, make_data(X, M, Y, device, balance),
        whole_chunks(cfg.steps, "--steps"),
        torch.Generator(device=device).manual_seed(2), device)
    out["train_steps_per_s"] = rate

    # --dagger N: one DAgger round -- roll out the TRAINED policy, label
    # with the Stanley expert, and go on training on expert + correction
    # data
    dagger_n = arg("--dagger", 0)
    out["dagger_samples"] = 0
    if dagger_n:
        print(f"DAgger: collecting {dagger_n} policy-rollout samples")
        st = time.perf_counter()
        Xd, Md, Yd = collect_dataset_dagger(
            params, cfg, torch.Generator(device=device).manual_seed(3),
            dagger_n, state.model, n_envs=n_envs, maneuver_cycle=cycle,
            chunk_steps=chunk_steps)
        print(f"collected {len(Xd)} in {time.perf_counter() - st:.1f}s")
        out["dagger_samples"] = len(Xd)
        X = np.concatenate([X, Xd])
        M = np.concatenate([M, Md])
        Y = np.concatenate([Y, Yd])
        print("DAgger retraining:")
        more, _ = train(
            state, cfg, make_data(X, M, Y, device, balance),
            whole_chunks(arg("--dagger-steps", cfg.steps // 2),
                         "--dagger-steps"),
            torch.Generator(device=device).manual_seed(4), device)
        losses += more
    out["losses"] = losses

    path = os.environ.get(
        "IL_MODEL", os.path.join(tmp, "tinycar_combo_torch.npz"))
    save_variables_npz(path, state)
    out["model"] = path
    print(f"Saved model to: {path}")
    if os.environ.get("IL_LOSS_CSV"):
        import csv

        with open(os.environ["IL_LOSS_CSV"], "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "mse_loss"])
            w.writerows((i, float(v)) for i, v in enumerate(losses))

    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        print(f"peak device memory: {out['peak_memory_gb']:.2f} GB")
    print("Evaluating:")
    pol = combo_policy(state.model)
    out["eval"] = {}
    for maneuver in range(3):
        r = evaluate_mod.evaluate(
            pol, params, maneuver=maneuver, carry_init=None,
            steps=arg("--eval-steps", 1000),
            episodes=arg("--eval-episodes", 5))
        out["eval"][maneuver] = r
        common.print_eval(maneuver, r)
    return out


if __name__ == "__main__":
    main()
