"""Policy-quality benchmark on the port: per-maneuver evaluation of a
TinycarCombo.

The port of examples/benchmark_tinycar_net.py (reference: its __main__,
:78-97): the bundled pretrained combo (or a flax npz given as the first
argument, else a fresh flax-style init), evaluated per maneuver with the
standard CTE wrapper stack through `train.evaluate.evaluate` (on the card
its steps replay one captured CUDA graph of render, policy and step),
the metric line printed and each maneuver's positions saved as
positions_m<m>.npy for `render_map --traces`. TEMPORAL=1 drives the
pretrained encoder with a fresh temporal actor (seq_len 10) instead;
SEQUENTIAL=1 runs the reference's sequential-episode mode (:46-65)
instead of the parallel batch.

Usage: python -m tinycarlo_torch.examples.benchmark_tinycar_net
  [model.npz] and, beyond the JAX example's: [--steps 1000]
  [--episodes 5] [--maneuvers 3] [--traces DIR] [--config PATH]
  [--device cuda|cpu]
(--traces defaults to the temporary directory.)
"""
import os
import sys
import tempfile
from typing import Dict

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch.convert import combo_state_dict_from_flax
from tinycarlo_torch.examples._common import (arg, default_config,
                                              positional, print_eval)
from tinycarlo_torch.models.tinycar_net import (
    TinycarActorTemporal,
    TinycarCombo,
    encoder_flat_features,
    flax_init_,
    load_pretrained,
    load_variables_npz,
)
from tinycarlo_torch.train import evaluate as evaluate_mod
from tinycarlo_torch.train.evaluate import combo_policy, temporal_policy
from tinycarlo_torch.utils.helper import getenv

ENV_SEED = 10
SEQ_LEN = 10
VALUED = ("--steps", "--episodes", "--maneuvers", "--traces", "--config",
          "--device")


def load_model(params, path=None) -> TinycarCombo:
    """The bundled pretrained combo for the params' observations, else the
    flax npz at `path`, else a fresh init (seed 0); eval mode on the
    params' device."""
    obs_shape = fenv.observation_shape(params)
    model = load_pretrained(obs_shape, device=params.device)
    if model is not None:
        return model
    channels = obs_shape[-1] if obs_shape[-1] in (1, 3) else obs_shape[0]
    if path is not None and os.path.exists(path):
        state = combo_state_dict_from_flax(load_variables_npz(path))
        model = TinycarCombo(
            channels, flat_features=state["encoder.fc1.weight"].shape[1])
        model.load_state_dict(state)
        print(f"loaded {path}")
    else:
        h, w = params.cfg.camera.resolution
        model = flax_init_(
            TinycarCombo(channels,
                         flat_features=encoder_flat_features(h, w)),
            torch.Generator().manual_seed(0))
        print("no pretrained weights reachable; evaluating a random init")
    return model.to(params.device).eval()


def main(argv=None) -> Dict:
    """Run the example with `argv` (default sys.argv[1:]); returns the
    evaluation (per maneuver)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = positional(argv, VALUED)
    config = os.path.abspath(arg(argv, "--config", default_config(), str))
    params = fenv.make_env_params(config,
                                  device=arg(argv, "--device", "cuda", str))
    model = load_model(params, args[0] if args else None)
    episodes = arg(argv, "--episodes", 5)
    sequential = getenv("SEQUENTIAL")
    if getenv("TEMPORAL"):
        actor = flax_init_(TinycarActorTemporal(seq_len=SEQ_LEN),
                           torch.Generator().manual_seed(1))
        pol = temporal_policy(model.encoder,
                              actor.to(params.device).eval(), SEQ_LEN)
        carry = torch.zeros((1 if sequential else episodes, SEQ_LEN, 256),
                            device=params.device)
    else:
        pol = combo_policy(model)
        carry = None

    traces = arg(argv, "--traces", tempfile.gettempdir(), str)
    results = {}
    for maneuver in range(arg(argv, "--maneuvers", 3)):
        results[maneuver] = r = evaluate_mod.evaluate(
            pol, params, maneuver=maneuver, carry_init=carry,
            steps=arg(argv, "--steps", 1000), episodes=episodes,
            seed=ENV_SEED, sequential=sequential,
        )
        np.save(os.path.join(traces, f"positions_m{maneuver}.npy"),
                r["positions"])
        print_eval(maneuver, r)
    return {"eval": results}


if __name__ == "__main__":
    main()
