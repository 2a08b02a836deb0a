"""Policy-level observation parity: the bundled combo driven by the port's
kernel-rendered frames, and (where its checkout is mounted) by the
reference simulator's cv2-rendered frames.

    python -m tinycarlo_torch.benchmarks.policy_parity [--steps 500] [--episodes 4] [--stroke fast|exact | --stroke-exact] [--device cuda]

The counterpart of benchmarks/policy_parity.py (:40-160), which stays the
JAX package's. Protocol: the bundled IL-trained TinycarCombo
(`models.tinycar_net.load_pretrained`) evaluated per maneuver 0, 1, 2
under the reference's evaluate() semantics (sequential episodes, a reset
on termination and every `steps` iterations, the CTE reward and
termination stack) on examples/config_simple_layout.yaml with its map
path resolved and `camera.stroke` set (`--stroke exact`: the cv2
ThickLine stroke, the exact kernel): `our_eval`, through the port's
`train.evaluate`. `reference_eval` drives the original numpy simulator's
`TinyCarloEnv` (its checkout named by TINYCARLO_REFERENCE) with the same
combo on its cv2 frames, and returns None without that checkout, as the
script does. The spawn streams
differ, so the metrics are compared as per-step averages over the same
step budget. Prints one JSON line a maneuver and, when the reference
ran, the relative cte_avg gaps.

Runs on the card by default and raises without a GPU; `--device cpu`
(or `our_eval(..., device="cpu")`) runs the plain PyTorch path.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import torch
import yaml

from tinycarlo_torch import env as fenv
from tinycarlo_torch.models.tinycar_net import (load_pretrained, one_hot,
                                                pre_obs)
from tinycarlo_torch.train.evaluate import combo_policy, evaluate
from tinycarlo_torch.utils.helper import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the original numpy simulator's checkout, where there is one
REFERENCE = os.environ.get("TINYCARLO_REFERENCE", "")
YAML = os.path.join(REPO, "examples/config_simple_layout.yaml")
MAP = os.path.join(REPO, "examples/maps/simple_layout.json")
SPEED = 0.35


def _arg(argv, flag: str, default):
    return (type(default)(argv[argv.index(flag) + 1]) if flag in argv
            else default)


def config(stroke: str = "fast") -> Dict:
    """The yaml with its map path resolved and `camera.stroke` set."""
    with open(YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["map"]["json_path"] = MAP
    cfg["camera"]["stroke"] = stroke
    return cfg


def our_eval(model, maneuver: int, steps: int, episodes: int,
             stroke: str = "fast", device="cuda",
             stats: Optional[Dict[str, int]] = None) -> Dict:
    """The protocol on the port (policy_parity.py:40-66): `evaluate` of
    the combo `model`, sequential, float32 params on `device`; the
    metrics without the positions. `stats` gains the rollout's replays
    and captures (`evaluate`)."""
    params = fenv.make_env_params(config(stroke), dtype=torch.float32,
                                  device=resolve_device(device))
    r = evaluate(combo_policy(model), params, maneuver=maneuver,
                 carry_init=None, steps=steps, episodes=episodes,
                 sequential=True, stats=stats)
    r.pop("positions")
    return r


def reference_eval(model, maneuver: int, steps: int,
                   episodes: int) -> Optional[Dict]:
    """The reference evaluate() loop (benchmark_tinycar_net.py:23-76)
    driven by the combo on cv2-rendered observations; None without the
    reference checkout (REFERENCE)."""
    if not REFERENCE or not os.path.isdir(os.path.join(REFERENCE,
                                                          "tinycarlo")):
        return None
    sys.path.insert(0, REFERENCE)
    from tinycarlo.env import TinyCarloEnv
    from tinycarlo.wrapper.reward import CTELinearRewardWrapper
    from tinycarlo.wrapper.termination import (CrashTerminationWrapper,
                                               CTETerminationWrapper)

    with open(YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["map"]["json_path"] = MAP
    env = TinyCarloEnv(config=cfg)
    env = CTELinearRewardWrapper(env, min_cte=0.03, max_reward=1.0,
                                 min_reward=-1.0)
    env = CTETerminationWrapper(env, max_cte=0.1, number_of_steps=5)
    env = CrashTerminationWrapper(env)
    dev = next(model.parameters()).device
    m_onehot = one_hot(torch.tensor([maneuver], device=dev),
                       model.maneuver_dim)

    def steer(obs):
        with torch.no_grad():
            x = pre_obs(torch.as_tensor(obs[None], device=dev))
            return float(model(x, m_onehot)[0, 0])

    obs = env.reset(seed=0)[0]
    total_rew, cte, he, terminations = 0.0, [], [], 0
    for i in range(steps * episodes):
        obs, rew, term, trunc, info = env.step(
            {"car_control": [SPEED, steer(obs)],
             "maneuver": maneuver if maneuver != 2 else 3})
        total_rew += rew
        cte.append(abs(info["cte"]))
        he.append(abs(info["heading_error"]))
        if term or trunc:
            if term:
                terminations += 1
            obs = env.reset()[0]
        if i % steps == 0:
            obs = env.reset()[0]
    cte_avg = sum(cte) / len(cte)
    he_avg = sum(he) / len(he)
    return {
        "cte_avg": cte_avg,
        "cte_var": sum((x - cte_avg) ** 2 for x in cte) / len(cte),
        "heading_error_avg": he_avg,
        "heading_error_var": sum((x - he_avg) ** 2 for x in he) / len(he),
        "terminations": terminations,
        "total_reward": total_rew,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps = _arg(argv, "--steps", 500)
    episodes = _arg(argv, "--episodes", 4)
    device = _arg(argv, "--device", "cuda")
    stroke = "exact" if "--stroke-exact" in argv else _arg(
        argv, "--stroke", "fast")
    params = fenv.make_env_params(config(stroke),
                                  device=resolve_device(device))
    model = load_pretrained(fenv.observation_shape(params), device=device)
    if model is None:
        raise SystemExit("the bundled pretrained combo is missing")
    rows = []
    for maneuver in range(3):
        ours = our_eval(model, maneuver, steps, episodes, stroke, device)
        ref = reference_eval(model, maneuver, steps, episodes)
        rows.append({"maneuver": maneuver, "ours": ours, "reference": ref})
        print(json.dumps(rows[-1]), flush=True)
    if rows[0]["reference"] is not None:
        gaps = [abs(r["ours"]["cte_avg"] - r["reference"]["cte_avg"])
                / max(r["reference"]["cte_avg"], 1e-9) for r in rows]
        print(json.dumps({
            "metric": "policy-level renderer parity: per-maneuver "
                      "|cte_avg ours - cv2| / cv2",
            "stroke": stroke,
            "gaps": [round(g, 3) for g in gaps],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
