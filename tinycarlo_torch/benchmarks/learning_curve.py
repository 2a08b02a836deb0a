"""The learning table of TD3 runs: reward per episode by chunk, read from
the rew_*.csv files that examples/train_td3 writes (train.logging).

    python -m tinycarlo_torch.benchmarks.learning_curve CSV [CSV ...]

For each file: the first chunk whose reward per episode reaches
`train_td3.POLICY_REWARD` (300, docs/TRAINING.md's time-to-policy
criterion), the mean of every WINDOW (20) chunks, the mean of the last
WINDOW and the maximum. One JSON line a file, keyed by its path. A host
tool: it reads files and runs nothing on a device.
"""
from __future__ import annotations

import csv
import json
import sys
from typing import Dict, List

from tinycarlo_torch.examples.train_td3 import POLICY_REWARD, time_to_policy

WINDOW = 20


def rewards(path: str) -> List[float]:
    """The Reward column of a rew_*.csv, in chunk order."""
    with open(path, newline="") as f:
        return [float(row["Reward"]) for row in csv.DictReader(f)]


def summary(values: List[float], window: int = WINDOW) -> Dict:
    first, _ = time_to_policy(values, [0.0] * len(values))
    means = [sum(values[i:i + window]) / len(values[i:i + window])
             for i in range(0, len(values), window)]
    last = values[-window:]
    return {"chunks": len(values), "first_chunk_at_policy": first,
            "policy_reward": POLICY_REWARD, "window": window,
            "window_means": means, "last_window_mean": sum(last) / len(last),
            "max": max(values)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    for path in argv:
        print(json.dumps({"file": path, **summary(rewards(path))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
