"""Readings for the limits of a cell's comparison, on the card.

    python3 -m portbench.tools.readings --workload <cell> --seeds <n> \
        [--controls <m>] [--seconds <s>] [--first-seed <n>]

For each of `--seeds` seeds, in one process (the kernels built once): the
cell's set-up, a window of `--seconds` at the cell's own load, and the
comparison of what it produced with the reference; for the first
`--controls` seeds also the control, the reference computed in bfloat16
in the program's place. One JSON line a seed: {"seed", "program":
{number: value}, "control": {...} or null}. The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench import run as harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--first-seed", type=int, default=2_147_483_000)
    args = ap.parse_args(argv)
    harness.set_caches()
    import torch
    device = torch.device("cuda", 0)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        _, _, run, driver = harness.prepare(args.workload, seed,
                                            args.seconds, device)
        cell = driver.Cell(run)
        cell.window(args.seconds)
        cell.release()
        gc.collect()
        torch.cuda.empty_cache()
        prog = {n: v for n, v, _ in cell.check()}
        ctrl = None
        if i < args.controls:
            ctrl = {n: v for n, v, _ in cell.check(stand_in="bfloat16")}
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}),
              flush=True)
        del cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
