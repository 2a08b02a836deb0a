"""Offline map visualization: overview PNG with optional node indices and
saved position traces, on the port.

The port of examples/render_map.py (reference: examples/render_map.py:
11-34, used to find spawn-point node indices for configs): the static
overview of `viz.render_static_overview`, WHITE=1 for a white background,
the traces that `benchmark_tinycar_net` saves (positions_m{0,1,2}.npy)
drawn as dots. The map compiles on --device; the overview is drawn on the
host.

Usage: python -m tinycarlo_torch.examples.render_map [config.yaml]
  [--nodes] [--traces DIR] [--out PATH] [--device cuda|cpu]
(--out defaults to map_overview.png in the temporary directory.)
"""
import os
import sys
import tempfile
from typing import Dict

import numpy as np

from tinycarlo_torch import env as fenv
from tinycarlo_torch.examples._common import arg, default_config, positional
from tinycarlo_torch.utils.helper import getenv
from tinycarlo_torch.viz import render_static_overview


def main(argv=None) -> Dict:
    """Run the example with `argv` (default sys.argv[1:]); returns the
    PNG's path and the image's shape."""
    import cv2

    argv = sys.argv[1:] if argv is None else list(argv)
    args = positional(argv, ("--traces", "--out", "--device"))
    config = args[0] if args else default_config()
    params = fenv.make_env_params(config,
                                  device=arg(argv, "--device", "cuda", str))
    background = (255, 255, 255) if getenv("WHITE") else None
    ppm = params.cfg.sim.overview_pixel_per_meter
    img = render_static_overview(
        params,
        ppm,
        background_color=background,
        render_node_names="--nodes" in argv,
    )
    trace_dir = arg(argv, "--traces", None, str)
    if trace_dir is not None:
        for m in range(3):
            p = os.path.join(trace_dir, f"positions_m{m}.npy")
            if os.path.exists(p):
                for pos in np.load(p):
                    cv2.circle(
                        img, tuple(np.int32(pos * ppm)), 1, (255, 0, 255), -1
                    )
    out = arg(argv, "--out",
              os.path.join(tempfile.gettempdir(), "map_overview.png"), str)
    cv2.imwrite(out, img)
    print(f"wrote {out} ({img.shape[1]}x{img.shape[0]})")
    return {"path": out, "shape": img.shape}


if __name__ == "__main__":
    main()
