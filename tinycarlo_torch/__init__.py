"""tinycarlo_torch: the PyTorch + CUDA port of tinycarlo_tpu.

A second package beside `tinycarlo_tpu` (the JAX reference, which stays
as it is). Module names mirror the JAX package's, so each function has
its counterpart at the same path. The port runs on an NVIDIA GPU:
- the batched simulation -- map compilation, the kinematic car, the camera
  projection, segment compaction, shaping, auto-reset and the Stanley
  expert;
- the observations, from hand-written CUDA kernels under ops/csrc/: class
  masks (masks.cu), the layer-rank map that the rgb, rgb_planar and rank
  formats decode (rank.cu), and cv2's ThickLine masks under
  `camera.stroke: exact` (exact.cu);
- serving a policy: the tinycar_net combo (models/tinycar_net.py, with the
  bundled pretrained weights) through train/evaluate.py;
- the benchmarks (benchmarks/): the headline bench, bench.py's step
  replayed as a CUDA graph, and the rasterizer benchmark, whose older
  compaction layouts have their own kernels (frame_soa.cu, env_soa.cu,
  env_seg.cu) and whose output-floor probes theirs (probe_ovl.cu,
  probe_fill.cu, probe_skip.cu). Nine `.cu` sources share three headers:
  stamp.cuh (the stamp), store.cuh (the 16-byte store path) and
  env_block.cuh (the one-block-per-env skeleton of every stamping
  kernel: masks.cu, rank.cu, exact.cu, env_soa.cu, frame_soa.cu and
  env_seg.cu).
- the Gymnasium entry point (gym_env.TinyCarloEnv, registered as
  "tinycarlo-torch-v2" when gymnasium imports; the JAX package holds
  "tinycarlo-v2"), whose step is one replayed CUDA graph on the card, and
  the reference's wrapper classes (wrapper/);
- the host tools: the digital twin around a hardware car
  (real_world.TinyCarloRealWorldEnv, "tinycarlo-torch-realworld-v2", its
  step one replayed CUDA graph on the card; the loopback and autosys
  backends), the overview map (viz, the shim's human render mode), map
  generation (mapgen), the map-authoring GUI (mapbuilder) and the
  examples (examples/).

Entry points take `device=` and default to "cuda"; they raise when no GPU
is present instead of carrying on on the CPU. Tests pass `device="cpu"`,
where each kernel's plain PyTorch version stands in for the kernel.

- training: the TD3 learner (train/td3.py), its replay buffer and the
  fused rollout + replay + update loop (train/td3_loop.py), each chunk a
  sequence of replayed CUDA graphs on the card; `vector.rollout`;
  checkpoints (utils/checkpoint.py) and profiling (utils/profiling.py).

This package imports torch, numpy and yaml, and gymnasium where it is
installed: never jax, flax or tinycarlo_tpu. Its top level exports the
JAX package's names: the config classes, the functional env and `vector`.
"""
from tinycarlo_torch.config import (  # noqa: F401
    CameraConfig,
    CarConfig,
    EnvConfig,
    MapConfig,
    SimConfig,
    load_config,
)
from tinycarlo_torch.env import (  # noqa: F401
    EnvParams,
    EnvState,
    make_env_params,
    render_observation,
    render_observation_batch,
    reset,
    step,
)
from tinycarlo_torch import vector  # noqa: F401

try:  # gymnasium is optional: without it the shim subclasses stand-ins
    from gymnasium.envs.registration import register, registry
except ImportError:
    pass
else:
    if "tinycarlo-torch-v2" not in registry:
        register(id="tinycarlo-torch-v2",
                 entry_point="tinycarlo_torch.gym_env:TinyCarloEnv")
    if "tinycarlo-torch-realworld-v2" not in registry:
        register(id="tinycarlo-torch-realworld-v2",
                 entry_point="tinycarlo_torch.real_world.env:"
                             "TinyCarloRealWorldEnv")
