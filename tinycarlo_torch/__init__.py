"""tinycarlo_torch: the PyTorch + CUDA port of tinycarlo_tpu.

A second package beside `tinycarlo_tpu` (the JAX reference, which stays
as it is). Module names mirror the JAX package's, so each function has
its counterpart at the same path. The port runs on an NVIDIA GPU:
- the batched simulation -- map compilation, the kinematic car, the camera
  projection, segment compaction, shaping, auto-reset and the Stanley
  expert;
- the observations, from two hand-written CUDA kernels: class masks
  (ops/csrc/masks.cu) and the layer-rank map that the rgb, rgb_planar and
  rank formats decode (ops/csrc/rank.cu);
- serving a policy: the tinycar_net combo (models/tinycar_net.py, with the
  bundled pretrained weights) through train/evaluate.py.

Entry points take `device=` and default to "cuda"; they raise when no GPU
is present instead of carrying on on the CPU. Tests pass `device="cpu"`,
where each kernel's plain PyTorch version stands in for the kernel.

This package imports torch, numpy and yaml only: never jax, flax or
tinycarlo_tpu.
"""
