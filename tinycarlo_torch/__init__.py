"""tinycarlo_torch: the PyTorch + CUDA port of tinycarlo_tpu.

A second package beside `tinycarlo_tpu` (the JAX reference, which stays
as it is). Module names mirror the JAX package's, so each function has
its counterpart at the same path. The port runs the batched main path --
map compilation, the kinematic car, the camera projection, segment
compaction, the hand-written CUDA masks kernel (ops/csrc/masks.cu),
shaping, auto-reset and the Stanley expert -- on an NVIDIA GPU.

Entry points take `device=` and default to "cuda"; they raise when no GPU
is present instead of carrying on on the CPU. Tests pass `device="cpu"`,
where the masks kernel's plain PyTorch version stands in for the kernel.

This package imports torch, numpy and yaml only: never jax, flax or
tinycarlo_tpu.
"""
