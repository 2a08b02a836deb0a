"""The output-floor probes of benchmarks/exp_r2.py (K8-K10): their CUDA
kernels' wrappers and their plain PyTorch versions.

The JAX package inlines three Pallas probe kernels in its rasterizer
experiments (benchmarks/exp_r2.py:147-327) to measure what writing the
rasterizer's output costs without rasterizing:
- `okernel` (`ovl<KK>`): KK rounds of a float32 multiply-add over a
  (128, 128) tile per env, then a uint8 fill of the env's (L, H, W)
  block -- does compute overlap the output write?
- `zkernel` (`dmaflat[g]`, `dmaf32`, `dma[g]`): constant fills of the
  output -- the write floor;
- `dkernel` (`dskip`, `dskipall`): a fill of the live (env, layer)
  frames only -- the conditional-write floor.

Each wrapper fills the output it is given and returns it. On a CUDA
tensor it launches its kernel (`ops/csrc/probe_ovl.cu`, `probe_fill.cu`,
`probe_skip.cu`) on the current stream or raises; on a CPU tensor it runs
the plain version. The plain versions serve the CPU tests and the
card's kernel checks (chip_smoke.py), nothing else on the card.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from tinycarlo_torch.ops.rasterize_kernels import _Kernel

# exp_r2.py:158: the okernel's tile
TILE = (128, 128)
# the okernel's multiply-add constants (exp_r2.py:162), float32
FMA_MUL, FMA_ADD = 1.000001, 0.0001


def _u8(value) -> int:
    """A uint8 fill value: an integer in [0, 255]."""
    v = int(value)
    if v != value or not 0 <= v <= 255:
        raise ValueError(f"uint8 fill value {value!r} is not in 0..255")
    return v


def _word(value, dtype: torch.dtype) -> int:
    """The 32-bit pattern a kernel stores: a uint8 value in every byte, or
    a float32's bits."""
    if dtype == torch.uint8:
        return _u8(value) * 0x01010101
    return struct.unpack("<I", struct.pack("<f", float(value)))[0]


def ovl_plain(out: torch.Tensor, v: float, kk: int) -> torch.Tensor:
    """`okernel` in plain PyTorch: KK rounds of x * 1.000001 + 0.0001 in
    float32 (each rounded) over a (128, 128) tile of v, then
    out[env, ...] = uint8(int32(tile[0, 0])) for every env. Every env
    starts from the same v, so one tile serves the batch."""
    tile = torch.full(TILE, float(v), dtype=torch.float32, device=out.device)
    for _ in range(kk):
        tile = tile * FMA_MUL + FMA_ADD
    u = tile[0, 0].to(torch.int32).to(torch.uint8)
    return out.copy_(u.expand(out.shape))


def fill_plain(out: torch.Tensor, value) -> torch.Tensor:
    """`zkernel` in plain PyTorch: every element of out is `value` (the
    envs per grid step change nothing in the result)."""
    if out.dtype == torch.uint8:
        value = _u8(value)
    return out.fill_(value)


def skip_plain(out: torch.Tensor, live: torch.Tensor, value) -> torch.Tensor:
    """`dkernel` in plain PyTorch: frame env * L + l of the (N * L, ...)
    output is filled with `value` iff live[l, env] > 0; the others keep
    their bytes."""
    n_layers, n_envs = live.shape
    frames = out.view(n_envs, n_layers, -1)
    frames[live.T > 0] = _u8(value)
    return out


class _ProbeKernel(_Kernel):
    """A probe kernel's wrapper: checks the output it fills."""

    def _check_out(self, out: torch.Tensor, dtypes) -> None:
        if out.dtype not in dtypes or out.dim() < 1:
            raise ValueError(f"{self.NAME} kernel: out must be {dtypes} with "
                             f"a leading env axis, got {out.dtype} "
                             f"{tuple(out.shape)}")
        self._check_tensors({"out": (out, out.dtype, tuple(out.shape))},
                            out.device)


class OvlKernel(_ProbeKernel):
    """K8's wrapper: `ops/csrc/probe_ovl.cu` on a CUDA output, `ovl_plain`
    on a CPU one. out: (N, ...) uint8, one env per leading index."""

    NAME = "probe_ovl"
    SYMBOL = "tc_probe_ovl_launch"
    # out, env_bytes, n_envs, kk, v, stream
    ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

    def __call__(self, out: torch.Tensor, v: float, kk: int) -> torch.Tensor:
        if kk < 0:
            raise ValueError(f"{self.NAME} kernel: KK {kk} < 0")
        if out.device.type == "cpu":
            return ovl_plain(out, v, kk)
        self._check_out(out, (torch.uint8,))
        n = out.shape[0]
        return self._run(out, out.data_ptr(), out.numel() // max(n, 1), n,
                         int(kk), float(v))


class FillKernel(_ProbeKernel):
    """K9's wrapper: `ops/csrc/probe_fill.cu` on a CUDA output, `fill_plain`
    on a CPU one. out: (N, ...) uint8 or float32; `group`, the TPU's envs
    per grid step, must be >= 1 and changes nothing (the kernel's grid
    follows the output's bytes)."""

    NAME = "probe_fill"
    SYMBOL = "tc_probe_fill_launch"
    # out, env_bytes, n_envs, group, word, stream
    ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]

    def __call__(self, out: torch.Tensor, value, group: int = 1
                 ) -> torch.Tensor:
        if group < 1:
            raise ValueError(f"{self.NAME} kernel: group {group} < 1")
        if out.device.type == "cpu":
            return fill_plain(out, value)
        self._check_out(out, (torch.uint8, torch.float32))
        n = out.shape[0]
        env_bytes = out.numel() // max(n, 1) * out.element_size()
        return self._run(out, out.data_ptr(), env_bytes, n, int(group),
                         _word(value, out.dtype))


class SkipKernel(_ProbeKernel):
    """K10's wrapper: `ops/csrc/probe_skip.cu` on a CUDA output,
    `skip_plain` on a CPU one. out: (N * L, ...) uint8 frames, live: (L, N)
    int32."""

    NAME = "probe_skip"
    SYMBOL = "tc_probe_skip_launch"
    # out, live, n_envs, n_layers, frame_bytes, word, stream
    ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p]

    def __call__(self, out: torch.Tensor, live: torch.Tensor, value
                 ) -> torch.Tensor:
        if live.dim() != 2 or out.dim() < 1 or (
                out.shape[0] != live.shape[0] * live.shape[1]):
            raise ValueError(f"{self.NAME} kernel: out {tuple(out.shape)} "
                             f"is not (N * L, ...) for live (L, N) "
                             f"{tuple(live.shape)}")
        if out.device.type == "cpu":
            return skip_plain(out, live, value)
        self._check_out(out, (torch.uint8,))
        self._check_tensors({"live": (live, torch.int32, tuple(live.shape))},
                            out.device)
        n_layers, n_envs = live.shape
        frame_bytes = out.numel() // max(out.shape[0], 1)
        return self._run(out, out.data_ptr(), live.data_ptr(), n_envs,
                         n_layers, frame_bytes, _word(value, torch.uint8))


ovl_kernel = OvlKernel()
fill_kernel = FillKernel()
skip_kernel = SkipKernel()
KERNELS = (ovl_kernel, fill_kernel, skip_kernel)
