"""The env step's per-car work as one CUDA kernel (ops/csrc/car.cu).

`env.step` runs, before its render, the action clamp, `car.car_step`
(bicycle kinematics and `find_local_path`), then `car.car_info` and the
default shaping (`env.shaping`). As torch ops that is some 600 kernel
launches a step; `car_kernel` computes the same outputs, bit for bit, in
one launch. Its plain version is that composition (`env._car_work_plain`),
which runs where the kernel does not apply (`applies`): CPU tensors, a
dtype other than float32, and a map that carries a LanelineGrid.

Traced (utils/profiling.py) by the host counter "car.kernel" (the envs
whose step the kernel took, counted by `env.step`) and the device counter
"car.resnaps" (the cars that ran the u-turn re-snap scan: the u-turn
entries; the composition scans for every car).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch.config import CarConfig
from tinycarlo_torch.map_compiler import MapData
from tinycarlo_torch.ops.rasterize_kernels import _Kernel
from tinycarlo_torch.utils import profiling

# car.cu's kWarps (envs a block) and kMaxLayers
ENVS_PER_BLOCK = 4
MAX_LAYERS = 64

# the order of car.cu's argument arrays (its enums In, Out, Ints, Floats)
_IN = ("position", "rotation", "steering_angle", "velocity", "local_path",
       "local_path_len", "last_maneuver", "control", "maneuver", "lp_nodes",
       "lp_edges", "lp_edge_mask", "next_table", "next_count", "prev_table",
       "prev_count", "packed_nodes", "packed_edges")
_OUT = ("position", "position_front", "rotation", "steering_angle", "radius",
        "velocity", "local_path", "local_path_len", "last_maneuver",
        "truncated", "cte", "heading_error", "laneline_distances",
        "info_local_path", "info_local_path_len", "info_velocity", "reward",
        "terminated", "resnaps")
_INTS = ("B", "man64", "lp_e", "deg", "L", "has_acc", "has_steer", "wrapped")
_FLOATS = ("max_velocity", "max_steering", "dec_dt", "acc_dt", "steer_dt",
           "dt", "wheelbase", "deg2rad", "margin", "neg_inv_tw", "term_cte")
# tensors the kernel reads or writes as float2 / int2 (8-byte aligned)
_PAIRS = {"position", "local_path", "lp_nodes", "lp_edges", "packed_nodes",
          "packed_edges", "position_front", "info_local_path"}


def applies(map_data: MapData, car: car_mod.CarState,
            control: torch.Tensor) -> bool:
    """Whether `env.step`'s per-car work goes to the kernel: a CUDA float32
    state, action and map, and a map without a LanelineGrid (the kernel
    runs the full packed scan)."""
    return (car.position.device.type == "cuda"
            and car.position.dtype == torch.float32
            and control.dtype == torch.float32
            and map_data.lanepath.nodes.dtype == torch.float32
            and map_data.laneline_grid is None)


def _constants(cfg: CarConfig, dt: float) -> Dict[str, float]:
    """The car's Python constants as the composition computes them in
    double precision; the C call rounds each to float32, as torch rounds a
    scalar."""
    return {
        "max_velocity": cfg.max_velocity,
        "max_steering": cfg.max_steering_angle,
        "dec_dt": (cfg.max_deceleration * dt
                   if cfg.max_acceleration is not None else 0.0),
        "acc_dt": (cfg.max_acceleration * dt
                   if cfg.max_acceleration is not None else 0.0),
        "steer_dt": (cfg.steering_speed * dt
                     if cfg.steering_speed is not None else 0.0),
        "dt": dt,
        "wheelbase": cfg.wheelbase,
        "deg2rad": math.pi / 180,
        "margin": math.radians(30.0),
        "neg_inv_tw": -1.0 / cfg.track_width,
        "term_cte": cfg.track_width * 10,
    }


class CarKernel(_Kernel):
    """`ops/csrc/car.cu`'s wrapper: one launch for B envs' action clamp,
    car step, car_info and shaping, on CUDA float32 tensors (it raises on
    anything else; `applies` says when `env.step` calls it). A strided
    state or action (an expanded action, as callers pass) is copied
    contiguous first. Returns (car state, truncated, info, reward,
    terminated) as the composition does: new tensors, one a field; info
    without "position" and "orientation", which `env.step` adds."""

    NAME = "car"
    SYMBOL = "tc_car_launch"
    # tc_car_launch(in pointers, out pointers, ints, floats, stream)
    ARGTYPES = (ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                ctypes.c_void_p)

    def __call__(self, map_data: MapData, cfg: CarConfig, dt: float,
                 car: car_mod.CarState, control: torch.Tensor,
                 maneuver: torch.Tensor, wrapped: bool):
        dev = car.position.device
        bsz = car.position.shape[0]
        lp = map_data.lanepath
        n_layers = map_data.n_layers
        if n_layers > MAX_LAYERS:
            raise ValueError(f"car kernel: {n_layers} laneline layers, at "
                             f"most {MAX_LAYERS}")
        if maneuver.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"car kernel: maneuver dtype {maneuver.dtype} "
                             "not in (int32, int64)")
        f32, i32 = torch.float32, torch.int32
        n_nodes, deg = lp.next_table.shape
        e = lp.edges.shape[0]
        pk_nodes = map_data.packed_nodes[0]
        pk_edges = map_data.packed_edges[0]
        ins = {
            "position": (car.position.contiguous(), f32, (bsz, 2)),
            "rotation": (car.rotation.contiguous(), f32, (bsz,)),
            "steering_angle": (car.steering_angle.contiguous(), f32,
                               (bsz,)),
            "velocity": (car.velocity.contiguous(), f32, (bsz,)),
            "local_path": (car.local_path.contiguous(), i32,
                           (bsz, car_mod.PATH_LEN, 2)),
            "local_path_len": (car.local_path_len.contiguous(), i32,
                               (bsz,)),
            "last_maneuver": (car.last_maneuver.contiguous(), i32, (bsz,)),
            "control": (control.contiguous(), f32, (bsz, 2)),
            "maneuver": (maneuver.contiguous(), maneuver.dtype, (bsz,)),
            "lp_nodes": (lp.nodes, f32, (lp.nodes.shape[0], 2)),
            "lp_edges": (lp.edges, i32, (e, 2)),
            "lp_edge_mask": (lp.edge_mask, torch.bool, (e,)),
            "next_table": (lp.next_table, i32, (n_nodes, deg)),
            "next_count": (lp.next_count, i32, (n_nodes,)),
            "prev_table": (lp.prev_table, i32, (n_nodes, deg)),
            "prev_count": (lp.prev_count, i32, (n_nodes,)),
            "packed_nodes": (pk_nodes, f32, (pk_nodes.shape[0], 2)),
            "packed_edges": (pk_edges, i32, (pk_edges.shape[0], 2)),
        }
        self._check_tensors(ins, dev)

        def new(dtype, *shape):
            return torch.empty((bsz,) + shape, dtype=dtype, device=dev)

        blocks = -(-bsz // ENVS_PER_BLOCK)
        outs = {
            "position": new(f32, 2), "position_front": new(f32, 2),
            "rotation": new(f32), "steering_angle": new(f32),
            "radius": new(f32), "velocity": new(f32),
            "local_path": new(i32, car_mod.PATH_LEN, 2),
            "local_path_len": new(i32), "last_maneuver": new(i32),
            "truncated": new(torch.bool), "cte": new(f32),
            "heading_error": new(f32),
            "laneline_distances": new(f32, n_layers),
            "info_local_path": new(f32, car_mod.PATH_LEN, 2),
            "info_local_path_len": new(i32), "info_velocity": new(f32),
            "reward": new(f32), "terminated": new(torch.bool),
            "resnaps": torch.empty(blocks, dtype=i32, device=dev),
        }
        for name in _PAIRS:
            t = ins[name][0] if name in ins else outs[name]
            if t.data_ptr() % 8:
                raise ValueError(f"car kernel: {name} must be 8-byte aligned")
        bounds = tuple(map_data.packed_layer_bounds)
        if len(bounds) != n_layers + 1 or bounds[-1] > pk_edges.shape[0]:
            raise ValueError(f"car kernel: layer bounds {bounds} do not fit "
                             f"{n_layers} layers of {pk_edges.shape[0]} edges")
        ints = {
            "B": bsz, "man64": int(maneuver.dtype == torch.int64),
            "lp_e": e, "deg": deg, "L": n_layers,
            "has_acc": int(cfg.max_acceleration is not None),
            "has_steer": int(cfg.steering_speed is not None),
            "wrapped": int(wrapped),
        }
        floats = _constants(cfg, dt)
        c_in = (ctypes.c_void_p * len(_IN))(
            *(ins[name][0].data_ptr() for name in _IN))
        c_out = (ctypes.c_void_p * len(_OUT))(
            *(outs[name].data_ptr() for name in _OUT))
        c_ints = (ctypes.c_int * (len(_INTS) + len(bounds)))(
            *(ints[name] for name in _INTS), *bounds)
        c_floats = (ctypes.c_float * len(_FLOATS))(
            *(float(floats[name]) for name in _FLOATS))
        self._run(outs["resnaps"], c_in, c_out, c_ints, c_floats)
        profiling.device_count("car.resnaps", outs["resnaps"])
        state = car_mod.CarState(
            position=outs["position"], position_front=outs["position_front"],
            rotation=outs["rotation"], steering_angle=outs["steering_angle"],
            radius=outs["radius"], velocity=outs["velocity"],
            local_path=outs["local_path"],
            local_path_len=outs["local_path_len"],
            last_maneuver=outs["last_maneuver"],
        )
        info = {
            "cte": outs["cte"], "heading_error": outs["heading_error"],
            "laneline_distances": outs["laneline_distances"],
            "local_path": outs["info_local_path"],
            "local_path_len": outs["info_local_path_len"],
            "velocity": outs["info_velocity"],
        }
        return (state, outs["truncated"], info, outs["reward"],
                outs["terminated"])


car_kernel = CarKernel()
