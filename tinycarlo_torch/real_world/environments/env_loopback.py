"""Loopback backend: "hardware" that is a host-side kinematic simulation.

tinycarlo_tpu/real_world/environments/env_loopback.py on the port's
backend contract.

Serves two purposes: a runnable, headless demonstration of the backend
contract (the reference's only backend needs physical cars + external
libraries, env_autosys.py), and the test double for the real-world env's
plumbing. The pose evolves by the same bicycle model the simulator uses,
computed in plain numpy with optional tracking noise -- as if a motion-
capture system were watching a real car.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from tinycarlo_torch.real_world.base import RealWorldCamera, RealWorldCar


class LoopbackCar(RealWorldCar):
    def __init__(
        self,
        wheelbase: float = 0.0487,
        max_velocity: float = 0.15,
        max_steering_deg: float = 30.0,
        dt: float = 1 / 30,
        start: Tuple[float, float, float] = (0.5, 0.5, 0.0),
        tracking_noise: float = 0.0,
        seed: int = 0,
    ):
        self.wheelbase = wheelbase
        self.max_velocity = max_velocity
        self.max_steering_deg = max_steering_deg
        self.dt = dt
        self.x, self.y, self.rot = start
        self.velocity = 0.0
        self.noise = tracking_noise
        self.rng = np.random.default_rng(seed)
        self.stopped = False

    def drive(self, velocity: float, steering: float, maneuver: int) -> None:
        v = velocity * self.max_velocity
        delta = math.radians(steering * self.max_steering_deg)
        if abs(delta) < 1e-4:
            self.x += v * math.cos(self.rot) * self.dt
            self.y += v * math.sin(self.rot) * self.dt
        else:
            radius = self.wheelbase / math.tan(delta)
            dyaw = v / radius * self.dt
            # rotate about the turn center
            nx = self.x + radius * (math.sin(self.rot + dyaw) - math.sin(self.rot))
            ny = self.y - radius * (math.cos(self.rot + dyaw) - math.cos(self.rot))
            self.x, self.y = nx, ny
            self.rot = (self.rot + dyaw + math.pi) % (2 * math.pi) - math.pi
        self.velocity = v

    def pose(self):
        n = self.noise
        jitter = self.rng.normal(0.0, n, 3) if n > 0 else np.zeros(3)
        return (
            np.asarray([self.x + jitter[0], self.y + jitter[1]]),
            float(self.rot + jitter[2]),
            float(self.velocity),
        )

    def reposition(self, target_position, target_rotation) -> None:
        # a mocap'd toy car can simply be placed at the target
        self.x, self.y = float(target_position[0]), float(target_position[1])
        self.rot = float(target_rotation)
        self.velocity = 0.0

    def stop(self) -> None:
        self.stopped = True
        self.velocity = 0.0


class LoopbackCamera(RealWorldCamera):
    def capture(self) -> Optional[np.ndarray]:
        return None  # digital-twin view: simulated camera at tracked pose


class LoopbackRig:
    """The autosys backend's transport and tracker in one, for runs
    without the hardware: servo and motor commands drive a LoopbackCar,
    and the tracker reports its pose in pixels, as the multicast tracking
    does (env_autosys.AutosysCar takes it as both `transport` and
    `tracker`). `moves` counts the motor commands that moved the car."""

    def __init__(self, start, pixel_per_meter: float = 450.0):
        self.car = LoopbackCar(start=start)
        self.ppm = pixel_per_meter
        self.steering_deg = 0.0
        self.moves = 0

    def set_servo_angle(self, centidegrees: int) -> None:
        self.steering_deg = (centidegrees - 9000) / 100.0

    def set_motor_duty_cycle(self, duty: int) -> None:
        self.moves += duty != 0
        self.car.drive(duty / 100.0,
                       self.steering_deg / self.car.max_steering_deg, 0)

    def set_blinker(self, mode: str) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def get(self):
        car = self.car
        return (2, car.x * self.ppm, car.y * self.ppm, car.rot)
