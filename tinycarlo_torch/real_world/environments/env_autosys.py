"""Autosys-style hardware backend: UDP-multicast tracked toy car.

tinycarlo_tpu/real_world/environments/env_autosys.py on the port's
backend contract; the guidance its drive-back reads comes from the
port's twin (`real_world.base.make_guidance`).

Structural equivalent of the reference's only real deployment
(reference: tinycarlo/real_world/environments/env_autosys.py): pose from
multicast camera tracking (`PoseTracker`), drive commands to a "tinycar"
servo/motor bridge, blinkers mapped from maneuvers, tracking-timeout
motor stop, velocity estimated from successive tracked positions, and
history-replay repositioning. The hardware client library (`tinycar`) and
the lane-segmentation camera net are external; their call sites are kept
behind a small transport interface so this module imports and is testable
without the hardware present.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

from tinycarlo_torch.real_world.base import RealWorldCamera, RealWorldCar
from tinycarlo_torch.real_world.tracking import PoseTracker
from tinycarlo_torch.utils.helper import getenv


class TinycarTransport:
    """Servo/motor/blinker command channel.

    Default implementation tries the external `tinycar` client library
    (the reference's hardware dependency, env_autosys.py:7,108); absent
    hardware, commands are no-ops so the digital-twin env still runs.
    """

    def __init__(self, hostname: str = "localhost"):
        self._impl = None
        try:
            from tinycar import Tinycar  # external hardware library

            self._impl = Tinycar(hostname)
        except ImportError:
            pass

    def set_servo_angle(self, centidegrees: int) -> None:
        if self._impl is not None:
            self._impl.setServoAngle(centidegrees)

    def set_motor_duty_cycle(self, duty: int) -> None:
        if self._impl is not None:
            self._impl.setMotorDutyCycle(duty)

    def set_blinker(self, mode: str) -> None:
        if self._impl is None:
            return
        {
            "off": self._impl.setBlinkerOff,
            "left": self._impl.setBlinkerLeft,
            "right": self._impl.setBlinkerRight,
            "hazard": self._impl.setBlinkerHazard,
        }[mode]()


class AutosysCar(RealWorldCar):
    """Reference AutosysCar semantics (env_autosys.py:102-222)."""

    def __init__(
        self,
        hostname: str = "localhost",
        pixel_per_meter: float = 450.0,
        max_steering_deg: float = 30.0,
        tracking_timeout: float = 0.5,
    ):
        self.transport = TinycarTransport(hostname)
        self.tracker = PoseTracker()
        self.ppm = pixel_per_meter
        self.max_steering_deg = max_steering_deg
        self.timeout = tracking_timeout
        self.history: deque = deque(maxlen=20)  # for reverse repositioning
        self._position = np.zeros(2)
        self._rotation = 0.0
        self._velocity = 0.0
        self._last_update: Optional[float] = None

    def connect(self) -> None:
        self.tracker.start()

    def drive(self, velocity: float, steering: float, maneuver: int) -> None:
        steering_deg = steering * self.max_steering_deg
        blinker = {0: "off", 1: "right", 3: "left"}.get(maneuver)
        if blinker:
            self.transport.set_blinker(blinker)
        self.history.append((steering_deg, velocity))
        self._send(steering_deg, velocity)

    def _send(self, steering_deg: float, speed: float) -> None:
        # stuck cars get a kick (reference env_autosys.py:185-187)
        if abs(self._velocity) < 0.01:
            speed *= 2.5
        speed = float(np.clip(speed, -1.0, 1.0))
        self.transport.set_servo_angle(int(9000 + steering_deg * 100))
        self.transport.set_motor_duty_cycle(int(speed * 100))
        if not self._wait_for_tracking():
            # tracking lost: stop the motor (env_autosys.py:192-195)
            self.transport.set_motor_duty_cycle(0)
            self.transport.set_servo_angle(9000)

    def _wait_for_tracking(self, use_timeout: bool = True) -> bool:
        st = time.perf_counter()
        sample = None
        while sample is None:
            sample = self.tracker.get()
            if sample is None and use_timeout and (
                time.perf_counter() - st > self.timeout
            ):
                return False
        _, x_px, y_px, rot = sample
        pos = np.asarray([x_px / self.ppm, y_px / self.ppm])
        now = time.perf_counter()
        if self._last_update is not None:
            dt = now - self._last_update
            if dt > 0:
                self._velocity = float(
                    np.linalg.norm(pos - self._position) / dt
                )
        self._last_update = now
        self._position = pos
        self._rotation = math.atan2(math.sin(rot), math.cos(rot))
        return True

    def pose(self) -> Tuple[np.ndarray, float, float]:
        self.tracker.get() and self._wait_for_tracking()  # drain latest
        return self._position.copy(), self._rotation, self._velocity

    # convergence thresholds / controller constants, matching the
    # reference (env_autosys.py:107-109,161-164)
    position_check_thres = 0.02  # m, per-axis box
    rotation_check_thres = math.radians(20.0)
    reset_speed = 0.35
    stanley_k = 4.0
    reposition_max_iters = 600  # hardware safety bound; the reference
    # loops unboundedly (env_autosys.py:146) -- a tracking glitch there
    # drives the car forever

    def _check_position(self, desired) -> bool:
        """Per-axis box test (reference check_position, env_autosys.py:224)."""
        t = self.position_check_thres
        return bool(
            abs(self._position[0] - desired[0]) <= t
            and abs(self._position[1] - desired[1]) <= t
        )

    def _check_rotation(self, desired: float) -> bool:
        d = desired - self._rotation
        return abs(math.atan2(math.sin(d), math.cos(d))) < (
            self.rotation_check_thres
        )

    def reposition(self, target_position, target_rotation, guidance=None) -> None:
        """Automatic recovery to the nearest lanepath pose (reference
        AutosysCar.reset loop, env_autosys.py:135-178): replay the action
        history in reverse while it lasts; when it runs out,
        Stanley-drive back using the digital twin's cte/heading stream
        (steering = (heading_error + atan2(k*cte, reset_speed)) in
        degrees over max_steering, k=4, reference :161-164) with the
        maneuver-retry fallback (straight first, then left; give up if
        both local-path walks dead-end, reference :156-160). The target
        pose is re-snapped from the tracked pose every iteration
        (reference :167). Without `guidance` (no map feedback available)
        only the history replay runs."""
        self.transport.set_blinker("hazard")
        target = np.asarray(target_position, float)
        target_rot = float(target_rotation)
        for _ in range(self.reposition_max_iters):
            if self._check_position(target) and self._check_rotation(
                target_rot
            ):
                break
            if self.history:
                steering_deg, speed = self.history.pop()
                self._send(steering_deg, -speed)
            elif guidance is None:
                break  # history exhausted and no map feedback
            else:
                cte, heading_error, truncated, target, target_rot = (
                    guidance(self._position, self._rotation, 0)
                )
                if truncated:
                    cte, heading_error, truncated, target, target_rot = (
                        guidance(self._position, self._rotation, 3)
                    )
                    if truncated:
                        break  # no reachable path either way (ref :157-160)
                correction = math.atan2(
                    self.stanley_k * cte, self.reset_speed
                )
                steering = (
                    (heading_error + correction)
                    * 180.0 / math.pi / self.max_steering_deg
                )
                steering = float(np.clip(steering, -1.0, 1.0))
                self._send(
                    steering * self.max_steering_deg, self.reset_speed
                )
                continue  # guidance already re-snapped the target
            if guidance is not None:
                # re-snap after a history-replay step too (reference
                # updates the nearest edge every loop iteration, :167)
                _, _, _, target, target_rot = guidance(
                    self._position, self._rotation, 0
                )
        self.transport.set_blinker("off")
        self.transport.set_motor_duty_cycle(0)
        self.transport.set_servo_angle(9000)
        self._velocity = 0.0
        self._last_update = None

    def stop(self) -> None:
        self.transport.set_motor_duty_cycle(0)
        self.tracker.stop()


def _resize(img: np.ndarray, wh) -> np.ndarray:
    """cv2.resize when available (the reference's path,
    env_autosys.py:36-39), else nearest-neighbor numpy fallback so the
    frame pipeline stays testable without OpenCV."""
    w, h = wh
    try:
        import cv2

        return cv2.resize(img, (w, h))
    except ImportError:
        yi = (np.arange(h) * img.shape[0] / h).astype(int)
        xi = (np.arange(w) * img.shape[1] / w).astype(int)
        return img[yi][:, xi]


class AutosysCamera(RealWorldCamera):
    """Hardware camera: raw frames via the tinycar library, optionally
    passed through the external VGG8U lane-segmentation net to produce
    tinycarlo-style class masks (reference env_autosys.py:17-50; RAW=1
    bypasses the net). Returns None (digital-twin view) when the
    hardware is unavailable.

    Pipeline per frame (reference capture_frame, env_autosys.py:33-50):
    `tinycar.getLastImage()` -> resize to 320x224 -> /255 float32 CHW ->
    either the segmentation net's 5 class masks (x255, resized to the
    configured resolution) or, under RAW=1, the 3 raw channels as
    pseudo-masks. A frame of None (camera not streaming yet) yields the
    reference's zero frame."""

    NET_INPUT = (320, 224)  # (w, h), reference env_autosys.py:36
    N_CLASSES = 5

    def __init__(self, resolution=(224, 320), hostname: str = "localhost"):
        self.resolution = tuple(resolution)  # (h, w), env layout
        self.hostname = hostname
        self._get_frame = None
        self._segment = None

    def connect(self) -> None:
        try:
            from tinycar import Tinycar  # external hardware library
        except ImportError:
            return
        # the hardware frame stream (reference env_autosys.py:21,34)
        self._get_frame = Tinycar(self.hostname).getLastImage
        if not getenv("RAW"):
            self._segment = self._load_segmentation()

    def _load_segmentation(self):
        """The reference's lane-segmentation net (env_autosys.py:13,
        28-31,41-43): VGG8U(7) from the external `lanedetection`
        package, pretrained, eval mode. Returns a
        `f32 CHW (3,224,320) -> (7,h',w') logits` callable or None."""
        try:
            import torch
            from lanedetection.models.unet import VGG8U
        except ImportError:
            return None
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        model = VGG8U(7)
        model.load_pretrained(device)
        model.to(device)
        model.eval()

        def run(chw: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                x = torch.from_numpy(chw).to(device).unsqueeze(0)
                return model(x)[0].cpu().numpy()

        return run

    def capture(self):
        if self._get_frame is None:
            return None  # no hardware: digital-twin view
        image = self._get_frame()
        h, w = self.resolution
        if image is None:
            # camera connected but not streaming yet: the reference
            # returns a zero frame (env_autosys.py:47-49)
            return np.zeros((self.N_CLASSES, h, w), np.float32)
        chw = (
            np.asarray(_resize(image, self.NET_INPUT), np.float32) / 255.0
        ).transpose(2, 0, 1)
        if self._segment is None:  # RAW: channels as pseudo-masks (:37-39)
            return np.stack(
                [_resize(chw[i] * 255.0, (w, h)) for i in range(3)], axis=0
            )
        y = self._segment(chw)
        return np.stack(
            [_resize(y[i] * 255.0, (w, h)) for i in range(self.N_CLASSES)],
            axis=0,
        )
