"""UDP multicast pose tracking listener.

The port's own copy of tinycarlo_tpu/real_world/tracking.py (pure Python).
Generic equivalent of the reference's CarTracking (reference:
tinycarlo/real_world/environments/env_autosys.py:53-99): a background
thread joins a multicast group and unpacks `BHHf` packets
(camera_id: uint8, x_px: uint16, y_px: uint16, orientation_rad: float32),
keeping last-write-wins state per read (the reference's consume-on-read
semantics: get() returns the pending sample once, then None until the
next packet).
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional, Tuple

DEFAULT_GROUP = "239.255.255.250"
DEFAULT_PORT = 5565
PACKET = struct.Struct("BHHf")

Sample = Tuple[int, float, float, float]  # (camera_id, x_px, y_px, rot_rad)


class PoseTracker:
    def __init__(
        self,
        group: str = DEFAULT_GROUP,
        port: int = DEFAULT_PORT,
        transform: Optional[Callable[[Sample], Sample]] = None,
    ):
        """`transform` can apply per-camera perspective/homography
        corrections (the reference hardcodes one for camera id 2,
        env_autosys.py:70-85)."""
        self.group, self.port = group, port
        self.transform = transform
        self._latest: Optional[Sample] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None

    def start(self) -> None:
        self._sock = socket.socket(
            socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP
        )
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", self.port))
        mreq = struct.pack(
            "4sl", socket.inet_aton(self.group), socket.INADDR_ANY
        )
        self._sock.setsockopt(
            socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq
        )
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(PACKET.size)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) != PACKET.size:
                continue
            cam_id, x, y, rot = PACKET.unpack(data)
            sample: Sample = (cam_id, float(x), float(y), float(rot))
            if self.transform is not None:
                sample = self.transform(sample)
            with self._lock:
                self._latest = sample

    def get(self) -> Optional[Sample]:
        """Consume the latest sample (None when nothing new arrived)."""
        with self._lock:
            s, self._latest = self._latest, None
        return s

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
