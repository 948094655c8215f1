"""Copy of vision_processor_tpu/net/udp.py for the port.

Multicast protobuf sockets: vision bus, game-controller bus, clock sync.

The wire protocol is the SSL multicast bus the reference speaks
(reference src/udpsocket.cpp:27-329): SSL_WrapperPacket on 224.5.23.2:10006,
game-controller Referee on 224.5.23.1:10003. Includes the per-camera naive
tracker fed by received detection frames and the decentralized t_offsets
clock synchronization.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass

from ..proto import Referee, SSL_GeometryData, SSL_WrapperPacket
from ..utils.log import get_logger

log = get_logger(__name__)

# Global adjustable real-time offset shared by all sockets of this process
# (reference src/driver/cameradriver.cpp:24-27).
_real_time_offset_lock = threading.Lock()
_real_time_offset = 0.0


def get_real_time() -> float:
    with _real_time_offset_lock:
        return time.time() + _real_time_offset


def _nudge_real_time(delta: float) -> None:
    global _real_time_offset
    with _real_time_offset_lock:
        _real_time_offset += delta


def open_multicast_socket(ip: str, port: int) -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, struct.pack("b", 32))
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.bind((ip, port))
    try:
        sock.setsockopt(
            socket.IPPROTO_IP,
            socket.IP_ADD_MEMBERSHIP,
            struct.pack("4sl", socket.inet_aton(ip), socket.INADDR_ANY),
        )
    except OSError:
        log.warning("Could not join multicast group %s", ip)
    return sock


class UDPSocket:
    """Protobuf multicast socket with a background receiver thread."""

    def __init__(self, ip: str, port: int):
        self.address = (ip, port)
        self.sock = open_multicast_socket(ip, port)
        self._closing = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def send(self, msg) -> None:
        try:
            self.sock.sendto(msg.SerializeToString(), self.address)
        except OSError as exc:
            log.warning("UDP send failed: %s", exc)

    def close(self) -> None:
        self._closing = True
        try:
            # unblock the receiver
            self.sock.sendto(b"", self.address)
        except OSError:
            pass
        self._thread.join(timeout=1.0)
        self.sock.close()

    def _run(self) -> None:
        while not self._closing:
            try:
                data = self.sock.recv(65535)
            except OSError:
                return
            if self._closing:
                return
            if data:
                try:
                    self._parse(data)
                except Exception as exc:
                    log.warning("Packet parse failed: %s", exc)

    def _parse(self, data: bytes) -> None:
        raise NotImplementedError


@dataclass
class TrackingState:
    """Tracked object: id -1 = ball, 0-15 yellow bot, 16-31 blue bot."""

    id: int
    timestamp: float
    x: float
    y: float
    z: float
    w: float
    vx: float
    vy: float
    vz: float
    vw: float
    confidence: float
    age: int


def _associate(objects, previous, obj_id, timestamp, x, y, z, w, confidence):
    """Nearest-previous association with finite-difference velocities
    (reference src/udpsocket.cpp:151-201)."""
    best = None
    best_d = float("inf")
    for old in previous:
        if old.id != obj_id:
            continue
        d = (x - old.x) ** 2 + (y - old.y) ** 2 + (z - old.z) ** 2
        if d <= best_d:
            best_d = d
            best = old
    if best is None:
        objects.append(
            TrackingState(obj_id, timestamp, x, y, z, w, 0, 0, 0, 0, confidence, 1)
        )
    else:
        dt = timestamp - best.timestamp
        if dt == 0:
            dt = float("inf")
        objects.append(
            TrackingState(
                obj_id,
                timestamp,
                x,
                y,
                z,
                w,
                (x - best.x) / dt,
                (y - best.y) / dt,
                (z - best.z) / dt,
                (w - best.w) / dt,
                confidence,
                best.age + 1,
            )
        )


class VisionSocket(UDPSocket):
    """SSL vision bus: geometry intake, cross-camera tracking, clock sync."""

    def __init__(self, ip: str, port: int, cam_id: int, default_bot_height: float):
        self.cam_id = cam_id
        self.default_bot_height = default_bot_height
        self.ball_radius = 21.5

        self._geometry = SSL_GeometryData()
        self._received_geometry = SSL_GeometryData()
        self._geometry_version = 0
        self._geometry_lock = threading.Lock()

        self._tracked: dict[int, list[TrackingState]] = {}
        self._tracked_lock = threading.Lock()

        self._sent_offsets: list[float] = []  # local.t_sent - other.time
        self._received_offsets: list[float] = []  # other.t_sent - local.time
        self._offset_lock = threading.Lock()

        super().__init__(ip, port)

    # -- geometry -----------------------------------------------------------

    def geometry_check(self) -> None:
        """Adopt the last received geometry when it differs
        (reference src/udpsocket.cpp:119-130)."""
        with self._geometry_lock:
            if (
                self._received_geometry.SerializePartialToString(deterministic=True)
                != self._geometry.SerializePartialToString(deterministic=True)
            ):
                self._geometry.CopyFrom(self._received_geometry)
                if self._geometry.field.HasField("ball_radius"):
                    self.ball_radius = self._geometry.field.ball_radius
                self._geometry_version += 1
                log.info("New geometry received")

    @property
    def geometry_version(self) -> int:
        return self._geometry_version

    @property
    def geometry(self) -> SSL_GeometryData:
        return self._geometry

    # -- tracking -----------------------------------------------------------

    def get_tracked_objects(self) -> dict[int, list[TrackingState]]:
        with self._tracked_lock:
            return {k: list(v) for k, v in self._tracked.items()}

    # -- clock sync ---------------------------------------------------------

    def get_received_offsets(self) -> list[float]:
        with self._offset_lock:
            return list(self._received_offsets)

    def update_time(self) -> None:
        """Nudge the shared real-time offset towards the fleet mean
        (reference src/udpsocket.cpp:259-282)."""
        with self._offset_lock:
            cams = len(self._received_offsets)
            offset = sum(
                self._received_offsets[c] - self._sent_offsets[c]
                for c in range(cams)
                if c != self.cam_id
            )
        if cams == 0:
            return
        offset /= 2 * cams
        if offset < -0.010:
            log.warning("Large backwards time jump suppressed: %fs", offset)
            return
        _nudge_real_time(offset)

    # -- parsing ------------------------------------------------------------

    def _parse(self, data: bytes) -> None:
        wrapper = SSL_WrapperPacket()
        wrapper.ParseFromString(data)
        if wrapper.HasField("detection"):
            self._time_synchronization(wrapper.detection)
            self._detection_tracking(wrapper.detection)
        if wrapper.HasField("geometry"):
            with self._geometry_lock:
                self._received_geometry.CopyFrom(wrapper.geometry)

    def _detection_tracking(self, detection) -> None:
        timestamp = detection.t_capture
        with self._tracked_lock:
            previous = list(self._tracked.get(detection.camera_id, []))
        objects: list[TrackingState] = []
        for ball in detection.balls:
            z = ball.z if ball.HasField("z") else self.ball_radius
            _associate(
                objects, previous, -1, timestamp, ball.x, ball.y, z, 0.0,
                ball.confidence,
            )
        for bots, offset in ((detection.robots_yellow, 0), (detection.robots_blue, 16)):
            for bot in bots:
                height = (
                    bot.height if bot.HasField("height") else self.default_bot_height
                )
                _associate(
                    objects, previous, bot.robot_id + offset, timestamp,
                    bot.x, bot.y, height, bot.orientation, bot.confidence,
                )
        with self._tracked_lock:
            self._tracked[detection.camera_id] = objects

    def _time_synchronization(self, detection) -> None:
        local = get_real_time()
        sender = detection.camera_id
        with self._offset_lock:
            while len(self._received_offsets) <= sender:
                self._received_offsets.append(0.0)
                self._sent_offsets.append(0.0)
            self._received_offsets[sender] = detection.t_sent - local
            if len(detection.t_offsets) > self.cam_id:
                self._sent_offsets[sender] = detection.t_offsets[self.cam_id]


class GCSocket(UDPSocket):
    """Game-controller bus: team names -> robot heights
    (reference src/udpsocket.cpp:304-329)."""

    def __init__(self, ip: str, port: int, bot_heights: dict[str, float]):
        self.bot_heights = bot_heights
        self.max_bot_height = max(bot_heights.values()) if bot_heights else 150.0
        self.default_bot_height = (
            sum(bot_heights.values()) / len(bot_heights) if bot_heights else 145.0
        )
        self.yellow_bot_height = self.default_bot_height
        self.blue_bot_height = self.default_bot_height
        super().__init__(ip, port)

    def _parse(self, data: bytes) -> None:
        ref = Referee()
        ref.ParseFromString(data)
        y = self.bot_heights.get(ref.yellow.name)
        if y is not None and y != self.yellow_bot_height:
            self.yellow_bot_height = y
            log.info("Updated yellow bot height to %smm", y)
        b = self.bot_heights.get(ref.blue.name)
        if b is not None and b != self.blue_bot_height:
            self.blue_bot_height = b
            log.info("Updated blue bot height to %smm", b)
