"""Camera drivers: frame sources for the pipeline (PyTorch port).

Counterpart of vision_processor_tpu/io/camera.py: the driver surface
(reference src/driver/cameradriver.h:35-47), the registry and the
``SyntheticDriver``. Frames stay host numpy arrays; the processor uploads
them to its device. Native, vendor and GenICam drivers are not ported yet
(ROADMAP.md, "Port: camera drivers"); opening one raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.config import CameraSection
from ..utils.log import get_logger
from .synthetic import Scene, render_raw

log = get_logger(__name__)


@dataclass
class RawFrame:
    data: np.ndarray  # (2H, 2W) bayer uint8 or (H, W, 3) bgr uint8
    fmt: str  # RGGB / GRBG / BGR
    width: int  # camera-model (half for bayer) resolution
    height: int
    timestamp: float = 0.0  # camera hardware timestamp, 0 if unsupported


class CameraDriver:
    def read_image(self) -> RawFrame | None:
        raise NotImplementedError

    @property
    def fmt(self) -> str:
        raise NotImplementedError

    def expected_frametime(self) -> float:
        return 1.0 / 30.0

    def get_time(self) -> float:
        from ..net.udp import get_real_time

        return get_real_time()

    def close(self) -> None:
        pass


class SyntheticDriver(CameraDriver):
    """Renders a (possibly animated) synthetic scene each frame."""

    def __init__(
        self,
        model,
        field,
        scene: Scene,
        fmt: str = "RGGB",
        fps: float = 100.0,
        frames: int | None = None,
        animate=None,
    ):
        self.model = model
        self.field = field
        self.scene = scene
        self._fmt = fmt
        self._fps = fps
        self._frames = frames
        self._animate = animate
        self._idx = 0

    @property
    def fmt(self) -> str:
        return self._fmt

    def expected_frametime(self) -> float:
        return 1.0 / self._fps

    def get_time(self) -> float:
        return self._idx / self._fps

    def read_image(self) -> RawFrame | None:
        if self._frames is not None and self._idx >= self._frames:
            return None
        if self._animate is not None:
            self._animate(self.scene, self._idx / self._fps)
        raw = render_raw(self.model, self.field, self.scene, self._fmt)
        self._idx += 1
        w, h = int(self.model.size[0]), int(self.model.size[1])
        return RawFrame(data=raw, fmt=self._fmt, width=w, height=h)


_DRIVERS = {}


def register_driver(name: str, factory) -> None:
    """External registration point for camera drivers."""
    _DRIVERS[name.upper()] = factory


def open_camera(cfg: CameraSection) -> CameraDriver:
    """Driver factory (reference src/driver/cameradriver.cpp:74-89)."""
    name = (cfg.driver or "OPENCV").upper()
    if name in _DRIVERS:
        return _DRIVERS[name](cfg)
    if name in ("OPENCV", "V4L2", "SPINNAKER", "MVIMPACT", "GENICAM", "ARAVIS"):
        raise NotImplementedError(
            f"camera driver {name} is not ported yet "
            "(ROADMAP.md, 'Port: camera drivers')"
        )
    raise ValueError(f"unknown camera driver {cfg.driver}")
