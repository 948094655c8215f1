"""Camera drivers: frame sources for the pipeline (PyTorch port).

Counterpart of vision_processor_tpu/io/camera.py: the driver surface
(reference src/driver/cameradriver.h:35-47), the registry, the
``OpenCVDriver`` (file replay and OpenCV capture) and the
``SyntheticDriver``. Frames stay host numpy arrays; the processor uploads
them to its device. ``open_camera`` imports the V4L2 (io/native.py),
vendor (io/vendor.py: Spinnaker, mvIMPACT) and GenICam (io/genicam.py:
Aravis) drivers on first use; each raises RuntimeError without its
library or SDK.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

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


class OpenCVDriver(CameraDriver):
    """File replay (video/image) and device capture via OpenCV.

    File time is frame_index / fps for reproducible replays (reference
    src/driver/opencvdriver.cpp:82-89). Frames are delivered as BGR; the
    camera model then runs at full file resolution. An image file replays
    as one frame.
    """

    def __init__(self, cfg: CameraSection):
        import cv2

        self._image = None
        self._cap = None
        self._frame_idx = 0
        self._fps = 30.0
        self._is_file = False

        path = cfg.path
        if path is not None and Path(path).suffix.lower() in (
            ".png", ".jpg", ".jpeg", ".bmp",
        ):
            self._image = cv2.imread(str(path), cv2.IMREAD_COLOR)
            if self._image is None:
                raise FileNotFoundError(path)
            self._is_file = True
        else:
            self._cap = cv2.VideoCapture(path if path is not None else cfg.id)
            if not self._cap.isOpened():
                raise RuntimeError(f"cannot open camera source {path or cfg.id}")
            fps = self._cap.get(cv2.CAP_PROP_FPS)
            if fps and fps > 0:
                self._fps = fps
            self._is_file = path is not None
            if cfg.width:
                self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.width)
            if cfg.height:
                self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.height)

    @property
    def fmt(self) -> str:
        return "BGR"

    def expected_frametime(self) -> float:
        return 1.0 / self._fps

    def get_time(self) -> float:
        if self._is_file:
            return self._frame_idx / self._fps
        return super().get_time()

    def read_image(self) -> RawFrame | None:
        if self._image is not None:
            if self._frame_idx >= 1:
                return None
            self._frame_idx += 1
            frame = self._image
        else:
            self._frame_idx += 1
            ok, frame = self._cap.read()
            if not ok:
                return None
        h, w = frame.shape[:2]
        return RawFrame(data=frame, fmt="BGR", width=w, height=h)

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()


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
    if name == "OPENCV":
        return OpenCVDriver(cfg)
    if name == "V4L2":
        from . import native  # registers the driver

        return _DRIVERS["V4L2"](cfg)
    if name in ("SPINNAKER", "MVIMPACT"):
        from . import vendor  # registers both; raises without the SDK

        return _DRIVERS[name](cfg)
    if name in ("GENICAM", "ARAVIS"):
        from . import genicam  # registers both; raises without libaravis

        return _DRIVERS[name](cfg)
    raise ValueError(f"unknown camera driver {cfg.driver}")
