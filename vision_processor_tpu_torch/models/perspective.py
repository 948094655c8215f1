"""Per-camera view of the field: resampling scale, visible extent, flat grid.

Counterpart of vision_processor_tpu/models/perspective.py, carried over
against the port's camera module (host numpy code; reference
src/Perspective.cpp:35-150).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..net.geometry_io import FieldSize
from ..utils.log import get_logger
from .camera import CameraModel, goal_boundary_width
from .pattern import CENTER_BLOB_RADIUS, SIDE_BLOB_RADIUS

log = get_logger(__name__)


@dataclass
class Perspective:
    """Takes an SSL_GeometryData proto or the plain ``net.geometry_io.Geometry``."""

    cam_id: int
    geometry_tolerance: float = 10.0

    field: object = dc_field(default_factory=FieldSize)
    model: CameraModel = dc_field(default_factory=CameraModel)

    # xmin, xmax, ymin, ymax in field mm
    visible_field_extent: np.ndarray = dc_field(
        default_factory=lambda: np.zeros(4, dtype=np.float64)
    )
    field_scale: float = 5.0  # [mm/px] of the flat grid
    reprojected_field_size: np.ndarray = dc_field(
        default_factory=lambda: np.zeros(2, dtype=np.int64)
    )

    min_blob_radius: float = 20.0  # [mm]
    max_blob_radius: float = 25.0  # [mm]

    geometry_version: int = 0

    def update_geometry(
        self,
        geometry,
        geometry_version: int,
        width: int,
        height: int,
        max_bot_height: float,
        resampling_factor: float,
    ) -> bool:
        """Adopt a new geometry + calibration for this camera.

        Returns True when this camera's calibration was found and derived
        values were recomputed (reference src/Perspective.cpp:35-125).
        """
        size = np.array([width, height], dtype=np.int64)
        if (
            geometry_version == self.geometry_version
            and np.array_equal(self.model.size, size)
        ):
            return False

        calib_found = None
        for calib in geometry.calib:
            if calib.camera_id == self.cam_id:
                calib_found = calib
                break
        if calib_found is None:
            if len(geometry.calib) == 0:
                # calibration cleared -> trigger recalibration
                self.geometry_version = 0
            return False

        self.model = CameraModel.from_proto(calib_found)
        self.model.ensure_size(size)
        self.geometry_version = geometry_version
        self.field = geometry.field

        ball_radius = (
            geometry.field.ball_radius if geometry.field.HasField("ball_radius") else 21.5
        )
        self.min_blob_radius = min(CENTER_BLOB_RADIUS, SIDE_BLOB_RADIUS, ball_radius)
        self.max_blob_radius = max(CENTER_BLOB_RADIUS, SIDE_BLOB_RADIUS, ball_radius)

        self._recompute_field_scale(width, height, max_bot_height, resampling_factor)
        self._recompute_extent(width, height, max_bot_height)
        return True

    def _recompute_field_scale(
        self, width: int, height: int, max_bot_height: float, resampling_factor: float
    ) -> None:
        """Average mm/px footprint of in-field image pixels
        (reference src/Perspective.cpp:72-92), vectorized."""
        xs, ys = np.meshgrid(
            np.arange(width, dtype=np.float64),
            np.arange(height, dtype=np.float64),
        )
        px = np.stack([xs, ys], axis=-1)
        pos = self.model.image2field(px, float(max_bot_height))[..., :2]

        half_len = self.field.field_length / 2 + goal_boundary_width(self.field)
        half_wid = self.field.field_width / 2 + self.field.boundary_width
        base = pos[:-1, :-1]
        inside = (
            (np.abs(base[..., 0]) < half_len)
            & (np.abs(base[..., 1]) < half_wid)
            & np.isfinite(base[..., 0])
        )

        dx = np.linalg.norm(pos[:-1, 1:] - base, axis=-1)
        dy = np.linalg.norm(pos[1:, :-1] - base, axis=-1)
        valid = inside & np.isfinite(dx) & np.isfinite(dy)
        n = valid.sum()
        if n == 0:
            log.warning("No in-field pixels while computing field scale")
            return
        self.field_scale = float(
            (dx[valid].sum() + dy[valid].sum()) / (2 * n) * resampling_factor
        )

    def _recompute_extent(self, width: int, height: int, max_bot_height: float) -> None:
        """Visible field extent from the projected image border, clamped to the
        field boundary (reference src/Perspective.cpp:94-125)."""
        xs = np.arange(width, dtype=np.float64)
        ys = np.arange(height, dtype=np.float64)
        border = np.concatenate(
            [
                np.stack([xs, np.zeros_like(xs)], axis=-1),
                np.stack([xs, np.full_like(xs, height - 1.0)], axis=-1),
                np.stack([np.zeros_like(ys), ys], axis=-1),
                np.stack([np.full_like(ys, width - 1.0), ys], axis=-1),
            ]
        )
        pts = self.model.image2field(border, float(max_bot_height))[..., :2]
        pts = pts[np.isfinite(pts).all(axis=-1)]
        if len(pts) == 0:
            log.warning("Camera sees no field plane at all")
            return
        extent = np.array(
            [pts[:, 0].min(), pts[:, 0].max(), pts[:, 1].min(), pts[:, 1].max()]
        )

        half_len = (
            self.field.field_length / 2
            + goal_boundary_width(self.field)
            + self.geometry_tolerance
        )
        half_wid = (
            self.field.field_width / 2
            + self.field.boundary_width
            + self.geometry_tolerance
        )
        extent[0] = max(extent[0], -half_len)
        extent[1] = min(extent[1], half_len)
        extent[2] = max(extent[2], -half_wid)
        extent[3] = min(extent[3], half_wid)
        self.visible_field_extent = extent

        size = np.array([extent[1] - extent[0], extent[3] - extent[2]])
        size = np.rint(size / self.field_scale).astype(np.int64)
        size += size % 2  # keep even for NV12 streaming
        self.reprojected_field_size = size
        log.info(
            "Visible field extent: %s mm (xmin,xmax,ymin,ymax), flat grid %s px",
            extent,
            size,
        )

    def flat2field(self, pos: np.ndarray) -> np.ndarray:
        """Flat-grid px (..., 2) -> field mm (..., 2)."""
        offset = np.array(
            [self.visible_field_extent[0], self.visible_field_extent[2]]
        )
        return np.asarray(pos) * self.field_scale + offset

    def field2flat(self, pos: np.ndarray) -> np.ndarray:
        """Field mm (..., 2) -> flat-grid px (..., 2)."""
        offset = np.array(
            [self.visible_field_extent[0], self.visible_field_extent[2]]
        )
        return (np.asarray(pos) - offset) / self.field_scale
