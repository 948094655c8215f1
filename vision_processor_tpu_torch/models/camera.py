"""Pinhole camera model with single-k2 radial distortion (PyTorch port).

Counterpart of vision_processor_tpu/models/camera.py. The host-side
``CameraModel`` (numpy, float64) and the field-cell helpers are carried
over unchanged; the device-side projections on the packed float32[18]
parameter vector (``field2image_packed``, ``image2field_packed``) are
written in torch and run on whatever device their tensors live on.

The SSL protobuf bindings are imported only where a proto is built
(``to_proto``), so the projection code imports without protobuf.

Packed layout (float32[18]):
  [0]     focal length (px)
  [1:3]   principal point (px)
  [3]     distortion k2
  [4:13]  field->image rotation matrix, row major
  [13:16] camera position in field coordinates (mm)
  [16:18] image size (w, h) as floats
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

PACKED_SIZE = 18


def goal_boundary_width(fieldsz) -> float:
    """Boundary width behind the goal lines (falls back to boundary_width).

    Reference src/CameraModel.cpp:20-22.
    """
    if fieldsz.HasField("boundary_width_goal_line"):
        return float(fieldsz.boundary_width_goal_line)
    return float(fieldsz.boundary_width)


def visible_field_extent_estimation(
    cam_id: int,
    cam_amount: int,
    fieldsz,
    with_boundary: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Estimate the field cell covered by camera ``cam_id``.

    The field is split into a 2^n grid by repeatedly halving the currently
    longer side; cam ids are assigned column-major (matches ssl-vision's
    camera_ids layout; reference src/CameraModel.cpp:24-60).
    Returns (min, max) field-coordinate corners in mm.
    """
    field_size = np.array(
        [fieldsz.field_length, fieldsz.field_width], dtype=np.float32
    )

    grid = np.array([1, 1], dtype=np.int64)
    i = cam_amount
    while i > 1:
        if field_size[0] / grid[0] >= field_size[1] / grid[1]:
            grid[0] *= 2
        else:
            grid[1] *= 2
        i //= 2

    pos = np.array([0, 0], dtype=np.int64)
    for _ in range(cam_id % cam_amount):
        pos[1] += 1
        if pos[1] == grid[1]:
            pos[1] = 0
            pos[0] += 1

    extent = field_size / grid
    lo = extent * pos - field_size / 2
    hi = lo + extent

    if with_boundary:
        if pos[0] == 0:
            lo[0] -= goal_boundary_width(fieldsz)
        if pos[1] == 0:
            lo[1] -= float(fieldsz.boundary_width)
        if pos[0] == grid[0] - 1:
            hi[0] += goal_boundary_width(fieldsz)
        if pos[1] == grid[1] - 1:
            hi[1] += float(fieldsz.boundary_width)

    return lo, hi


def _quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return _quat_normalize(np.array([x, y, z, w], dtype=np.float64))


def euler_to_matrix(euler: np.ndarray) -> np.ndarray:
    """Intrinsic XYZ euler angles -> rotation matrix (Rx @ Ry @ Rz)."""
    cx, cy, cz = np.cos(euler)
    sx, sy, sz = np.sin(euler)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float64)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float64)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype=np.float64)
    return rx @ ry @ rz


def matrix_to_euler(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> intrinsic XYZ euler angles.

    Matches Eigen's eulerAngles(0, 1, 2) range conventions closely enough
    for round-tripping through euler_to_matrix.
    """
    sy = m[0, 2]
    sy = np.clip(sy, -1.0, 1.0)
    y = np.arcsin(sy)
    if abs(sy) < 0.9999999:
        x = np.arctan2(-m[1, 2], m[2, 2])
        z = np.arctan2(-m[0, 1], m[0, 0])
    else:
        x = np.arctan2(m[1, 0], m[1, 1])
        z = 0.0
    return np.array([x, y, z], dtype=np.float64)


@dataclass
class CameraModel:
    """Host-side camera model (numpy, float64 for calibration stability)."""

    focal_length: float = 1224.0
    principal_point: np.ndarray = field(
        default_factory=lambda: np.array([612.0, 512.0])
    )
    distortion_k2: float = 0.0
    pos: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 5000.0]))
    # field->image orientation quaternion (x, y, z, w); default looks straight
    # down with image x along field x (reference src/CameraModel.h:50).
    quat: np.ndarray = field(default_factory=lambda: np.array([-1.0, 0.0, 0.0, 0.0]))
    size: np.ndarray = field(default_factory=lambda: np.array([1224, 1024]))

    def __post_init__(self) -> None:
        self.principal_point = np.asarray(self.principal_point, dtype=np.float64)
        self.pos = np.asarray(self.pos, dtype=np.float64)
        self.quat = _quat_normalize(np.asarray(self.quat, dtype=np.float64))
        self.size = np.asarray(self.size, dtype=np.int64)

    @classmethod
    def initial_guess(
        cls,
        size: np.ndarray,
        cam_id: int,
        cam_amount: int,
        camera_height: float,
        fieldsz,
    ) -> "CameraModel":
        """Initial model above the center of this camera's grid cell with the
        whole cell visible (reference src/CameraModel.cpp:67-83)."""
        size = np.asarray(size, dtype=np.int64)
        lo, hi = visible_field_extent_estimation(cam_id, cam_amount, fieldsz, True)
        pos = np.array([0.0, 0.0, 5000.0])
        pos[:2] = (lo + hi) / 2
        if camera_height != 0.0:
            pos[2] = camera_height

        principal = size.astype(np.float64) / 2
        ordered_size = np.array([size.max(), size.min()], dtype=np.float64)
        extent = hi - lo
        ordered_extent = np.array([extent.max(), extent.min()])
        focal = ((ordered_size - principal) * pos[2] / ordered_extent).min() * 2

        return cls(
            focal_length=float(focal),
            principal_point=principal,
            pos=pos,
            size=size,
        )

    @classmethod
    def from_proto(cls, calib) -> "CameraModel":
        quat = _quat_normalize(
            np.array([calib.q0, calib.q1, calib.q2, calib.q3], dtype=np.float64)
        )
        rot = quat_to_matrix(quat)
        # pos = R^-1 * -t  (reference src/CameraModel.cpp:92)
        t = np.array([calib.tx, calib.ty, calib.tz], dtype=np.float64)
        pos = rot.T @ -t
        size = np.array(
            [calib.pixel_image_width or 1224, calib.pixel_image_height or 1024]
        )
        return cls(
            focal_length=calib.focal_length,
            principal_point=np.array(
                [calib.principal_point_x, calib.principal_point_y]
            ),
            distortion_k2=calib.distortion,
            pos=pos,
            quat=quat,
            size=size,
        )

    def to_proto(self, cam_id: int):
        from ..proto import SSL_GeometryCameraCalibration

        proto = SSL_GeometryCameraCalibration()
        proto.camera_id = cam_id
        proto.focal_length = float(self.focal_length)
        proto.principal_point_x = float(self.principal_point[0])
        proto.principal_point_y = float(self.principal_point[1])
        proto.distortion = float(self.distortion_k2)
        proto.q0, proto.q1, proto.q2, proto.q3 = (float(v) for v in self.quat)
        t = self.rotation() @ -self.pos
        proto.tx, proto.ty, proto.tz = (float(v) for v in t)
        proto.derived_camera_world_tx = float(self.pos[0])
        proto.derived_camera_world_ty = float(self.pos[1])
        proto.derived_camera_world_tz = float(self.pos[2])
        proto.pixel_image_width = int(self.size[0])
        proto.pixel_image_height = int(self.size[1])
        return proto

    def rotation(self) -> np.ndarray:
        """Field->image rotation matrix."""
        return quat_to_matrix(self.quat)

    def get_euler(self) -> np.ndarray:
        return matrix_to_euler(self.rotation())

    def update_euler(self, euler: np.ndarray) -> None:
        self.quat = matrix_to_quat(euler_to_matrix(np.asarray(euler)))

    def ensure_size(self, new_size: np.ndarray) -> None:
        """Rescale intrinsics when the image resolution changes
        (reference src/CameraModel.cpp:124-135)."""
        new_size = np.asarray(new_size, dtype=np.int64)
        if np.array_equal(self.size, new_size):
            return
        factor = float(new_size[0]) / float(self.size[0])
        self.size = new_size
        self.focal_length *= factor
        self.principal_point = self.principal_point * factor

    def normalize_undistort(self, p: np.ndarray) -> np.ndarray:
        """Image px -> normalized undistorted ray xy. Accepts (..., 2)."""
        p = np.asarray(p, dtype=np.float64)
        n = (p - self.principal_point) / self.focal_length
        r2 = np.sum(n * n, axis=-1, keepdims=True)
        return n * (1.0 + self.distortion_k2 * r2)

    def undistort(self, p: np.ndarray) -> np.ndarray:
        return self.normalize_undistort(p) * self.focal_length + self.principal_point

    def field2image(self, p: np.ndarray, iterations: int = 10) -> np.ndarray:
        """Field mm (..., 3) -> image px (..., 2).

        Distortion applied by fixed-point iteration, matching the reference's
        10 iterations (reference src/CameraModel.cpp:147-157).
        """
        p = np.asarray(p, dtype=np.float64)
        cam_ray = (p - self.pos) @ self.rotation().T
        normalized = cam_ray[..., :2] / cam_ray[..., 2:3]
        original = normalized
        for _ in range(iterations):
            r2 = np.sum(normalized * normalized, axis=-1, keepdims=True)
            normalized = original / (1.0 + self.distortion_k2 * r2)
        return self.focal_length * normalized + self.principal_point

    def image2field(self, p: np.ndarray, height: float) -> np.ndarray:
        """Image px (..., 2) -> field mm (..., 3) at plane z=height.

        Rays pointing away from the carpet yield NaN
        (reference src/CameraModel.cpp:159-172).
        """
        n = self.normalize_undistort(p)
        ray = np.concatenate([n, np.ones_like(n[..., :1])], axis=-1)
        ray = ray @ self.rotation()  # R^T @ ray, batched
        bad = ray[..., 2] >= 0
        scale = (-self.pos[2] + height) / ray[..., 2]
        out = ray * scale[..., None] + self.pos
        out[..., 2] = height
        if np.ndim(bad) == 0:
            if bad:
                out = np.full_like(out, np.nan)
        else:
            out[bad] = np.nan
        return out

    def packed(self) -> np.ndarray:
        """Pack into the float32[18] layout of the device-side projections."""
        out = np.zeros(PACKED_SIZE, dtype=np.float32)
        out[0] = self.focal_length
        out[1:3] = self.principal_point
        out[3] = self.distortion_k2
        out[4:13] = self.rotation().reshape(-1)
        out[13:16] = self.pos
        out[16:18] = self.size
        return out


# --------------------------------------------------------------------------
# torch device-side projection on packed parameters
# --------------------------------------------------------------------------


def _rows(v: torch.Tensor, rot: torch.Tensor, transpose: bool) -> list:
    """v (..., 3) times rot.T (or rot) as three explicit dot products
    (deterministic on every device; no TF32 matmul path)."""
    out = []
    for i in range(3):
        if transpose:  # (v @ rot.T)[..., i] = sum_j v_j rot[i, j]
            w = (rot[i, 0], rot[i, 1], rot[i, 2])
        else:          # (v @ rot)[..., i] = sum_j v_j rot[j, i]
            w = (rot[0, i], rot[1, i], rot[2, i])
        out.append(v[..., 0] * w[0] + v[..., 1] * w[1] + v[..., 2] * w[2])
    return out


def field2image_packed(packed: torch.Tensor, fieldpos: torch.Tensor,
                       iterations: int = 8) -> torch.Tensor:
    """Field mm (..., 3) -> image px (..., 2), float32.

    Uses 8 distortion iterations like the device-side kernel in the reference
    (reference kernel/resampling.cl:29-48); the host model uses 10.
    """
    f = packed[0]
    k2 = packed[3]
    rot = packed[4:13].reshape(3, 3)
    cam = packed[13:16]

    rel = fieldpos - cam
    rx, ry, rz = _rows(rel, rot, transpose=True)
    nx = rx / rz
    ny = ry / rz
    ox, oy = nx, ny
    for _ in range(iterations):
        r2 = nx * nx + ny * ny
        d = 1.0 + k2 * r2
        nx = ox / d
        ny = oy / d
    return torch.stack([f * nx + packed[1], f * ny + packed[2]], dim=-1)


def image2field_packed(packed: torch.Tensor, imgpos: torch.Tensor,
                       height) -> torch.Tensor:
    """Image px (..., 2) -> field mm (..., 3) at plane z=height (NaN where
    the ray points away from the carpet)."""
    f = packed[0]
    k2 = packed[3]
    rot = packed[4:13].reshape(3, 3)
    cam = packed[13:16]

    nx = (imgpos[..., 0] - packed[1]) / f
    ny = (imgpos[..., 1] - packed[2]) / f
    r2 = nx * nx + ny * ny
    d = 1.0 + k2 * r2
    nx = nx * d
    ny = ny * d
    ray = torch.stack([nx, ny, torch.ones_like(nx)], dim=-1)
    wx, wy, wz = _rows(ray, rot, transpose=False)
    height = torch.as_tensor(height, dtype=wz.dtype, device=wz.device)
    scale = (-cam[2] + height) / wz
    out = torch.stack(
        [wx * scale + cam[0], wy * scale + cam[1],
         torch.broadcast_to(height, wz.shape)],
        dim=-1,
    )
    bad = wz >= 0
    return torch.where(bad[..., None], torch.full_like(out, float("nan")), out)
