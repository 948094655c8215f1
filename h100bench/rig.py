"""A deployment's rig as the benchmark builds it: the field, the ceiling
cameras and their calibrations, and the port's YAML files.

Everything here is the benchmark's own arithmetic from the numbers in
``configs/<name>.json``: the field markings follow the SSL rules' layout,
the cameras hang over the cells of SSL-Vision's camera grid (the field
halved along its longer side until there is one cell a camera), and the
camera model is a pinhole with one radial k2 term, the model that the SSL
geometry packet carries. Nothing of the program is imported.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def camera_cells(field_length: float, field_width: float, n_cams: int) -> list:
    """SSL-Vision's camera grid: the field is halved along its longer cell
    side until there is one cell a camera; camera ids run across the
    field's width first. Returns each camera's (lo, hi) corners in mm."""
    size = np.array([field_length, field_width], dtype=np.float64)
    grid = np.array([1, 1])
    i = n_cams
    while i > 1:
        axis = 0 if size[0] / grid[0] >= size[1] / grid[1] else 1
        grid[axis] *= 2
        i //= 2
    if grid.prod() != n_cams:
        raise ValueError(f"{n_cams} cameras do not tile the field by halving")
    cell = size / grid
    out = []
    for c in range(n_cams):
        pos = np.array([c // grid[1], c % grid[1]])
        lo = cell * pos - size / 2
        out.append((lo, lo + cell))
    return out


def quat_matrix(q) -> np.ndarray:
    """Quaternion (x, y, z, w) to the field-to-image rotation matrix."""
    x, y, z, w = np.asarray(q, dtype=np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


@dataclass
class Camera:
    """Pinhole camera with one radial term, looking straight down (image x
    along field x), as the SSL geometry packet describes it."""

    cam_id: int
    focal: float
    principal: np.ndarray  # (2,) px
    k2: float
    pos: np.ndarray  # (3,) mm
    size: tuple  # (width, height) px of the camera model
    quat: tuple = (-1.0, 0.0, 0.0, 0.0)

    @property
    def rot(self) -> np.ndarray:
        return quat_matrix(self.quat)

    def field2image(self, p: np.ndarray, iterations: int = 10) -> np.ndarray:
        """Field mm (..., 3) to image px (..., 2); the distortion is applied
        by fixed-point iteration."""
        ray = (np.asarray(p, dtype=np.float64) - self.pos) @ self.rot.T
        n0 = ray[..., :2] / ray[..., 2:3]
        n = n0
        for _ in range(iterations):
            n = n0 / (1.0 + self.k2 * np.sum(n * n, axis=-1, keepdims=True))
        return self.focal * n + self.principal

    def image2field(self, px, height: float, xp=np):
        """Image px (..., 2) to field mm (..., 2) on the plane z = height;
        ``xp`` is numpy or torch (float64 tensors)."""
        n = (px - xp.asarray(self.principal) if xp is np
             else px - xp.tensor(self.principal, dtype=px.dtype, device=px.device))
        n = n / self.focal
        n = n * (1.0 + self.k2 * (n * n).sum(-1, keepdims=True))
        r = self.rot.tolist()  # the ray in field coordinates: R^T (n, 1)
        px_, py_, pz_ = (float(v) for v in self.pos)
        rx = r[0][0] * n[..., 0] + r[1][0] * n[..., 1] + r[2][0]
        ry = r[0][1] * n[..., 0] + r[1][1] * n[..., 1] + r[2][1]
        rz = r[0][2] * n[..., 0] + r[1][2] * n[..., 1] + r[2][2]
        s = (height - pz_) / rz
        return xp.stack([rx * s + px_, ry * s + py_], -1)

    def calibration(self) -> dict:
        """The SSL_GeometryCameraCalibration fields of this camera."""
        t = self.rot @ -self.pos
        return {
            "camera_id": self.cam_id, "focal_length": self.focal,
            "principal_point_x": float(self.principal[0]),
            "principal_point_y": float(self.principal[1]), "distortion": self.k2,
            "q0": self.quat[0], "q1": self.quat[1], "q2": self.quat[2], "q3": self.quat[3],
            "tx": float(t[0]), "ty": float(t[1]), "tz": float(t[2]),
            "derived_camera_world_tx": float(self.pos[0]),
            "derived_camera_world_ty": float(self.pos[1]),
            "derived_camera_world_tz": float(self.pos[2]),
            "pixel_image_width": int(self.size[0]), "pixel_image_height": int(self.size[1]),
        }


def f32(v: float) -> float:
    return float(np.float32(v))


def field_markings(field: dict) -> tuple[list, list]:
    """The SSL rules' markings from the field's dimensions: touch, goal,
    halfway and centre lines, both penalty areas and the centre circle, as
    ((name, x1, y1, x2, y2, thickness) lines, (name, cx, cy, r, a1, a2,
    thickness) arcs), in float32 as the geometry packet carries them."""
    hl, hw = field["field_length"] / 2, field["field_width"] / 2
    th = f32(field["line_thickness"])
    px = hl - field["penalty_area_depth"]
    hp = field["penalty_area_width"] / 2
    raw = [
        ("TopTouchLine", -hl, hw, hl, hw), ("BottomTouchLine", -hl, -hw, hl, -hw),
        ("LeftGoalLine", -hl, -hw, -hl, hw), ("RightGoalLine", hl, -hw, hl, hw),
        ("HalfwayLine", 0, -hw, 0, hw), ("CenterLine", -hl, 0, hl, 0),
        ("LeftPenaltyStretch", -px, -hp, -px, hp), ("RightPenaltyStretch", px, -hp, px, hp),
        ("LeftFieldLeftPenaltyStretch", -hl, -hp, -px, -hp),
        ("LeftFieldRightPenaltyStretch", -hl, hp, -px, hp),
        ("RightFieldLeftPenaltyStretch", px, hp, hl, hp),
        ("RightFieldRightPenaltyStretch", px, -hp, hl, -hp),
    ]
    lines = [(n, f32(a), f32(b), f32(c), f32(d), th) for n, a, b, c, d in raw]
    arcs = [("CenterCircle", 0.0, 0.0, f32(field["center_circle_radius"]), 0.0,
             f32(2 * math.pi), th)]
    return lines, arcs


@dataclass
class Rig:
    """A deployment: its configuration file's numbers, cameras and field."""

    config: dict
    cameras: list
    lines: list
    arcs: list

    @property
    def field(self) -> dict:
        return self.config["field"]

    @property
    def n_cams(self) -> int:
        return len(self.cameras)

    @property
    def fps(self) -> float:
        return float(self.config["camera_fps"])


def build_rig(config: dict) -> Rig:
    optics = config["optics"]
    field = config["field"]
    w, h = int(optics["model_width"]), int(optics["model_height"])
    cams = []
    for c, (lo, hi) in enumerate(camera_cells(field["field_length"], field["field_width"],
                                              int(config["cameras"]))):
        centre = (lo + hi) / 2
        cams.append(Camera(
            cam_id=c, focal=f32(optics["focal_length_px"]),
            principal=np.array([w / 2, h / 2]), k2=f32(optics["distortion_k2"]),
            pos=np.array([centre[0], centre[1], float(optics["camera_height_mm"])]),
            size=(w, h)))
    lines, arcs = field_markings(field)
    return Rig(config, cams, lines, arcs)


def deployment_files(rig: Rig, workdir: Path, group: str, port: int, gc_port: int,
                     driver: str) -> list[Path]:
    """One YAML file a camera, in the port's schema: the deployment's own
    keys from the configuration file, the benchmark's camera driver, and
    the run's bus address. No robot heights file exists, so the app takes
    its default robot height for both teams."""
    import copy

    paths = []
    for cam in rig.cameras:
        doc = copy.deepcopy(rig.config["deployment"])
        doc["cam_id"] = cam.cam_id
        doc["bot_heights_file"] = str(workdir / "no-robot-heights.yml")
        doc["camera"] = {"driver": driver, "id": cam.cam_id}
        doc.setdefault("geometry", {})["camera_amount"] = rig.n_cams
        doc["network"] = {"vision_ip": group, "vision_port": port,
                          "gc_ip": group, "gc_port": gc_port}
        path = workdir / f"camera{cam.cam_id}.yml"
        path.write_text(json.dumps(doc, indent=1))  # JSON is YAML
        paths.append(path)
    return paths
