"""Field geometry as plain Python objects: no protobuf, no YAML.

Counterpart of vision_processor_tpu/net/geometry_io.py. ``geometry_from_dict``
takes the same schema (the ``field`` section of geometry.yml) and generates
the same standard markings, into plain objects that carry the attribute
names of SSL_GeometryData, SSL_GeometryFieldSize, SSL_FieldLineSegment,
SSL_FieldCircularArc and SSL_GeometryCameraCalibration, and their
``HasField``. ``Perspective``, ``render_raw`` and ``pack_field_marks`` take
them as they take the protos, so the device path runs where the protobuf
bindings are not installed. Float fields are rounded to float32, as the
protos store them, so a plain geometry and a parsed one give the same flat
grid and field marks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

import numpy as np

# SSL_GeometryFieldSize's scalar fields by wire type
_FIELD_INTS = (
    "field_length", "field_width", "goal_width", "goal_depth", "boundary_width",
    "boundary_width_goal_line", "penalty_area_depth", "penalty_area_width",
    "center_circle_radius", "line_thickness", "goal_center_to_penalty_mark",
    "goal_height", "goal_substitution_area_width",
)
_FIELD_FLOATS = ("ball_radius", "max_robot_radius")


def _f32(value) -> float:
    return float(np.float32(value))


@dataclass
class Vector2f:
    x: float
    y: float


@dataclass
class FieldLineSegment:
    name: str
    p1: Vector2f
    p2: Vector2f
    thickness: float


@dataclass
class FieldCircularArc:
    name: str
    center: Vector2f
    radius: float
    a1: float
    a2: float
    thickness: float


@dataclass
class FieldSize:
    """SSL_GeometryFieldSize; an unset field reads 0, as on the proto, and
    ``HasField`` is true for the fields in ``present``."""

    field_length: int = 0
    field_width: int = 0
    goal_width: int = 0
    goal_depth: int = 0
    boundary_width: int = 0
    boundary_width_goal_line: int = 0
    penalty_area_depth: int = 0
    penalty_area_width: int = 0
    center_circle_radius: int = 0
    line_thickness: int = 0
    goal_center_to_penalty_mark: int = 0
    goal_height: int = 0
    goal_substitution_area_width: int = 0
    ball_radius: float = 0.0
    max_robot_radius: float = 0.0
    field_lines: list[FieldLineSegment] = dc_field(default_factory=list)
    field_arcs: list[FieldCircularArc] = dc_field(default_factory=list)
    present: frozenset = frozenset()

    def HasField(self, name: str) -> bool:
        return name in self.present


@dataclass
class CameraCalibration:
    """SSL_GeometryCameraCalibration with every field set."""

    camera_id: int
    focal_length: float
    principal_point_x: float
    principal_point_y: float
    distortion: float
    q0: float
    q1: float
    q2: float
    q3: float
    tx: float
    ty: float
    tz: float
    derived_camera_world_tx: float
    derived_camera_world_ty: float
    derived_camera_world_tz: float
    pixel_image_width: int
    pixel_image_height: int

    def HasField(self, name: str) -> bool:
        return hasattr(self, name)


@dataclass
class Geometry:
    """SSL_GeometryData: the field and one calibration per camera."""

    field: FieldSize
    calib: list[CameraCalibration] = dc_field(default_factory=list)


def _enabled(toggles: dict, key: str) -> bool:
    return key not in toggles or bool(toggles[key])


def default_lines(config: dict) -> tuple[list, list]:
    """Standard SSL field markings from the field dimensions: (lines, arcs)."""
    toggles = config.get("default_lines", config.get("optional_field_lines", {})) or {}
    field_cfg = config["field"]
    thickness = _f32(field_cfg["line_thickness"])
    half_length = field_cfg["field_length"] / 2
    half_width = field_cfg["field_width"] / 2
    lines, arcs = [], []

    def add_line(name, x1, y1, x2, y2):
        lines.append(FieldLineSegment(name, Vector2f(_f32(x1), _f32(y1)),
                                      Vector2f(_f32(x2), _f32(y2)), thickness))

    add_line("TopTouchLine", -half_length, half_width, half_length, half_width)
    add_line("BottomTouchLine", -half_length, -half_width, half_length, -half_width)
    add_line("LeftGoalLine", -half_length, -half_width, -half_length, half_width)
    add_line("RightGoalLine", half_length, -half_width, half_length, half_width)

    if _enabled(toggles, "halfway"):
        add_line("HalfwayLine", 0, -half_width, 0, half_width)
    if _enabled(toggles, "goal2goal"):
        add_line("CenterLine", -half_length, 0, half_length, 0)

    if _enabled(toggles, "penalty"):
        pen_x = half_length - field_cfg["penalty_area_depth"]
        half_pen = field_cfg["penalty_area_width"] / 2
        add_line("LeftPenaltyStretch", -pen_x, -half_pen, -pen_x, half_pen)
        add_line("RightPenaltyStretch", pen_x, -half_pen, pen_x, half_pen)
        add_line("LeftFieldLeftPenaltyStretch", -half_length, -half_pen, -pen_x, -half_pen)
        add_line("LeftFieldRightPenaltyStretch", -half_length, half_pen, -pen_x, half_pen)
        add_line("RightFieldLeftPenaltyStretch", pen_x, half_pen, half_length, half_pen)
        add_line("RightFieldRightPenaltyStretch", pen_x, -half_pen, half_length, -half_pen)

    if _enabled(toggles, "centercircle"):
        arcs.append(FieldCircularArc(
            "CenterCircle", Vector2f(0.0, 0.0), _f32(field_cfg["center_circle_radius"]),
            0.0, _f32(2 * math.pi), thickness,
        ))
    return lines, arcs


def geometry_from_dict(config: dict) -> Geometry:
    """Plain counterpart of the JAX package's ``geometry_from_dict(config)
    .geometry``: the field section's sizes plus the standard markings, no
    calibrations."""
    field_cfg = config["field"]
    values = {k: int(field_cfg[k]) for k in _FIELD_INTS if k in field_cfg}
    values |= {k: _f32(field_cfg[k]) for k in _FIELD_FLOATS if k in field_cfg}
    lines, arcs = default_lines(config)
    return Geometry(FieldSize(**values, field_lines=lines, field_arcs=arcs,
                              present=frozenset(values)))


def calibration_from_model(model, cam_id: int) -> CameraCalibration:
    """Plain counterpart of ``CameraModel.to_proto(cam_id)``."""
    t = model.rotation() @ -model.pos
    return CameraCalibration(
        camera_id=int(cam_id),
        focal_length=_f32(model.focal_length),
        principal_point_x=_f32(model.principal_point[0]),
        principal_point_y=_f32(model.principal_point[1]),
        distortion=_f32(model.distortion_k2),
        q0=_f32(model.quat[0]), q1=_f32(model.quat[1]),
        q2=_f32(model.quat[2]), q3=_f32(model.quat[3]),
        tx=_f32(t[0]), ty=_f32(t[1]), tz=_f32(t[2]),
        derived_camera_world_tx=_f32(model.pos[0]),
        derived_camera_world_ty=_f32(model.pos[1]),
        derived_camera_world_tz=_f32(model.pos[2]),
        pixel_image_width=int(model.size[0]),
        pixel_image_height=int(model.size[1]),
    )
