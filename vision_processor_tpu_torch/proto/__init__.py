"""Copy of vision_processor_tpu/proto/__init__.py for the port.

Generated SSL protobuf bindings, wire-compatible with the public SSL-Vision
protocol (sources in ``<repo>/proto``). The generated modules import each
other package-relatively, so this package never touches ``sys.path`` and
binds its own modules only; the bindings are not regenerated at import.
"""
from __future__ import annotations

from .ssl_vision_detection_pb2 import (
    SSL_DetectionBall,
    SSL_DetectionFrame,
    SSL_DetectionRobot,
)
from .ssl_vision_geometry_pb2 import (
    SSL_FieldCircularArc,
    SSL_FieldLineSegment,
    SSL_FieldShapeType,
    SSL_GeometryCameraCalibration,
    SSL_GeometryData,
    SSL_GeometryFieldSize,
    Vector2f,
)
from .ssl_vision_wrapper_pb2 import (
    SSL_SOURCE_VISION_PROCESSOR,
    SSL_Source,
    SSL_WrapperPacket,
)
from .ssl_gc_referee_message_pb2 import Referee
from .ssl_gc_game_event_pb2 import GameEvent
from .ssl_gc_common_pb2 import RobotId, Team
from .ssl_vision_detection_tracked_pb2 import (
    TrackedBall,
    TrackedFrame,
    TrackedRobot,
)
from .ssl_vision_wrapper_tracked_pb2 import TrackerWrapperPacket

__all__ = [
    "GameEvent",
    "RobotId",
    "Team",
    "TrackedBall",
    "TrackedFrame",
    "TrackedRobot",
    "TrackerWrapperPacket",
    "SSL_DetectionBall",
    "SSL_DetectionFrame",
    "SSL_DetectionRobot",
    "SSL_FieldCircularArc",
    "SSL_FieldLineSegment",
    "SSL_FieldShapeType",
    "SSL_GeometryCameraCalibration",
    "SSL_GeometryData",
    "SSL_GeometryFieldSize",
    "Vector2f",
    "SSL_SOURCE_VISION_PROCESSOR",
    "SSL_Source",
    "SSL_WrapperPacket",
    "Referee",
]
