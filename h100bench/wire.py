"""The SSL vision bus's wire format, by the public field numbers of
``ssl_vision_wrapper.proto``, ``ssl_vision_geometry.proto`` and
``ssl_vision_detection.proto`` (proto2): the geometry packet that a
geometry publisher sends, and the detection frames that the benchmark reads
back. Written from the field numbers alone, so the benchmark decodes the
wire without the program's generated bindings.
"""
from __future__ import annotations

import struct

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # int32 negatives take ten bytes, as protobuf sends them
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, v: int) -> bytes:
    return _key(field, _VARINT) + _varint(int(v))


def _float(field: int, v: float) -> bytes:
    return _key(field, _I32) + struct.pack("<f", v)


def _msg(field: int, body: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(body)) + body


def _vec(field: int, x: float, y: float) -> bytes:
    return _msg(field, _float(1, x) + _float(2, y))


# SSL_GeometryFieldSize: (name, field number, float?)
_FIELD_SIZE = (("field_length", 1, False), ("field_width", 2, False),
               ("goal_width", 3, False), ("goal_depth", 4, False),
               ("boundary_width", 5, False), ("penalty_area_depth", 8, False),
               ("penalty_area_width", 9, False), ("center_circle_radius", 10, False),
               ("line_thickness", 11, False), ("goal_center_to_penalty_mark", 12, False),
               ("goal_height", 13, False), ("ball_radius", 14, True),
               ("max_robot_radius", 15, True), ("boundary_width_goal_line", 16, False))
# SSL_GeometryCameraCalibration: (name, field number, float?)
_CALIB = (("camera_id", 1, False), ("focal_length", 2, True),
          ("principal_point_x", 3, True), ("principal_point_y", 4, True),
          ("distortion", 5, True), ("q0", 6, True), ("q1", 7, True), ("q2", 8, True),
          ("q3", 9, True), ("tx", 10, True), ("ty", 11, True), ("tz", 12, True),
          ("derived_camera_world_tx", 13, True), ("derived_camera_world_ty", 14, True),
          ("derived_camera_world_tz", 15, True), ("pixel_image_width", 16, False),
          ("pixel_image_height", 17, False))


def geometry_packet(field: dict, lines: list, arcs: list, calibs: list) -> bytes:
    """SSL_WrapperPacket{geometry}: the field's sizes and markings and one
    calibration a camera (``rig.Camera.calibration()``)."""
    body = b""
    for name, num, is_float in _FIELD_SIZE:
        if name in field:
            body += _float(num, field[name]) if is_float else _int(num, field[name])
    for name, x1, y1, x2, y2, th in lines:
        body += _msg(6, _msg(1, name.encode()) + _vec(2, x1, y1) + _vec(3, x2, y2)
                     + _float(4, th))
    for name, cx, cy, r, a1, a2, th in arcs:
        body += _msg(7, _msg(1, name.encode()) + _vec(2, cx, cy) + _float(3, r)
                     + _float(4, a1) + _float(5, a2) + _float(6, th))
    geometry = _msg(1, body)
    for calib in calibs:
        geometry += _msg(2, b"".join(
            _float(num, calib[name]) if is_float else _int(num, calib[name])
            for name, num, is_float in _CALIB))
    return _msg(2, geometry)


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message; a
    length-delimited value is its bytes."""
    i, n = 0, len(buf)
    while i < n:
        key, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, v
        elif wire == _I64:
            yield field, wire, struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wire == _I32:
            yield field, wire, struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif wire == _LEN:
            ln, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"wire type {wire} in field {field}")


def _robot(buf: bytes) -> tuple:
    """(robot_id, x, y, orientation, confidence) of an SSL_DetectionRobot."""
    r = {f: v for f, _, v in _fields(buf)}
    return (int(r.get(2, -1)), r.get(3, 0.0), r.get(4, 0.0), r.get(5, float("nan")),
            r.get(1, 0.0))


def decode_detection(data: bytes) -> dict | None:
    """The detection frame of an SSL_WrapperPacket, or None for a packet
    without one (a geometry packet): camera, frame number, the three
    times, the balls as (x, y, confidence) and the robots of each team as
    (robot_id, x, y, orientation, confidence)."""
    det = None
    for f, _, v in _fields(data):
        if f == 1:
            det = v
    if det is None:
        return None
    out = {"camera_id": -1, "frame_number": 0, "t_capture": 0.0, "t_sent": 0.0,
           "t_capture_camera": 0.0, "balls": [], "yellow": [], "blue": []}
    for f, _, v in _fields(det):
        if f == 1:
            out["frame_number"] = int(v)
        elif f == 2:
            out["t_capture"] = v
        elif f == 3:
            out["t_sent"] = v
        elif f == 4:
            out["camera_id"] = int(v)
        elif f == 5:
            b = {g: w for g, _, w in _fields(v)}
            out["balls"].append((b.get(3, 0.0), b.get(4, 0.0), b.get(1, 0.0)))
        elif f == 6:
            out["yellow"].append(_robot(v))
        elif f == 7:
            out["blue"].append(_robot(v))
        elif f == 8:
            out["t_capture_camera"] = v
    return out
