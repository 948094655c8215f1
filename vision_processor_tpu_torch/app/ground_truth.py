"""Ground-truth loader: YAML detection frames for the benchmark binaries.

Copy of vision_processor_tpu/app/ground_truth.py for the port.

Schema matches the reference's gt.yml (reference src/GroundTruth.cpp:81-92):
a list of SSL_DetectionFrame-shaped dicts with balls / robots_yellow /
robots_blue entries.
"""
from __future__ import annotations

from pathlib import Path

import yaml

from ..proto import SSL_DetectionFrame


def parse_ground_truth(path: str | Path) -> list[SSL_DetectionFrame]:
    with open(path) as fh:
        data = yaml.safe_load(fh)
    frames = []
    for entry in data:
        frame = SSL_DetectionFrame()
        frame.camera_id = entry["camera_id"]
        frame.frame_number = entry["frame_number"]
        frame.t_capture = entry["t_capture"]
        frame.t_sent = entry["t_sent"]
        if "t_capture_camera" in entry:
            frame.t_capture_camera = entry["t_capture_camera"]
        for b in entry.get("balls", []) or []:
            ball = frame.balls.add()
            ball.confidence = b["confidence"]
            if "area" in b:
                ball.area = b["area"]
            ball.x = b["x"]
            ball.y = b["y"]
            if "z" in b:
                ball.z = b["z"]
            ball.pixel_x = b["pixel_x"]
            ball.pixel_y = b["pixel_y"]
        for key, robots in (
            ("robots_yellow", frame.robots_yellow),
            ("robots_blue", frame.robots_blue),
        ):
            for r in entry.get(key, []) or []:
                bot = robots.add()
                bot.confidence = r["confidence"]
                if "robot_id" in r:
                    bot.robot_id = r["robot_id"]
                bot.x = r["x"]
                bot.y = r["y"]
                if "orientation" in r:
                    bot.orientation = r["orientation"]
                bot.pixel_x = r["pixel_x"]
                bot.pixel_y = r["pixel_y"]
                if "height" in r:
                    bot.height = r["height"]
        frames.append(frame)
    return frames


def corresponding_frame(
    frames: list[SSL_DetectionFrame], frame_id: int
) -> SSL_DetectionFrame | None:
    for frame in frames:
        if frame.frame_number == frame_id:
            return frame
    return None


def dump_ground_truth(frames: list[SSL_DetectionFrame], path: str | Path) -> None:
    """Inverse of parse_ground_truth, for dataset generation."""
    out = []
    for frame in frames:
        entry = {
            "camera_id": frame.camera_id,
            "frame_number": frame.frame_number,
            "t_capture": frame.t_capture,
            "t_sent": frame.t_sent,
            "balls": [
                {
                    "confidence": b.confidence,
                    "x": float(b.x),
                    "y": float(b.y),
                    "pixel_x": float(b.pixel_x),
                    "pixel_y": float(b.pixel_y),
                }
                for b in frame.balls
            ],
            "robots_yellow": [],
            "robots_blue": [],
        }
        for key, robots in (
            ("robots_yellow", frame.robots_yellow),
            ("robots_blue", frame.robots_blue),
        ):
            entry[key] = [
                {
                    "confidence": r.confidence,
                    "robot_id": int(r.robot_id),
                    "x": float(r.x),
                    "y": float(r.y),
                    "orientation": float(r.orientation),
                    "pixel_x": float(r.pixel_x),
                    "pixel_y": float(r.pixel_y),
                    "height": float(r.height),
                }
                for r in robots
            ]
        out.append(entry)
    Path(path).write_text(yaml.dump(out, sort_keys=False))
