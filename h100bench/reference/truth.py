"""The plain reference: what every detection frame on the bus should say.

From the scene that the benchmark made (each robot's team, id, position
and heading and the ball's position in every frame of the loop) and the
cameras' calibrations, it works out, for a frame of camera ``c`` stamped
with capture ``k``, the objects on the field at that capture, which of
them that camera must report (those whose centre lies ``margin`` pixels
inside its image, by its own pinhole-and-k2 projection below, and a ball
only where no robot's cover hides any of it in that image), and
compares the frame's detections with them. A camera answers for that part
of its image alone: a detection that it reports nearer its border, where
the border may cut a robot or the ball, is neither required nor judged
(``judge`` counts such reports as ``border_reports``; one that lies within
50 mm of a due robot with its team and id still names it). NumPy only: it
imports neither the program nor JAX, and reads nothing that the program
made except the detection frames it judges.

The numbers compared, over every frame whose capture fell in the window:

- ``robot_gap_mm``: the widest distance of a reported robot from the robot
  on the field with its team and id;
- ``heading_gap_rad``: the widest heading difference of such a robot;
- ``unknown_robot_share``: the share of the judged robot reports whose
  team and id no robot on the field has;
- ``missed_robot_share``: the share of the robots that a camera must report
  whose frame does not name them;
- ``ball_gap_mm``: the widest distance of a reported ball from the ball;
- ``missed_ball_share``: the share of the frames that must show the ball
  and report none;
- ``unstamped_frames``: frames whose capture time is no capture of the
  camera's clock.
"""
from __future__ import annotations

import math

import numpy as np

# the control's lag: one capture of a 60 fps camera, a fixed time, so that
# a stale answer reads the same however fast the loop runs
CONTROL_LAG_S = 1.0 / 60.0
COVER_RADIUS = 90.0  # mm, the SSL rules' largest robot radius

NUMBERS = ("robot_gap_mm", "heading_gap_rad", "unknown_robot_share", "missed_robot_share",
           "ball_gap_mm", "missed_ball_share", "unstamped_frames")
COUNTS = ("robot_reports", "unknown_robots", "robots_due", "missed_robots", "balls_due",
          "missed_balls", "border_reports")


def project(calib: dict, pts: np.ndarray) -> np.ndarray:
    """Field mm (..., 3) to image px (..., 2) of an SSL camera calibration
    (quaternion q0-q3, translation t, focal length, principal point and
    one radial k2 term, applied by fixed-point iteration)."""
    x, y, z, w = (calib[k] for k in ("q0", "q1", "q2", "q3"))
    n = math.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    t = np.array([calib["tx"], calib["ty"], calib["tz"]])
    cam = np.asarray(pts, dtype=np.float64) @ rot.T + t
    n0 = cam[..., :2] / cam[..., 2:3]
    u = n0
    for _ in range(10):
        u = n0 / (1.0 + calib["distortion"] * np.sum(u * u, axis=-1, keepdims=True))
    return calib["focal_length"] * u + np.array([calib["principal_point_x"],
                                                  calib["principal_point_y"]])


def _inside(calib: dict, xy: np.ndarray, z: float, margin: float) -> np.ndarray:
    px = project(calib, np.concatenate([xy, np.full(xy.shape[:-1] + (1,), z)], -1))
    w, h = calib["pixel_image_width"], calib["pixel_image_height"]
    return ((px[..., 0] >= margin) & (px[..., 0] <= w - 1 - margin)
            & (px[..., 1] >= margin) & (px[..., 1] <= h - 1 - margin))


def _hidden(calib: dict, ball: np.ndarray, ball_z: float, ball_radius: float,
            robots: np.ndarray, robot_z: float, pad_px: float = 3.0) -> np.ndarray:
    """(L,) True where, in this camera's image, some robot's cover (a disc
    of ``COVER_RADIUS`` at the robots' height) comes within ``pad_px`` of
    the ball's disc; each disc's radius in pixels is the pinhole's at its
    height under the camera."""
    bp = project(calib, np.concatenate([ball, np.full(ball.shape[:-1] + (1,), ball_z)], -1))
    rp = project(calib, np.concatenate([robots[..., :2],
                                        np.full(robots.shape[:-1] + (1,), robot_z)], -1))
    f, cz = calib["focal_length"], calib["derived_camera_world_tz"]
    reach = COVER_RADIUS * f / (cz - robot_z) + ball_radius * f / (cz - ball_z) + pad_px
    return (np.hypot(*(rp - bp[:, None, :]).transpose(2, 0, 1)) < reach).any(-1)


def _wrap(a: float) -> float:
    return abs((a + math.pi) % (2 * math.pi) - math.pi)


class Truth:
    """The scene's objects by capture, and each camera's duty to report."""

    def __init__(self, calibs: list, teams, ids, robots, ball, robot_height: float,
                 ball_radius: float, robot_margin_px: float, ball_margin_px: float):
        self.calibs = calibs
        self.key = [(int(t), int(i)) for t, i in zip(teams, ids)]  # (team, id)
        self.robots = np.asarray(robots, dtype=np.float64)  # (L, R, 3)
        self.ball = np.asarray(ball, dtype=np.float64)  # (L, 2)
        self.loop = self.ball.shape[0]
        self.robot_height, self.ball_radius = robot_height, ball_radius
        self.robot_margin_px, self.ball_margin_px = robot_margin_px, ball_margin_px
        # (camera, loop frame, robot) and (camera, loop frame): must report
        self.must_robot = np.stack([_inside(c, self.robots[..., :2], robot_height,
                                            robot_margin_px) for c in calibs])
        self.must_ball = np.stack([
            _inside(c, self.ball, ball_radius, ball_margin_px)
            & ~_hidden(c, self.ball, ball_radius, ball_radius, self.robots, robot_height)
            for c in calibs])


def judge(truth: Truth, frames: list, fps: float, t0: float, faults: list | None = None,
          near_mm: float = 50.0) -> dict:
    """The numbers of ``NUMBERS`` over ``frames``: bus frames as decoded
    (``camera_id``, ``t_capture_camera``, ``balls`` (x, y, confidence),
    ``yellow`` and ``blue`` (robot_id, x, y, heading, confidence)). With a
    list ``faults``, each detection farther than ``near_mm`` from its
    object, each unknown robot and each miss is appended to it as (kind,
    camera, capture, what was reported, what is on the field)."""
    out = dict.fromkeys(NUMBERS + COUNTS, 0.0)

    def note(*item):
        if faults is not None:
            faults.append(item)

    index = {key: r for r, key in enumerate(truth.key)}
    for f in frames:
        c = f["camera_id"]
        k = round((f["t_capture_camera"] - t0) * fps)
        if not 0 <= c < len(truth.calibs) or abs(t0 + k / fps - f["t_capture_camera"]) > 1e-6:
            out["unstamped_frames"] += 1
            continue
        j = k % truth.loop
        state = truth.robots[j]
        named = set()
        for team, robots in ((0, f["yellow"]), (1, f["blue"])):
            for rid, x, y, heading, _ in robots:
                if not _inside(truth.calibs[c], np.array([x, y]), truth.robot_height,
                               truth.robot_margin_px):
                    out["border_reports"] += 1
                    # not judged, but it names a due robot that it lies beside
                    r = index.get((team, rid))
                    if r is not None and math.hypot(x - state[r][0], y - state[r][1]) <= near_mm:
                        named.add(r)
                    continue
                out["robot_reports"] += 1
                r = index.get((team, rid))
                if r is None:
                    out["unknown_robots"] += 1
                    note("unknown_robot", c, k, (team, rid, x, y, _conf(robots, rid)),
                         _px(truth, c, x, y, truth.robot_height))
                    continue
                named.add(r)
                tx, ty, th = state[r]
                gap = math.hypot(x - tx, y - ty)
                out["robot_gap_mm"] = max(out["robot_gap_mm"], gap)
                if gap > near_mm:
                    note("robot_gap", c, k, (team, rid, x, y, _conf(robots, rid)),
                         (tx, ty, *_px(truth, c, tx, ty, truth.robot_height)))
                if not math.isnan(heading):
                    out["heading_gap_rad"] = max(out["heading_gap_rad"], _wrap(heading - th))
        for r in np.flatnonzero(truth.must_robot[c, j]):
            out["robots_due"] += 1
            if r not in named:
                out["missed_robots"] += 1
                note("missed_robot", c, k, None,
                     (*truth.key[r], *state[r][:2], *_px(truth, c, *state[r][:2],
                                                        truth.robot_height)))
        bx, by = truth.ball[j]
        for x, y, conf in f["balls"]:
            if not _inside(truth.calibs[c], np.array([x, y]), truth.ball_radius,
                           truth.ball_margin_px):
                out["border_reports"] += 1
                continue
            gap = math.hypot(x - bx, y - by)
            out["ball_gap_mm"] = max(out["ball_gap_mm"], gap)
            if gap > near_mm:
                note("ball_gap", c, k, (x, y, conf, *_px(truth, c, x, y, truth.ball_radius)),
                     (bx, by))
        out["balls_due"] += int(truth.must_ball[c, j])
        if truth.must_ball[c, j] and not f["balls"]:
            out["missed_balls"] += 1
            note("missed_ball", c, k, None, (bx, by))
    out["unknown_robot_share"] = out["unknown_robots"] / max(out["robot_reports"], 1)
    out["missed_robot_share"] = out["missed_robots"] / max(out["robots_due"], 1)
    out["missed_ball_share"] = out["missed_balls"] / max(out["balls_due"], 1)
    return out


def _px(truth: Truth, c: int, x: float, y: float, z: float) -> tuple:
    """Where camera ``c`` sees the field point (x, y, z), px."""
    u, v = project(truth.calibs[c], np.array([x, y, z]))
    return (float(u), float(v))


def _conf(robots, rid):
    return next(conf for r, *_, conf in robots if r == rid)


def control_frames(truth: Truth, delivered: list, fps: float, t0: float,
                   lag_s: float = CONTROL_LAG_S) -> list:
    """The control: the reference in the program's place, with the guarantee
    that a frame describes the capture it is stamped with broken by a fixed
    time, ``lag_s`` (at least one capture), as a loop that sent stale
    answers would. Each delivered (camera, capture k) gets a frame stamped k
    that reports, exactly, what that camera must report at the capture
    ``lag_s`` before k."""
    lag = max(1, round(lag_s * fps))
    out = []
    for c, k in sorted(delivered, key=lambda d: (d[1], d[0])):
        j = (k - lag) % truth.loop
        robots = {0: [], 1: []}
        for r in np.flatnonzero(truth.must_robot[c, j]):
            team, rid = truth.key[r]
            x, y, h = truth.robots[j, r]
            robots[team].append((rid, x, y, h, 1.0))
        balls = [(*truth.ball[j], 1.0)] if truth.must_ball[c, j] else []
        out.append({"camera_id": c, "t_capture_camera": t0 + k / fps, "balls": balls,
                    "yellow": robots[0], "blue": robots[1]})
    return out
