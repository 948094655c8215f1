"""Copy of vision_processor_tpu/models/host_detect.py for the port.

Host half of the detection step: id assignment, color recalibration,
ball finalization, protobuf emission.

Consumes the small tensors returned by the device detector
(models/detector.py) plus the blob slots, and finishes the frame exactly in
the reference's order (reference src/main.cpp:320-371): colors update on the
pre-update ids, ids/scores recalculated with the new colors, then ball
score / camera-edge / stddev filters.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..proto import SSL_DetectionFrame
from .colors import ColorState
from .kmeans import kmeans2, kmeans2_batch
from .pattern import PATTERN_LUT

_SQ = lambda v: float(np.dot(v, v))


@dataclass
class BotDetection:
    pos: np.ndarray  # field mm (2,)
    orientation: float
    score: float
    blob_idx: np.ndarray  # (5,) int, -1 = missing slot
    tracked_id: int  # -1 for detection hypotheses
    blob_colors: list = dc_field(default_factory=list)  # (5) of int3 / None
    bot_id: int = -1


@dataclass
class BallDetection:
    pos: np.ndarray  # field mm (2,)
    blob_color: np.ndarray  # disc mean dRGB
    blob_center: np.ndarray  # center pixel dRGB
    blob_score: float  # circ / stddev score from the blob machine
    score: float = 1.0


def calc_bot_id(colors: ColorState, blob_colors) -> int:
    """Robot id from the side-blob green/pink split + team color
    (reference src/blobs/hypothesis.cpp:216-227)."""
    center = np.asarray(blob_colors[0], dtype=np.int64)
    sides = [np.asarray(c, dtype=np.int64) for c in blob_colors[1:5]]
    _, green, pink = kmeans2(center, sides, colors.green, colors.pink)

    bits = 0
    for i, c in enumerate(sides):
        if _SQ(c - green) < _SQ(c - pink):
            bits |= 1 << (3 - i)
    team_blue = _SQ(center - colors.blue) < _SQ(center - colors.yellow)
    return (16 if team_blue else 0) + int(PATTERN_LUT[bits])


def calc_bot_ids(colors: ColorState, blob_colors5: np.ndarray) -> np.ndarray:
    """Batched ``calc_bot_id`` over (B, 5, 3) full constellations — same
    guarded 2-means + green/pink split + team color, one numpy pass."""
    c5 = np.asarray(blob_colors5, dtype=np.int64)
    center = c5[:, 0]
    sides = c5[:, 1:5]
    _, green, pink = kmeans2_batch(center, sides, colors.green, colors.pink)

    d_g = np.sum((sides - green[:, None, :]) ** 2, axis=-1)
    d_p = np.sum((sides - pink[:, None, :]) ** 2, axis=-1)
    bits = (d_g < d_p).astype(np.int64)
    mask = bits[:, 0] * 8 + bits[:, 1] * 4 + bits[:, 2] * 2 + bits[:, 3]
    base = np.asarray(PATTERN_LUT, dtype=np.int64)[mask]
    team_blue = np.sum((center - colors.blue) ** 2, axis=-1) < np.sum(
        (center - colors.yellow) ** 2, axis=-1
    )
    return base + np.where(team_blue, 16, 0)


def ball_color_score(colors: ColorState, blob_color: np.ndarray) -> float:
    """1 - orange/false-orange distance ratio, zeroed when the blob is closer
    to the field or field-line color (reference src/blobs/hypothesis.cpp:83-94)."""
    return float(ball_color_scores(colors, np.asarray(blob_color)[None])[0])


def ball_color_scores(colors: ColorState, blob_colors: np.ndarray) -> np.ndarray:
    """Vectorized ball color scores for (n, 3) blob colors."""
    c = np.asarray(blob_colors, dtype=np.float64)
    false_orange = np.sum((c - colors.field) ** 2, axis=-1)
    orange = np.sum((c - colors.orange) ** 2, axis=-1)
    field_line = np.sum((c - colors.field_line) ** 2, axis=-1)
    bad = (false_orange <= orange) | (field_line <= orange)
    with np.errstate(divide="ignore", invalid="ignore"):
        score = 1.0 - orange / false_orange
    return np.where(bad | ~np.isfinite(score), 0.0, score)


def tracked_color_veto(colors: ColorState, bot: BotDetection) -> bool:
    """True when any blob color contradicts the known pattern
    (reference src/blobs/hypothesis.cpp:245-270)."""
    from .pattern import PATTERNS

    blob_amount = sum(1 for c in bot.blob_colors if c is not None)
    if blob_amount < 2:
        return True
    pattern = int(PATTERNS[bot.bot_id % 16])
    for i, c in enumerate(bot.blob_colors):
        if c is None:
            continue
        c = np.asarray(c, dtype=np.int64)
        if i == 0:
            expected = colors.blue if bot.bot_id >= 16 else colors.yellow
            opposite = colors.yellow if bot.bot_id >= 16 else colors.blue
        else:
            green = (pattern >> (4 - i)) & 1
            expected = colors.green if green else colors.pink
            opposite = colors.pink if green else colors.green
        if _SQ(c - opposite) - _SQ(c - expected) <= 0:
            return True
    return False


def balls_at_lines(field, geometry_tolerance, ball_pos: np.ndarray) -> np.ndarray:
    """(n,) mask of ball positions lying on a field marking
    (reference src/blobs/colorupdate.cpp:21-40), vectorized."""
    n = len(ball_pos)
    mask = np.zeros(n, dtype=bool)
    if n == 0:
        return mask
    max_d = field.line_thickness / 2 + geometry_tolerance
    for line in field.field_lines:
        p1 = np.array([line.p1.x, line.p1.y])
        p2 = np.array([line.p2.x, line.p2.y])
        v = p2 - p1
        vv = float(v @ v)
        w = ball_pos - p1
        t = np.clip((w @ v) / vv, 0.0, 1.0) if vv > 0 else np.zeros(n)
        d2 = np.sum((w - t[:, None] * v) ** 2, axis=-1)
        mask |= d2 <= max_d * max_d
    for arc in field.field_arcs:
        rel = ball_pos - [arc.center.x, arc.center.y]
        ang = np.arctan2(rel[:, 1], rel[:, 0])
        ang = np.where(ang < 0, ang + 2 * np.pi, ang)
        r = np.linalg.norm(rel, axis=-1)
        mask |= (
            (np.abs(r - arc.radius) <= max_d) & (ang >= arc.a1) & (ang <= arc.a2)
        )
    return mask


class HostDetector:
    """Stateful host-side finisher for detector outputs."""

    def __init__(self, config, colors: ColorState, perspective):
        self.config = config
        self.colors = colors
        self.perspective = perspective

    # -- assembly -----------------------------------------------------------

    def build_bots(self, det: dict, blobs: dict) -> list[BotDetection]:
        bots = []
        valid = det["bot_valid"]
        colors_arr = blobs["color"]
        # first-pass ids computed in-graph with the same pre-update colors
        # (processor full_step attaches bot_id_est); host kmeans parity is
        # covered by tests/test_id_parity.py
        id_est = det.get("bot_id_est")
        for i in np.flatnonzero(valid):
            idx = det["bot_blob_idx"][i]
            blob_colors = [
                colors_arr[j].astype(np.int64) if j >= 0 else None for j in idx
            ]
            bot = BotDetection(
                pos=det["bot_pos"][i],
                orientation=float(det["bot_orientation"][i]),
                score=float(det["bot_score"][i]),
                blob_idx=idx,
                tracked_id=int(det["bot_tracked_id"][i]),
                blob_colors=blob_colors,
            )
            if bot.tracked_id >= 0:
                bot.bot_id = bot.tracked_id
            elif id_est is not None:
                bot.bot_id = int(id_est[i])
            bots.append(bot)
        if id_est is None:
            self._assign_ids(bots)
        return bots

    def _assign_ids(self, bots) -> None:
        """Batched id assignment for detection-hypothesis bots (tracked bots
        keep their id). Detection constellations always carry 5 blobs."""
        fresh = [
            b for b in bots
            if b.tracked_id < 0 and all(c is not None for c in b.blob_colors)
        ]
        if fresh:
            ids = calc_bot_ids(
                self.colors, np.stack([np.stack(b.blob_colors) for b in fresh])
            )
            for b, i in zip(fresh, ids):
                b.bot_id = int(i)

    def build_balls(self, det: dict, blobs: dict) -> list[BallDetection]:
        keep = np.flatnonzero(blobs["valid"] & ~det["ball_clipped"])
        scores = ball_color_scores(self.colors, blobs["color"][keep])
        return [
            BallDetection(
                pos=blobs["field_pos"][j],
                blob_color=blobs["color"][j].astype(np.int64),
                blob_center=blobs["center"][j].astype(np.int64),
                blob_score=float(blobs["score"][j]),
                score=float(scores[i]),
            )
            for i, j in enumerate(keep)
        ]

    # -- color update + recalc ---------------------------------------------

    def update_colors(self, bots, balls, max_bot_height: float) -> None:
        self.colors.update(bots, balls)
        if balls:
            pos = np.array([b.pos for b in balls])
            img = self.perspective.model.field2image(
                np.concatenate([pos, np.full((len(pos), 1), max_bot_height)], axis=1)
            )
            ball_radius = self.perspective.field.ball_radius or 21.5
            ground = self.perspective.model.image2field(img, ball_radius)[:, :2]
            at_line = balls_at_lines(
                self.perspective.field,
                self.config.geometry_tolerance,
                np.nan_to_num(ground, nan=1e9),
            )
            self.colors.update_field_line(
                [balls[i].blob_color for i in np.flatnonzero(at_line)]
            )

    def recalc_post_color(self, bots, balls) -> None:
        for bot in bots:
            if bot.tracked_id >= 0 and tracked_color_veto(self.colors, bot):
                bot.score = 0.0
        self._assign_ids(bots)  # re-derive detection ids with updated colors
        if balls:
            scores = ball_color_scores(
                self.colors, np.stack([b.blob_color for b in balls])
            )
            for ball, score in zip(balls, scores):
                ball.score = float(score)

    # -- final filters ------------------------------------------------------

    def filter_balls(self, balls, max_bot_height: float) -> list[BallDetection]:
        out = [b for b in balls if b.score > self.config.min_confidence]
        out = [b for b in out if b.blob_score > self.config.min_score]
        if not out:
            return out

        # camera-edge filter (reference src/main.cpp:160-192), vectorized
        model = self.perspective.model
        field = self.perspective.field
        from .camera import goal_boundary_width

        half_len = field.field_length / 2 + goal_boundary_width(field)
        half_wid = field.field_width / 2 + field.boundary_width
        min_d2 = self.config.min_cam_edge_distance**2
        w, h = float(model.size[0]), float(model.size[1])

        pos = np.stack([b.pos for b in out])
        img = model.field2image(
            np.concatenate(
                [pos, np.full((len(out), 1), max_bot_height)], axis=1
            )
        )
        borders = np.stack(
            [
                np.stack([np.zeros(len(out)), img[:, 1]], axis=1),
                np.stack([np.full(len(out), w - 1), img[:, 1]], axis=1),
                np.stack([img[:, 0], np.zeros(len(out))], axis=1),
                np.stack([img[:, 0], np.full(len(out), h - 1)], axis=1),
            ],
            axis=1,
        )  # (n, 4, 2)
        bpos = model.image2field(
            borders.reshape(-1, 2), max_bot_height
        )[:, :2].reshape(len(out), 4, 2)
        inside = (
            (np.abs(bpos[..., 0]) <= half_len)
            & (np.abs(bpos[..., 1]) <= half_wid)
            & np.isfinite(bpos).all(axis=-1)
        )
        d2 = np.sum((bpos - pos[:, None, :]) ** 2, axis=-1)
        near_edge = np.any(inside & (d2 < min_d2), axis=1)
        return [b for b, cut in zip(out, near_edge) if not cut]

    # -- emission -----------------------------------------------------------

    def emit(
        self,
        frame: SSL_DetectionFrame,
        bots,
        balls,
        gc_heights,
        max_bot_height: float,
    ) -> None:
        """Append detections (reference src/blobs/hypothesis.cpp:70-81,141-154).

        All camera projections are batched into two vectorized calls —
        per-object single-point projections dominated the host finishing
        profile."""
        model = self.perspective.model
        field = self.perspective.field
        ball_radius = field.ball_radius or 21.5
        n_bots, n_balls = len(bots), len(balls)
        if not (n_bots or n_balls):
            return
        pos = np.empty((n_bots + n_balls, 3))
        heights = np.empty(n_bots + n_balls)
        for i, bot in enumerate(bots):
            pos[i, :2] = bot.pos
            heights[i] = gc_heights["yellow" if bot.bot_id < 16 else "blue"]
        for i, ball in enumerate(balls):
            pos[n_bots + i, :2] = ball.pos
            heights[n_bots + i] = ball_radius
        pos[:, 2] = max_bot_height
        imgs = model.field2image(pos)
        world = model.image2field(imgs, heights)
        for i, bot in enumerate(bots):
            entry = (
                frame.robots_yellow.add() if bot.bot_id < 16
                else frame.robots_blue.add()
            )
            entry.confidence = bot.score
            entry.robot_id = bot.bot_id % 16
            entry.x = float(world[i, 0])
            entry.y = float(world[i, 1])
            entry.height = float(world[i, 2])
            entry.orientation = bot.orientation
            entry.pixel_x = float(imgs[i, 0])
            entry.pixel_y = float(imgs[i, 1])
        for i, ball in enumerate(balls):
            j = n_bots + i
            entry = frame.balls.add()
            entry.confidence = ball.score
            entry.x = float(world[j, 0])
            entry.y = float(world[j, 1])
            entry.pixel_x = float(imgs[j, 0])
            entry.pixel_y = float(imgs[j, 1])
