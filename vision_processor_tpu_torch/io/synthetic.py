"""Synthetic SSL scene renderer (port of vision_processor_tpu/io/synthetic.py).

Host numpy code carried over against the port's camera module; scene
noise is drawn from ``numpy.random.default_rng(scene.seed)`` exactly as in
the JAX package, so both render identical frames.

Renders an SSL field with robots and a ball through a CameraModel into a raw
Bayer (or BGR) frame, with exact ground truth. Serves as the test fixture and
dataset generator replacing the reference's recorded `test-data/` videos
(reference python/dataset.py:44-139): the reference repo ships no datasets, so
scene synthesis is this framework's reproducible oracle.

Rendering is inverse mapping: every image pixel is projected onto the planes
of interest (carpet z=0, robot-cover z=height) and painted by membership
tests. All math is vectorized numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..models.camera import CameraModel
from ..models.pattern import (
    CENTER_BLOB_RADIUS,
    PATTERNS,
    PATTERN_POS,
    SIDE_BLOB_RADIUS,
)

# Default scene palette (RGB 0-255)
CARPET = np.array([40, 110, 45])
LINE = np.array([180, 190, 185])
BALL_ORANGE = np.array([230, 110, 30])
COVER_BLACK = np.array([25, 25, 25])
YELLOW = np.array([235, 200, 30])
BLUE = np.array([35, 90, 230])
GREEN = np.array([40, 220, 130])
PINK = np.array([235, 70, 160])


@dataclass
class SceneBot:
    bot_id: int  # 0-15
    team: str  # "yellow" | "blue"
    x: float  # field mm
    y: float
    orientation: float  # rad
    height: float = 143.0


@dataclass
class SceneBall:
    x: float
    y: float
    radius: float = 21.5


@dataclass
class Scene:
    bots: list[SceneBot] = dc_field(default_factory=list)
    balls: list[SceneBall] = dc_field(default_factory=list)
    noise_sigma: float = 2.0
    seed: int = 0


def _field_lines_mask(pos_xy: np.ndarray, field) -> np.ndarray:
    """True where pos_xy (..., 2) lies on a field marking."""
    mask = np.zeros(pos_xy.shape[:-1], dtype=bool)
    for line in field.field_lines:
        p1 = np.array([line.p1.x, line.p1.y])
        p2 = np.array([line.p2.x, line.p2.y])
        v = p2 - p1
        w = pos_xy - p1
        vv = float(v @ v)
        if vv > 0:
            t = np.clip((w @ v) / vv, 0.0, 1.0)
        else:
            t = np.zeros(pos_xy.shape[:-1])
        d2 = np.sum((w - t[..., None] * v) ** 2, axis=-1)
        mask |= d2 <= (line.thickness / 2) ** 2
    for arc in field.field_arcs:
        c = np.array([arc.center.x, arc.center.y])
        rel = pos_xy - c
        r = np.linalg.norm(rel, axis=-1)
        ang = np.arctan2(rel[..., 1], rel[..., 0])
        ang = np.where(ang < 0, ang + 2 * np.pi, ang)
        on_r = np.abs(r - arc.radius) <= arc.thickness / 2
        in_a = (ang >= arc.a1) & (ang <= arc.a2)
        mask |= on_r & in_a
    return mask


def _paint_balls(img: np.ndarray, ground: np.ndarray, balls: list) -> None:
    """Paints each ball's disc on the carpet: the pixels whose ground point
    lies within the ball's radius, as a test of every pixel finds them.

    Only the pixels whose ground point falls in a field cell that the
    ball's bounding box touches are tested. A cell is as wide as the
    largest ball, so a box touches at most 2 x 2 of them; each tested pixel
    gets the same squared distance as in a full-frame test. A dense scene
    (about 1900 balls a camera) then costs milliseconds, not a full-frame
    pass a ball."""
    if not balls:
        return
    cell = 2.0 * max(float(b.radius) for b in balls)
    g = ground.reshape(-1, 2)
    cells = np.floor(np.asarray([[b.x, b.y] for b in balls], dtype=np.float64) / cell)
    lo, hi = cells.min(axis=0) - 1, cells.max(axis=0) + 1
    with np.errstate(invalid="ignore"):
        kxy = np.floor(g / cell)
        near = np.all((kxy >= lo) & (kxy <= hi), axis=1)  # False where not finite
    pix = np.flatnonzero(near)
    span = int(hi[1] - lo[1]) + 1
    key = ((kxy[pix, 0] - lo[0]) * span + (kxy[pix, 1] - lo[1])).astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, pix = key[order], pix[order]
    flat = img.reshape(-1, 3)
    for ball in balls:
        r = float(ball.radius)
        x0, x1 = np.floor((np.array([ball.x, ball.x]) + [-r, r]) / cell) - lo[0]
        y0, y1 = np.floor((np.array([ball.y, ball.y]) + [-r, r]) / cell) - lo[1]
        cand = [pix[np.searchsorted(key, k, "left"):np.searchsorted(key, k, "right")]
                for k in {int(kx * span + ky) for kx in (x0, x1) for ky in (y0, y1)}]
        cand = np.concatenate(cand)
        d2 = np.sum((g[cand] - [ball.x, ball.y]) ** 2, axis=-1)
        flat[cand[d2 <= ball.radius**2]] = BALL_ORANGE


def render_rgb(
    model: CameraModel, field, scene: Scene, size: tuple[int, int] | None = None
) -> np.ndarray:
    """Render the scene to an RGB image (H, W, 3) uint8 in camera resolution."""
    if size is None:
        w, h = int(model.size[0]), int(model.size[1])
    else:
        w, h = size
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    px = np.stack([xs, ys], axis=-1)

    img = np.empty((h, w, 3), dtype=np.float64)

    # carpet + lines at z=0
    ground = model.image2field(px, 0.0)[..., :2]
    img[:] = CARPET
    half_len = field.field_length / 2 + 700.0
    half_wid = field.field_width / 2 + 700.0
    outside = (
        (np.abs(ground[..., 0]) > half_len)
        | (np.abs(ground[..., 1]) > half_wid)
        | ~np.isfinite(ground[..., 0])
    )
    img[outside] = [70, 70, 70]
    img[_field_lines_mask(np.nan_to_num(ground, nan=1e9), field)] = LINE

    # balls: disc on the carpet
    _paint_balls(img, ground, scene.balls)

    # bots: cover plane at z=height (painted last -> occludes carpet/ball)
    for bot in scene.bots:
        plane = model.image2field(px, bot.height)[..., :2]
        rel = plane - [bot.x, bot.y]
        d2 = np.sum(rel**2, axis=-1)
        cover = d2 <= 90.0**2
        img[cover] = COVER_BLACK

        center_color = YELLOW if bot.team == "yellow" else BLUE
        img[d2 <= CENTER_BLOB_RADIUS**2] = center_color

        pattern = int(PATTERNS[bot.bot_id])
        rot = np.array(
            [
                [np.cos(bot.orientation), -np.sin(bot.orientation)],
                [np.sin(bot.orientation), np.cos(bot.orientation)],
            ]
        )
        for slot in range(1, 5):
            blob_pos = np.array([bot.x, bot.y]) + rot @ PATTERN_POS[slot]
            color = GREEN if (pattern >> (4 - slot)) & 1 else PINK
            d2b = np.sum((plane - blob_pos) ** 2, axis=-1)
            img[d2b <= SIDE_BLOB_RADIUS**2] = color

    rng = np.random.default_rng(scene.seed)
    if scene.noise_sigma > 0:
        img = img + rng.normal(0, scene.noise_sigma, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def rgb_to_bayer(rgb: np.ndarray, fmt: str = "RGGB") -> np.ndarray:
    """Mosaic a half-resolution RGB image into a full-resolution Bayer frame.

    Each RGB pixel becomes one 2x2 Bayer cell, matching how the pipeline's
    raw2quad recovers the four planes at camera-model (half) resolution.
    """
    h, w, _ = rgb.shape
    raw = np.zeros((2 * h, 2 * w), dtype=np.uint8)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    if fmt == "RGGB":
        raw[0::2, 0::2] = r
        raw[0::2, 1::2] = g
        raw[1::2, 0::2] = g
        raw[1::2, 1::2] = b
    elif fmt == "GRBG":
        raw[0::2, 0::2] = g
        raw[0::2, 1::2] = r
        raw[1::2, 0::2] = b
        raw[1::2, 1::2] = g
    else:
        raise ValueError(fmt)
    return raw


def render_raw(
    model: CameraModel, field, scene: Scene, fmt: str = "RGGB"
) -> np.ndarray:
    """Render directly to a raw frame: Bayer (2H, 2W) or BGR (H, W, 3)."""
    rgb = render_rgb(model, field, scene)
    if fmt == "BGR":
        return rgb[..., ::-1].copy()
    return rgb_to_bayer(rgb, fmt)
