"""The traffic generator: a match's moving robots and ball, from a mix's
parameters and the seed, rendered to every camera's raw Bayer frames.

One general generator reads every mix (``traffic/<name>.json``). The
scene is a loop of ``loop_frames`` camera frames: each robot drives a
turned ellipse anywhere on the field at a top speed from the mix's range,
across the seams between cameras, and swings its heading; some pass the
ball; the ball runs an ellipse through the camera rows at up to the rules'
top speed; every path closes over the loop, so its last frame leads into
its first. The seed draws the ids, the ellipses within the mix's ranges,
their places, phases and directions, and the sensor noise; the counts,
speeds' ranges and the loop's length are the mix's and the deployment's,
the same for every seed.

The renderer follows the SSL cover layout (a 90 mm black cover, a 25 mm
team blob in the centre, four 20 mm id blobs on the 85 mm circle, green
for a set bit and pink for a clear one) and paints by inverse mapping:
each pixel is projected onto the carpet (z = 0) and onto the robots'
cover plane, on the card, a chunk of frames at a time, in float64; the
noise comes from a ``torch.Generator`` seeded from the run's seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

CARPET = (40, 110, 45)
OUTSIDE = (70, 70, 70)
LINE = (180, 190, 185)
BALL_ORANGE = (230, 110, 30)
COVER_BLACK = (25, 25, 25)
YELLOW = (235, 200, 30)
BLUE = (35, 90, 230)
GREEN = (40, 220, 130)
PINK = (235, 70, 160)

COVER_RADIUS = 90.0
CENTER_BLOB_RADIUS = 25.0
SIDE_BLOB_RADIUS = 20.0
# the id blobs on the cover, robot frame (mm), first ccw from the nose
SIDE_BLOBS = ((35.0, 54.772), (-54.772, 35.0), (-54.772, -35.0), (35.0, -54.772))
# the SSL standard id patterns: id -> 4 bits, msb the first blob (1 green)
PATTERNS = (0b0100, 0b1100, 0b1101, 0b0101, 0b0010, 0b1010, 0b1011, 0b0011,
            0b1111, 0b0000, 0b0110, 0b1001, 0b1110, 0b1000, 0b0111, 0b0001)


@dataclass
class Scene:
    """Every object's state in every frame of the loop."""

    teams: np.ndarray  # (R,) 0 yellow, 1 blue
    ids: np.ndarray  # (R,) 0-15
    robots: np.ndarray  # (L, R, 3) x, y mm, heading rad
    ball: np.ndarray  # (L, 2) mm
    robot_height: float
    ball_radius: float
    noise_sigma: float

    @property
    def loop(self) -> int:
        return self.ball.shape[0]


def _paths(rng, n: int, loop: int, omega: float, mix: dict):
    """Offsets (n, L, 2) mm of ``n`` closed paths from their centres: ellipses
    turned by a random angle, each driven once a loop, the top speed of each
    (along its longer axis) drawn from the mix's range."""
    lo_v, hi_v = mix["robot_top_speed_mm_s"]
    lo_a, hi_a = mix["robot_path_aspect"]
    t = np.arange(loop) / loop * 2 * math.pi
    out = np.empty((n, loop, 2))
    for i in range(n):
        rx = rng.uniform(lo_v, hi_v) / omega
        ry = rx * rng.uniform(lo_a, hi_a)
        turn, phase, way = rng.uniform(0, math.pi), rng.uniform(0, 2 * math.pi), rng.choice(
            [-1.0, 1.0])
        ex, ey = rx * np.cos(way * t + phase), ry * np.sin(way * t + phase)
        out[i, :, 0] = math.cos(turn) * ex - math.sin(turn) * ey
        out[i, :, 1] = math.sin(turn) * ex + math.cos(turn) * ey
    return out


def view_box(cam, height: float, margin: float) -> tuple:
    """(xmin, xmax, ymin, ymax) mm of the part of camera ``cam``'s view on
    the plane z = height that lies ``margin`` inside the image's border."""
    w, h = cam.size
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)

    def edge(px):
        return cam.image2field(np.asarray(px, dtype=np.float64), height)

    # the largest box inside the (curved) border; image y runs against field y
    left = edge(np.stack([np.zeros(h), ys], -1))[:, 0].max()
    right = edge(np.stack([np.full(h, w - 1.0), ys], -1))[:, 0].min()
    rows = [edge(np.stack([xs, np.full(w, y)], -1))[:, 1] for y in (0.0, h - 1.0)]
    low = min(r.max() if r.mean() < cam.pos[1] else np.inf for r in rows)
    high = max(r.min() if r.mean() > cam.pos[1] else -np.inf for r in rows)
    return (left + margin, right - margin, low + margin, high - margin)


def _home_boxes(rig, height: float, margin: float) -> list:
    """Each camera's home box: its view at the robots' height and its cell of
    the camera grid, both shrunk by ``margin``."""
    from rig import camera_cells

    cells = camera_cells(rig.field["field_length"], rig.field["field_width"], rig.n_cams)
    out = []
    for cam, (lo, hi) in zip(rig.cameras, cells):
        v = view_box(cam, height, margin)
        out.append((max(v[0], lo[0] + margin), min(v[1], hi[0] - margin),
                    max(v[2], lo[1] + margin), min(v[3], hi[1] - margin)))
    return out


def make_scene(rig, mix: dict, seed: int) -> Scene:
    """The loop of one match for the rig, from the mix and the seed.

    The ball runs an ellipse through the camera rows, its longer semi-axis
    as long as the mix's top speed allows over one loop. Each robot drives
    a turned ellipse anywhere on the field, so that robots cross the seams
    between cameras, or, where the mix gives ``home_margin_mm``, inside its
    home camera's view and grid cell by that margin, the robots dealt to
    the cameras in turn; ``robots_reaching_ball`` of them pass the ball at
    a centre distance drawn from ``ball_reach_mm`` at a capture drawn from
    the seed. No cover ever overlaps the ball or another cover: the ball keeps
    ``ball_clearance_mm`` from every cover's edge, and covers keep
    ``robot_clearance_mm`` from each other, in every frame.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**63 - 1), 0x5C3E]))
    per_team = int(rig.config["robots_per_team"])
    n_robots = 2 * per_team
    loop = int(mix["loop_frames"])
    period = loop / rig.fps
    omega = 2 * math.pi / period
    height = float(rig.config["robot_height_mm"])
    teams = np.repeat([0, 1], per_team)
    ids = np.concatenate([rng.choice(16, per_team, replace=False) for _ in range(2)])

    rows = sorted({abs(float(c.pos[1])) for c in rig.cameras})
    b_axis = rows[0] if rows[0] > 0 else float(mix["ball_axis_y_mm"])
    a_axis = float(mix["ball_max_speed_mm_s"]) / omega
    if max(a_axis, b_axis) * omega > float(mix["ball_max_speed_mm_s"]) + 1e-6:
        raise ValueError("the ball's ellipse is faster than the mix allows; lengthen the loop")
    phase_b = rng.uniform(0, 2 * math.pi)
    dir_b = rng.choice([-1.0, 1.0])
    t = np.arange(loop) / loop * 2 * math.pi  # loop phase of each frame
    ball = np.stack([a_axis * np.cos(dir_b * t + phase_b),
                     b_axis * np.sin(dir_b * t + phase_b)], -1)

    ball_gap = COVER_RADIUS + float(rig.field["ball_radius"]) + float(mix["ball_clearance_mm"])
    robot_gap = 2 * COVER_RADIUS + float(mix["robot_clearance_mm"])
    margin = float(mix["field_margin_mm"])
    hl = rig.field["field_length"] / 2 - margin
    hw = rig.field["field_width"] / 2 - margin
    lo_reach, hi_reach = mix["ball_reach_mm"]
    reaching = set(rng.permutation(n_robots)[:int(mix["robots_reaching_ball"])].tolist())
    boxes = [(-hl, hl, -hw, hw)] * n_robots
    if mix.get("home_margin_mm") is not None:
        home = _home_boxes(rig, height, float(mix["home_margin_mm"]))
        shift = int(rng.integers(rig.n_cams))
        boxes = [home[(k + shift) % rig.n_cams] for k in rng.permutation(n_robots)]
        boxes = [(max(b[0], -hl), min(b[1], hl), max(b[2], -hw), min(b[3], hw)) for b in boxes]
    placed = np.empty((0, loop, 2))
    for r in range(n_robots):
        x0, x1, y0, y1 = boxes[r]
        for _ in range(20000):
            off = _paths(rng, 1, loop, omega, mix)[0]
            if r in reaching:
                k = int(rng.integers(loop))
                ang = rng.uniform(0, 2 * math.pi)
                target = ball[k] + rng.uniform(lo_reach, hi_reach) * np.array(
                    [math.cos(ang), math.sin(ang)])
                centre = target - off[k]
            else:
                span = off.max(0) - off.min(0)
                if span[0] > x1 - x0 or span[1] > y1 - y0:
                    continue
                centre = rng.uniform([x0, y0] - off.min(0), [x1, y1] - off.max(0))
            pos = centre + off
            if (pos[:, 0].min() < x0 or pos[:, 0].max() > x1 or pos[:, 1].min() < y0
                    or pos[:, 1].max() > y1):
                continue
            if np.hypot(*(pos - ball).T).min() < ball_gap:
                continue
            if len(placed) and np.hypot(*(placed - pos).transpose(2, 0, 1)).min() < robot_gap:
                continue
            placed = np.concatenate([placed, pos[None]])
            break
        else:
            raise RuntimeError(f"no room for robot {r} on the field")
    swing = float(mix["robot_heading_swing_rad"])
    heading0 = rng.uniform(-math.pi, math.pi, n_robots)
    heading_phase = rng.uniform(0, 2 * math.pi, n_robots)
    robots = np.empty((loop, n_robots, 3))
    robots[:, :, :2] = placed.transpose(1, 0, 2)
    robots[:, :, 2] = heading0 + swing * np.sin(t[:, None] + heading_phase)
    robots[:, :, 2] = (robots[:, :, 2] + math.pi) % (2 * math.pi) - math.pi
    return Scene(teams=teams, ids=ids, robots=robots, ball=ball,
                 robot_height=height, ball_radius=float(rig.field["ball_radius"]),
                 noise_sigma=float(mix["noise_sigma"]))


def _segment_d2(torch, pts, p1, p2):
    """Squared distance of pts (..., 2) to the segment p1-p2."""
    v = torch.tensor([p2[0] - p1[0], p2[1] - p1[1]], dtype=pts.dtype, device=pts.device)
    w = pts - torch.tensor(p1, dtype=pts.dtype, device=pts.device)
    vv = float(v @ v)
    t = ((w @ v) / vv).clamp(0.0, 1.0) if vv > 0 else torch.zeros_like(w[..., 0])
    return ((w - t[..., None] * v) ** 2).sum(-1)


def _base_image(torch, rig, cam, device):
    """The empty field as camera ``cam`` sees it (H, W, 3) float32, and each
    pixel's ground point (H, W, 2) float64."""
    w, h = cam.size
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    ground = cam.image2field(torch.stack([xs, ys], -1), 0.0, xp=torch)
    img = torch.empty((h, w, 3), dtype=torch.float32, device=device)
    img[:] = torch.tensor(CARPET, dtype=torch.float32, device=device)
    hl = rig.field["field_length"] / 2 + 700.0
    hw = rig.field["field_width"] / 2 + 700.0
    outside = (ground[..., 0].abs() > hl) | (ground[..., 1].abs() > hw) | ~torch.isfinite(
        ground[..., 0])
    img[outside] = torch.tensor(OUTSIDE, dtype=torch.float32, device=device)
    g = torch.nan_to_num(ground, nan=1e9)
    on_line = torch.zeros((h, w), dtype=torch.bool, device=device)
    for _, x1, y1, x2, y2, th in rig.lines:
        on_line |= _segment_d2(torch, g, (x1, y1), (x2, y2)) <= (th / 2) ** 2
    for _, cx, cy, radius, a1, a2, th in rig.arcs:
        rel = g - torch.tensor([cx, cy], dtype=g.dtype, device=device)
        rr = rel.norm(dim=-1)
        ang = torch.atan2(rel[..., 1], rel[..., 0])
        ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
        on_line |= ((rr - radius).abs() <= th / 2) & (ang >= a1) & (ang <= a2)
    img[on_line] = torch.tensor(LINE, dtype=torch.float32, device=device)
    return img, ground


def _window(cam, xy_min, xy_max, height, pad_px=6):
    """The pixel box (x0, x1, y0, y1) that holds the field box at z =
    height, or None when it misses the image."""
    corners = np.array([[x, y, height] for x in (xy_min[0], xy_max[0])
                        for y in (xy_min[1], xy_max[1])])
    px = cam.field2image(corners)
    w, h = cam.size
    x0, y0 = np.floor(px.min(0)).astype(int) - pad_px
    x1, y1 = np.ceil(px.max(0)).astype(int) + pad_px
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    return None if x0 >= x1 or y0 >= y1 else (x0, x1, y0, y1)


def render(rig, scene: Scene, seed: int, device, chunk: int = 25) -> list:
    """Every camera's loop of raw RGGB frames: a list (one a camera) of
    host uint8 arrays (L, 2H, 2W)."""
    import torch

    loop = scene.loop
    banks = []
    for cam in rig.cameras:
        base, ground = _base_image(torch, rig, cam, device)
        w, h = cam.size
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                                torch.arange(w, dtype=torch.float64, device=device),
                                indexing="ij")
        plane = cam.image2field(torch.stack([xs, ys], -1), scene.robot_height, xp=torch)
        # each robot's pixel box over its whole path, or None when unseen
        boxes = []
        for r in range(scene.robots.shape[1]):
            lo = scene.robots[:, r, :2].min(0) - COVER_RADIUS
            hi = scene.robots[:, r, :2].max(0) + COVER_RADIUS
            boxes.append(_window(cam, lo, hi, scene.robot_height))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence([seed & (2**63 - 1), cam.cam_id])
                            .generate_state(1, np.uint64)[0] >> 1))
        bank = np.empty((loop, 2 * h, 2 * w), dtype=np.uint8)
        out = torch.from_numpy(bank)
        colors = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in (
            ("ball", BALL_ORANGE), ("cover", COVER_BLACK), ("yellow", YELLOW),
            ("blue", BLUE), ("green", GREEN), ("pink", PINK))}
        for f0 in range(0, loop, chunk):
            f1 = min(loop, f0 + chunk)
            img = base.expand(f1 - f0, h, w, 3).clone()
            ball = torch.tensor(scene.ball[f0:f1], dtype=torch.float64, device=device)
            d2 = ((ground[None] - ball[:, None, None, :]) ** 2).sum(-1)
            img[d2 <= scene.ball_radius ** 2] = colors["ball"]
            del d2
            for r, box in enumerate(boxes):
                if box is None:
                    continue
                x0, x1, y0, y1 = box
                sub = plane[y0:y1, x0:x1]
                st = torch.tensor(scene.robots[f0:f1, r], dtype=torch.float64, device=device)
                rel = sub[None] - st[:, None, None, :2]
                d2 = (rel ** 2).sum(-1)
                view = img[:, y0:y1, x0:x1]
                view[d2 <= COVER_RADIUS ** 2] = colors["cover"]
                view[d2 <= CENTER_BLOB_RADIUS ** 2] = colors[
                    "yellow" if scene.teams[r] == 0 else "blue"]
                cos = torch.cos(st[:, 2])[:, None, None]
                sin = torch.sin(st[:, 2])[:, None, None]
                bits = PATTERNS[int(scene.ids[r])]
                for slot, (bx, by) in enumerate(SIDE_BLOBS):
                    dx = rel[..., 0] - (cos * bx - sin * by)
                    dy = rel[..., 1] - (sin * bx + cos * by)
                    hit = dx * dx + dy * dy <= SIDE_BLOB_RADIUS ** 2
                    view[hit] = colors["green" if (bits >> (3 - slot)) & 1 else "pink"]
            if scene.noise_sigma > 0:
                img += scene.noise_sigma * torch.randn(img.shape, generator=gen, device=device)
            rgb = img.clamp_(0, 255).to(torch.uint8)
            raw = torch.empty((f1 - f0, 2 * h, 2 * w), dtype=torch.uint8, device=device)
            raw[:, 0::2, 0::2] = rgb[..., 0]
            raw[:, 0::2, 1::2] = rgb[..., 1]
            raw[:, 1::2, 0::2] = rgb[..., 1]
            raw[:, 1::2, 1::2] = rgb[..., 2]
            out[f0:f1].copy_(raw)
            del img, rgb, raw
        banks.append(bank)
        del base, ground, plane
    return banks
