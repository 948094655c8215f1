"""Copy of vision_processor_tpu/calib/geometry.py for the port (host code:
numpy, scipy, cv2).

Full camera auto-calibration from field-line observations.

Orchestrates the one-shot calibration the reference runs when geometry is
known but no calibration exists for this camera
(reference src/calib/GeomModel.cpp:505-620):

    gray -> ridge threshold -> LSD segments -> group/merge -> per-line pixel
    sets -> corner calibration (distortion LM x pose LM over corner
    permutations) -> optional direct refinement -> model error -> calib proto

Pose fits use scipy Levenberg-Marquardt (the reference uses Eigen LM with
numerical diff). The direct refinement's nearest-line-pixel residual is
evaluated through a distance transform of the line-pixel mask, which makes
each LM evaluation O(model points) instead of O(points x pixels).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field as dc_field
from itertools import permutations
from pathlib import Path

import numpy as np
from scipy.optimize import least_squares

from ..models.camera import CameraModel, goal_boundary_width, visible_field_extent_estimation
from ..utils.log import get_logger
from .distortion import calibrate_distortion
from .lines import (
    detect_segments,
    get_line_pixels,
    group_line_segments,
    half_line_width_estimation,
    merge_line_segments,
    threshold_image,
)

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# field model geometry
# ---------------------------------------------------------------------------


def field_to_lines(field):
    """Field markings as ((p1, p2) segment list, arc list)."""
    lines = [
        (np.array([l.p1.x, l.p1.y]), np.array([l.p2.x, l.p2.y]))
        for l in field.field_lines
    ]
    arcs = [
        {
            "center": np.array([a.center.x, a.center.y]),
            "radius": a.radius,
            "a1": a.a1,
            "a2": a.a2,
        }
        for a in field.field_arcs
    ]
    return lines, arcs


def points_at_lines(field, field_points: np.ndarray, half_width: float) -> np.ndarray:
    """(n,) mask: field-plane points within half_width of any marking
    (reference src/calib/GeomModel.cpp:168-198), vectorized."""
    lines, arcs = field_to_lines(field)
    n = len(field_points)
    mask = np.zeros(n, dtype=bool)
    hw2 = half_width * half_width
    for p1, p2 in lines:
        v = p2 - p1
        vv = float(v @ v)
        w = field_points - p1
        t = np.clip((w @ v) / vv, 0.0, 1.0) if vv > 0 else np.zeros(n)
        d2 = np.sum((w - t[:, None] * v) ** 2, axis=-1)
        mask |= d2 <= hw2
    for arc in arcs:
        rel = field_points - arc["center"]
        ang = np.arctan2(rel[:, 1], rel[:, 0])
        ang = np.where(ang < 0, ang + 2 * math.pi, ang)
        r = np.linalg.norm(rel, axis=-1)
        mask |= (
            (np.abs(r - arc["radius"]) <= half_width)
            & (ang >= arc["a1"])
            & (ang <= arc["a2"])
        )
    return mask


def model_error(field, model: CameraModel, line_pixels: np.ndarray) -> int:
    """Count of detected line pixels that do not land on the projected field
    model (reference src/calib/GeomModel.cpp:200-215)."""
    if len(line_pixels) == 0:
        return 0
    half_width = field.line_thickness / 2.0
    fp = model.image2field(line_pixels, 0.0)[:, :2]
    ok = np.isfinite(fp).all(axis=1)
    on = np.zeros(len(fp), dtype=bool)
    on[ok] = points_at_lines(field, fp[ok], half_width)
    return int((~on).sum())


def model_miss_rate(field, model: CameraModel, thresholded: np.ndarray,
                    stride: int = 2) -> float:
    """Miss rate over the model's projected area: fraction of model-covered
    image pixels that are not detected line pixels
    (reference src/calib/GeomModel.cpp:218-236). Subsampled by `stride`."""
    h, w = thresholded.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    px = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float64)
    fp = model.image2field(px, 0.0)[:, :2]
    ok = np.isfinite(fp).all(axis=1)
    half_width = field.line_thickness / 2.0
    at = np.zeros(len(px), dtype=bool)
    at[ok] = points_at_lines(field, fp[ok], half_width)
    if at.sum() == 0:
        return 1.0
    detected = thresholded[ys.reshape(-1), xs.reshape(-1)] > 0
    hit = int((at & detected).sum())
    miss = int((at & ~detected).sum())
    return miss / max(hit + miss, 1)


def is_clockwise_convex_quadrilateral(vertices) -> bool:
    """Convexity + clockwise winding test
    (reference src/calib/GeomModel.cpp:256-338)."""
    pts = [np.asarray(v, dtype=np.float64) for v in vertices]
    clockwise = 0.0
    w_sign = 0.0
    x_sign = x_first = x_flips = 0
    y_sign = y_first = y_flips = 0

    curr = pts[-1]
    nxt = pts[-1]
    for v in pts:
        prev, curr, nxt = curr, nxt, v
        b = curr - prev
        a = nxt - curr
        clockwise += a[0] * (nxt[1] + curr[1])
        if a[0] > 0:
            if x_sign == 0:
                x_first = 1
            elif x_sign < 0:
                x_flips += 1
            x_sign = 1
        elif a[0] < 0:
            if x_sign == 0:
                x_first = -1
            elif x_sign > 0:
                x_flips += 1
            x_sign = -1
        if x_flips > 2:
            return False
        if a[1] > 0:
            if y_sign == 0:
                y_first = 1
            elif y_sign < 0:
                y_flips += 1
            y_sign = 1
        elif a[1] < 0:
            if y_sign == 0:
                y_first = -1
            elif y_sign > 0:
                y_flips += 1
            y_sign = -1
        if y_flips > 2:
            return False
        w = b[0] * a[1] - a[0] * b[1]
        if w_sign == 0 and w != 0:
            w_sign = w
        elif (w_sign > 0 and w < 0) or (w_sign < 0 and w > 0):
            return False

    if x_sign != 0 and x_first != 0 and x_sign != x_first:
        x_flips += 1
    if y_sign != 0 and y_first != 0 and y_sign != y_first:
        y_flips += 1
    if x_flips != 2 or y_flips != 2:
        return False
    return clockwise < 0


# ---------------------------------------------------------------------------
# pose fits
# ---------------------------------------------------------------------------


def _apply_pose(model: CameraModel, x, calib_height: bool) -> None:
    model.focal_length = float(x[0])
    model.update_euler(np.array([x[1], x[2], x[3]]))
    model.pos[0] = x[4]
    model.pos[1] = x[5]
    if calib_height:
        model.pos[2] = x[6]
    if model.focal_length < 0:
        # focal sign flip: rotate 90° around z instead
        # (reference src/calib/GeomModel.cpp:480-483)
        model.focal_length = -model.focal_length
        rot = np.array(
            [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
        )
        from ..models.camera import matrix_to_quat

        model.quat = matrix_to_quat(rot @ model.rotation())


def _pose_vector(model: CameraModel, calib_height: bool) -> np.ndarray:
    euler = model.get_euler()
    x = [model.focal_length, euler[0], euler[1], euler[2], model.pos[0], model.pos[1]]
    if calib_height:
        x.append(model.pos[2])
    return np.array(x, dtype=np.float64)


def _fit_pose_to_corners(model: CameraModel, image_corners, model_corners,
                         calib_height: bool) -> bool:
    """LM pose fit of the 4 visible-extent corners
    (reference src/calib/GeomModel.cpp:381-424)."""

    def residuals(x):
        m = _copy_model(model)
        m.focal_length = float(x[0])
        m.update_euler(np.array([x[1], x[2], x[3]]))
        m.pos[0] = x[4]
        m.pos[1] = x[5]
        if calib_height:
            m.pos[2] = x[6]
        proj = m.field2image(
            np.concatenate(
                [model_corners, np.zeros((len(model_corners), 1))], axis=1
            )
        )
        return (np.asarray(image_corners) - proj).reshape(-1)

    x0 = _pose_vector(model, calib_height)
    # bounded trust-region LM: keeps the fit out of the degenerate mirror
    # basin (focal < 0 / camera below the carpet) that a pure unbounded LM
    # can fall into from a coarse initial guess
    lower = [10.0, -2 * math.pi, -2 * math.pi, -2 * math.pi, -3e4, -3e4]
    upper = [1e5, 2 * math.pi, 2 * math.pi, 2 * math.pi, 3e4, 3e4]
    scale = [1000.0, 1.0, 1.0, 1.0, 1000.0, 1000.0]
    if calib_height:
        lower.append(100.0)
        upper.append(3e4)
        scale.append(1000.0)
    x0 = np.clip(x0, lower, upper)
    try:
        res = least_squares(
            residuals, x0, method="trf", bounds=(lower, upper),
            x_scale=scale, max_nfev=400,
        )
    except Exception as exc:
        log.warning("pose fit failed: %s", exc)
        return False
    _apply_pose(model, res.x, calib_height)
    return True


def _copy_model(model: CameraModel) -> CameraModel:
    return CameraModel(
        focal_length=model.focal_length,
        principal_point=model.principal_point.copy(),
        distortion_k2=model.distortion_k2,
        pos=model.pos.copy(),
        quat=model.quat.copy(),
        size=model.size.copy(),
    )


def corner_calibration(field, cam_id: int, cam_amount: int, line_corners,
                       merged_pixels, thresholded, calib_height: bool,
                       model: CameraModel) -> bool:
    """Try all clockwise-convex corner permutations, alternating distortion
    and pose fits; keep the permutation with the lowest miss rate
    (reference src/calib/GeomModel.cpp:426-503)."""
    corners = [np.asarray(c, dtype=np.float64) for c in line_corners]
    if len(corners) != 4:
        log.warning("Wrong line corner amount: %d/4", len(corners))
        return False

    lo, hi = visible_field_extent_estimation(cam_id, cam_amount, field, False)
    model_corners = np.array(
        [[lo[0], lo[1]], [lo[0], hi[1]], [hi[0], hi[1]], [hi[0], lo[1]]]
    )

    best_err = math.inf
    best_model = None
    for perm in permutations(corners, 4):
        if not is_clockwise_convex_quadrilateral(perm):
            continue
        if not np.array_equal(perm[0], corners[0]):
            continue  # first point stays the min-min corner
        # pose-first: converge the distortion-free pose, then refine the
        # distortion and re-fit, keeping whichever scores better — the
        # blind distortion/pose alternation can spiral on views where arc
        # pixels contaminate the straight-line groups
        candidate = _copy_model(model)
        for _ in range(6):
            if not _fit_pose_to_corners(
                candidate, list(perm), model_corners, calib_height
            ):
                break
        err = model_miss_rate(field, candidate, thresholded)

        refined = _copy_model(candidate)
        calibrate_distortion(merged_pixels, refined)
        for _ in range(3):
            _fit_pose_to_corners(refined, list(perm), model_corners, calib_height)
        err_ref = model_miss_rate(field, refined, thresholded)
        if err_ref < err:
            candidate, err = refined, err_ref

        if err < best_err:
            best_err = err
            best_model = candidate

    if best_model is None:
        log.warning("Unable to find matching field model")
        return False
    _assign_model(model, best_model)
    return True


def _assign_model(dst: CameraModel, src: CameraModel) -> None:
    dst.focal_length = src.focal_length
    dst.principal_point = src.principal_point.copy()
    dst.distortion_k2 = src.distortion_k2
    dst.pos = src.pos.copy()
    dst.quat = src.quat.copy()
    dst.size = src.size.copy()


def field_model_points(field, cam_id: int, cam_amount: int,
                       step: float = 100.0) -> np.ndarray:
    """Field-marking model points inside this camera's visible extent
    (reference src/calib/GeomModel.cpp:340-360), (n, 3) with z=0."""
    lines, arcs = field_to_lines(field)
    pts = []
    for p1, p2 in lines:
        delta = p2 - p1
        steps = int(np.linalg.norm(delta) / step)
        if steps == 0:
            continue
        d = delta / steps
        for i in range(steps):
            pts.append(p1 + d * i)
    for arc in arcs:
        astep = 2.0 * math.asin(min(1.0, (step / 2.0) / arc["radius"]))
        a = arc["a1"]
        while a <= arc["a2"]:
            pts.append(
                arc["center"]
                + np.array([math.cos(a), math.sin(a)]) * arc["radius"]
            )
            a += astep
    pts = np.array(pts)
    if len(pts) == 0:
        return np.zeros((0, 3))
    lo, hi = visible_field_extent_estimation(cam_id, cam_amount, field, True)
    keep = (
        (pts[:, 0] >= lo[0]) & (pts[:, 0] <= hi[0])
        & (pts[:, 1] >= lo[1]) & (pts[:, 1] <= hi[1])
    )
    pts = pts[keep]
    return np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)


def distance_sampler(line_pixels: np.ndarray, img_shape: tuple[int, int]):
    """Bilinear sampler over the distance transform of the line-pixel mask:
    sample(px) = distance to the nearest detected line pixel, with a smooth
    out-of-image penalty. Makes each LM evaluation O(model points)."""
    import cv2

    h, w = img_shape
    mask = np.full((h, w), 255, dtype=np.uint8)
    ip = line_pixels.astype(np.int32)
    ip = ip[(ip[:, 0] >= 0) & (ip[:, 0] < w) & (ip[:, 1] >= 0) & (ip[:, 1] < h)]
    mask[ip[:, 1], ip[:, 0]] = 0
    dist = cv2.distanceTransform(mask, cv2.DIST_L2, 5).astype(np.float64)

    def sample_dist(px):
        x = np.clip(px[:, 0], 0, w - 1.001)
        y = np.clip(px[:, 1], 0, h - 1.001)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx = x - x0
        fy = y - y0
        d = (
            dist[y0, x0] * (1 - fx) * (1 - fy)
            + dist[y0, x0 + 1] * fx * (1 - fy)
            + dist[y0 + 1, x0] * (1 - fx) * fy
            + dist[y0 + 1, x0 + 1] * fx * fy
        )
        # smooth out-of-image penalty: distance to the clamped position
        d = d + np.hypot(px[:, 0] - x, px[:, 1] - y)
        return d

    return sample_dist


def direct_calibration_refinement(field, cam_id: int, cam_amount: int,
                                  merged_pixels, line_pixels: np.ndarray,
                                  img_shape: tuple[int, int],
                                  calib_height: bool, model: CameraModel) -> None:
    """Refine the pose against all detected line pixels: residual per model
    point = distance to the nearest line pixel
    (reference src/calib/GeomModel.cpp:340-379). The nearest-pixel distance
    is read from a distance transform of the line-pixel mask."""
    pts3 = field_model_points(field, cam_id, cam_amount)
    if len(pts3) == 0:
        return
    sample_dist = distance_sampler(line_pixels, img_shape)

    def residuals(x):
        m = _copy_model(model)
        m.focal_length = float(x[0])
        m.update_euler(np.array([x[1], x[2], x[3]]))
        m.pos[0] = x[4]
        m.pos[1] = x[5]
        if calib_height:
            m.pos[2] = x[6]
        proj = m.field2image(pts3)
        return sample_dist(proj)

    x0 = _pose_vector(model, calib_height)
    lower = [10.0, -2 * math.pi, -2 * math.pi, -2 * math.pi, -3e4, -3e4]
    upper = [1e5, 2 * math.pi, 2 * math.pi, 2 * math.pi, 3e4, 3e4]
    scale = [1000.0, 1.0, 1.0, 1.0, 1000.0, 1000.0]
    if calib_height:
        lower.append(100.0)
        upper.append(3e4)
        scale.append(1000.0)
    x0c = np.clip(x0, lower, upper)
    try:
        res = least_squares(
            residuals, x0c, method="trf", bounds=(lower, upper),
            x_scale=scale, max_nfev=200,
        )
    except Exception as exc:
        log.warning("direct refinement failed: %s", exc)
        return
    refined = _copy_model(model)
    _apply_pose(refined, res.x, calib_height)
    calibrate_distortion(merged_pixels, refined)
    # keep the refinement only when it actually lowers the model error —
    # the corner fit stays the fallback
    before = model_error(field, model, line_pixels)
    after = model_error(field, refined, line_pixels)
    if after <= before:
        _assign_model(model, refined)
    else:
        log.info(
            "refinement rejected (model error %d -> %d), keeping corner fit",
            before, after,
        )


# ---------------------------------------------------------------------------
# diagnostics + orchestration
# ---------------------------------------------------------------------------


@dataclass
class CalibDiagnostic:
    """JSON diagnostic dump of calibration inputs/outputs
    (reference src/calib/CalibDiagnostic.cpp:26-80)."""

    camera_id: int = 0
    image_width: int = 0
    image_height: int = 0
    line_corners: list = dc_field(default_factory=list)
    camera_height: float = 0.0
    refinement_enabled: bool = True
    half_line_width: int = 0
    line_pixel_count: int = 0
    raw_line_segments: int = 0
    merged_line_count: int = 0
    focal_length: float = 0.0
    position: list = dc_field(default_factory=list)
    euler: list = dc_field(default_factory=list)
    distortion_k2: float = 0.0
    principal_point: list = dc_field(default_factory=list)
    total_error: int = 0
    error_rate: float = 0.0

    def write_json(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        data = {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in self.__dict__.items()
        }
        data["line_corners"] = [list(map(float, c)) for c in self.line_corners]
        path.write_text(json.dumps(data, indent=2))


def geometry_calibration(config, field, rgb: np.ndarray,
                         out_dir: str | Path = "img") -> CameraModel | None:
    """Full auto-calibration from one RGB frame. Returns the fitted model
    (caller broadcasts the calib proto), or None on failure."""
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = out_dir / f"{config.cam_id}."

    gray = cv2.cvtColor(rgb.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    h, w = gray.shape

    diag = CalibDiagnostic(
        camera_id=config.cam_id,
        image_width=w,
        image_height=h,
        line_corners=list(config.line_corners),
        camera_height=config.camera_height,
        refinement_enabled=config.geometry_refinement,
    )

    half_lw = half_line_width_estimation(
        field, config.cam_id, config.camera_amount, gray.shape
    )
    diag.half_line_width = half_lw
    log.info("Half line width: %d", half_lw)

    thresholded = threshold_image(gray, half_lw, config.field_line_threshold)
    cv2.imwrite(str(prefix) + "pixels.png", thresholded)

    line_pixels = get_line_pixels(thresholded)
    diag.line_pixel_count = len(line_pixels)

    segments = detect_segments(thresholded, config.min_line_segment_length)
    diag.raw_line_segments = len(segments)
    log.info("Line segments: %d", len(segments))

    groups = group_line_segments(
        segments, config.max_line_segment_angle, config.max_line_segment_offset
    )
    merged = merge_line_segments(groups)
    diag.merged_line_count = len(merged)
    log.info("Lines: %d", len(merged))

    # assign line pixels to long merged lines (reference GeomModel.cpp:558-578);
    # a 2 px floor keeps enough support on thin (1 px half-width) lines
    merged_pixels = []
    sq_hw = float(max(half_lw, 2) ** 2)
    for group, (a, b) in zip(groups, merged):
        if np.linalg.norm(b - a) < h / 2:
            merged_pixels.append(np.empty((0, 2)))
            continue
        sel = np.zeros(len(line_pixels), dtype=bool)
        for seg in group:
            v = seg[1] - seg[0]
            vv = float(v @ v)
            if vv == 0:
                continue
            wv = line_pixels - seg[0]
            t = np.clip((wv @ v) / vv, 0.0, 1.0)
            d2 = np.sum((wv - t[:, None] * v) ** 2, axis=-1)
            sel |= d2 <= sq_hw
        merged_pixels.append(line_pixels[sel])
    merged_pixels = [m for m in merged_pixels if len(m) > 0]

    calib_height = config.camera_height == 0.0
    model = CameraModel.initial_guess(
        np.array([w, h]), config.cam_id, config.camera_amount,
        config.camera_height, field,
    )

    ok = corner_calibration(
        field, config.cam_id, config.camera_amount, config.line_corners,
        merged_pixels, thresholded, calib_height, model,
    )
    if not ok:
        return None

    if config.geometry_refinement:
        direct_calibration_refinement(
            field, config.cam_id, config.camera_amount, merged_pixels,
            line_pixels, gray.shape, calib_height, model,
        )

    err = model_error(field, model, line_pixels)
    rate = err / max(len(line_pixels), 1)
    log.info("Best model error rate: %.4f", rate)

    diag.focal_length = model.focal_length
    diag.position = [float(v) for v in model.pos]
    diag.euler = [float(v) for v in model.get_euler()]
    diag.distortion_k2 = model.distortion_k2
    diag.principal_point = [float(v) for v in model.principal_point]
    diag.total_error = err
    diag.error_rate = rate
    diag.write_json(str(prefix) + "calib.json")

    return model
