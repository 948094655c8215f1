"""Copy of vision_processor_tpu/calib/lines.py for the port (host code:
numpy, cv2).

Field-line detection for auto-calibration.

Pipeline (reference src/calib/LineDetection.cpp:19-213): estimate the line
half-width from field/image ratios, ridge-threshold the grayscale image,
detect segments (OpenCV LSD), group segments by angle/offset/proximity, merge
groups to maximal-extent lines. The per-pixel stages are vectorized numpy;
the group/merge stages operate on segment lists (tens of entries).
"""
from __future__ import annotations

import math

import numpy as np

from ..models.camera import goal_boundary_width, visible_field_extent_estimation


def half_line_width_estimation(field, cam_id: int, cam_amount: int,
                               img_shape: tuple[int, int]) -> int:
    """Line half width in pixels from the camera/field extent ratio
    (reference src/calib/LineDetection.cpp:19-36)."""
    lo, hi = visible_field_extent_estimation(cam_id, cam_amount, field, True)
    extent = np.abs(hi - lo)
    cam = np.array([img_shape[1], img_shape[0]], dtype=np.float64)
    extent = np.sort(extent)[::-1]
    cam = np.sort(cam)[::-1]
    ratio = cam / extent
    return int(math.ceil(ratio.max() * field.line_thickness / 2.0))


def threshold_image(gray: np.ndarray, half_line_width: int, threshold: int) -> np.ndarray:
    """Ridge detector: a pixel is a line pixel when it is brighter than both
    neighbours at +-half_line_width in x or in y
    (reference src/calib/LineDetection.cpp:38-52). Returns uint8 {0, 255}."""
    h, w = gray.shape
    g = gray.astype(np.int32)
    out = np.zeros((h, w), dtype=np.uint8)
    r = half_line_width
    if 2 * r >= min(h, w):
        return out
    center = g[r:-r, r:-r]
    left = g[r:-r, : w - 2 * r]
    right = g[r:-r, 2 * r :]
    up = g[: h - 2 * r, r:-r]
    down = g[2 * r :, r:-r]
    ridge_x = ((center - left) > threshold) & ((center - right) > threshold)
    ridge_y = ((center - up) > threshold) & ((center - down) > threshold)
    out[r:-r, r:-r] = np.where(ridge_x | ridge_y, 255, 0)
    return out


def detect_segments(thresholded: np.ndarray, min_length: float):
    """LSD line segments on the thresholded mask, filtered by length.
    Returns a list of ((x1, y1), (x2, y2)) float tuples."""
    import cv2

    detector = cv2.createLineSegmentDetector()
    lines, *_ = detector.detect(thresholded)
    segments = []
    if lines is None:
        return segments
    for row in lines.reshape(-1, 4):
        a = np.array([row[0], row[1]], dtype=np.float64)
        b = np.array([row[2], row[3]], dtype=np.float64)
        if np.linalg.norm(b - a) >= min_length:
            segments.append((a, b))
    return segments


def group_line_segments(segments, max_angle: float, max_offset: float,
                        proximity: float = 200.0):
    """Group near-collinear, nearby segments (reference
    src/calib/LineDetection.cpp:54-88). Returns list of groups, each sorted
    by descending length."""
    remaining = list(segments)
    groups = []
    while remaining:
        compound = [remaining.pop(0)]
        i = 0
        while i < len(compound):
            root = compound[i]
            v1 = root[1] - root[0]
            n1 = np.linalg.norm(v1)
            j = 0
            while j < len(remaining):
                seg = remaining[j]
                v2 = seg[1] - seg[0]
                n2 = np.linalg.norm(v2)
                cos = abs(float(v1 @ v2)) / max(n1 * n2, 1e-12)
                angle = math.acos(min(cos, 1.0))
                off1 = abs(v1[0] * (seg[0][1] - root[0][1])
                           - (seg[0][0] - root[0][0]) * v1[1]) / max(n1, 1e-12)
                off2 = abs(v1[0] * (seg[1][1] - root[0][1])
                           - (seg[1][0] - root[0][0]) * v1[1]) / max(n1, 1e-12)
                near = min(
                    np.linalg.norm(root[0] - seg[0]),
                    np.linalg.norm(root[1] - seg[0]),
                    np.linalg.norm(root[0] - seg[1]),
                    np.linalg.norm(root[1] - seg[1]),
                ) <= proximity
                if angle <= max_angle and min(off1, off2) <= max_offset and near:
                    compound.append(seg)
                    remaining.pop(j)
                else:
                    j += 1
            i += 1
        compound.sort(key=lambda s: -np.linalg.norm(s[1] - s[0]))
        groups.append(compound)
    return groups


def merge_line_segments(groups):
    """Merge each group to the maximal-extent endpoint pair
    (reference src/calib/LineDetection.cpp:90-137)."""
    merged = []
    for compound in groups:
        a, b = compound[0]
        for seg in compound[1:]:
            candidates = [(a, b), (a, seg[0]), (a, seg[1]), (seg[0], b),
                          (seg[1], b), (seg[0], seg[1])]
            a, b = max(candidates, key=lambda p: np.linalg.norm(p[1] - p[0]))
        merged.append((a, b))
    return merged


def line_line_intersection(a, b):
    """Intersection point of two infinite lines given as segments."""
    x = b[0] - a[0]
    da = a[1] - a[0]
    db = b[1] - b[0]
    cross = da[0] * db[1] - da[1] * db[0]
    if abs(cross) < 1e-8:
        return np.array([math.inf, math.inf])
    t1 = (x[0] * db[1] - x[1] * db[0]) / cross
    return a[0] + da * t1


def line_intersections(lines, width: int, height: int, max_distance: float):
    """All pairwise intersections inside/near the image
    (reference src/calib/LineDetection.cpp:164-186)."""
    out = []
    min_x, min_y = -width * max_distance, -height * max_distance
    max_x, max_y = width + width * max_distance, height + height * max_distance
    for i in range(len(lines)):
        for j in range(i + 1, len(lines)):
            c = line_line_intersection(lines[i], lines[j])
            if min_x <= c[0] < max_x and min_y <= c[1] < max_y:
                out.append(c)
    return out


def find_outer_edges(points):
    """Clockwise convex quadrilateral with the largest area over the point
    set (reference src/calib/LineDetection.cpp:192-213)."""
    pts = [np.asarray(p, dtype=np.float64) for p in points]
    best = []
    best_area = 0.0
    n = len(pts)
    for ia in range(n):
        for ib in range(n):
            for ic in range(n):
                for idd in range(n):
                    if len({ia, ib, ic, idd}) != 4:
                        continue
                    a, b, c, d = pts[ia], pts[ib], pts[ic], pts[idd]
                    center = line_line_intersection((a, c), (b, d))
                    if not (
                        min(a[0], c[0]) < center[0] < max(a[0], c[0])
                        and min(a[1], c[1]) < center[1] < max(a[1], c[1])
                        and min(b[0], d[0]) < center[0] < max(b[0], d[0])
                        and min(b[1], d[1]) < center[1] < max(b[1], d[1])
                    ):
                        continue
                    ac = c - a
                    bd = d - b
                    area = 0.5 * abs(ac[0] * bd[1] - bd[0] * ac[1])
                    if area > best_area:
                        best_area = area
                        best = [a, b, c, d]
    return best


def get_line_pixels(thresholded: np.ndarray) -> np.ndarray:
    """(n, 2) float array of (x, y) coordinates of set pixels."""
    ys, xs = np.nonzero(thresholded)
    return np.stack([xs, ys], axis=-1).astype(np.float64)
