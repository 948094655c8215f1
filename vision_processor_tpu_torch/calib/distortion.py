"""Copy of vision_processor_tpu/calib/distortion.py for the port (host code:
numpy, scipy).

Radial distortion calibration from detected field-line pixel sets.

Levenberg-Marquardt over (k2, principal point) minimizing the point-to-
fitted-line error of undistorted line pixels — the Thormählen-style
line-based single-view method the reference uses
(reference src/calib/Distortion.cpp:105-125). The total-least-squares line
fit and residuals are vectorized numpy; scipy provides the LM loop (the
reference uses Eigen LM with numerical differentiation).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares

from ..models.camera import CameraModel
from ..utils.log import get_logger

log = get_logger(__name__)


def line_tls_residuals(undistorted: np.ndarray) -> np.ndarray:
    """Signed distances of points to their own total-least-squares line
    (reference src/calib/Distortion.cpp:21-69)."""
    ex, ey = undistorted.mean(axis=0)
    exx, eyy = (undistorted**2).mean(axis=0)
    exy = (undistorted[:, 0] * undistorted[:, 1]).mean()

    if exx - ex * ex >= eyy - ey * ey:
        a = (exy - ex * ey) / (exx - ex * ex)
        b = (exx * ey - ex * exy) / (exx - ex * ex)
        norm = np.sqrt(a * a + 1)
        n = np.array([-a / norm, 1 / norm])
        d0 = b / norm
    else:
        c = (exy - ex * ey) / (eyy - ey * ey)
        d = (eyy * ex - ey * exy) / (eyy - ey * ey)
        norm = np.sqrt(c * c + 1)
        n = np.array([1 / norm, -c / norm])
        d0 = d / norm
    return undistorted @ n - d0


def _normalize_undistort(points, focal, pp, k2):
    n = (points - pp) / focal
    r2 = np.sum(n * n, axis=-1, keepdims=True)
    return n * (1.0 + k2 * r2)


def calibrate_distortion(
    line_pixel_groups: list[np.ndarray],
    model: CameraModel,
    fit_principal_point: bool = False,
) -> bool:
    """Fit the radial distortion (optionally + principal point) in place.

    The joint (k2, principal point) problem of the reference
    (reference src/calib/Distortion.cpp:105-125) is near-degenerate on
    nadir views — principal-point shifts trade off against camera position —
    so the principal point stays fixed unless explicitly requested."""
    groups = [np.asarray(g, dtype=np.float64) for g in line_pixel_groups if len(g) >= 2]
    if not groups:
        return False

    focal = model.focal_length
    w, h = float(model.size[0]), float(model.size[1])

    def residuals(x):
        k2, px, py = x
        pp = np.array([px, py])
        out = []
        for g in groups:
            u = _normalize_undistort(g, focal, pp, k2)
            out.append(line_tls_residuals(u))
        return np.concatenate(out)

    # staged bounded fit: k2 alone is well-conditioned; the joint
    # (k2, principal point) problem is near-degenerate for center-crossing
    # lines and an unbounded LM can walk the principal point out of the image
    pp0 = model.principal_point.copy()
    # soft_l1 downweights contaminated pixels (arc points caught in a line
    # group); k2 bounded to the physical single-coefficient range
    r1 = least_squares(
        lambda k: residuals([k[0], pp0[0], pp0[1]]),
        np.array([np.clip(model.distortion_k2, -0.3, 0.3)]),
        method="trf", bounds=([-0.3], [0.3]), loss="soft_l1",
        f_scale=0.01, max_nfev=100,
    )
    # identifiability guard: when the straightness cost barely depends on
    # k2 (short/thin line support), keep the current value instead of
    # letting the optimizer wander inside a flat valley
    cost_now = 0.5 * float(
        np.sum(residuals([model.distortion_k2, pp0[0], pp0[1]]) ** 2)
    )
    if cost_now <= 1e-12 or (cost_now - r1.cost) < 0.1 * cost_now:
        return False
    if not fit_principal_point:
        k2, px, py = r1.x[0], pp0[0], pp0[1]
    else:
        x0 = np.array([r1.x[0], pp0[0], pp0[1]])
        lower = [-0.5, 0.0, 0.0]
        upper = [0.5, w - 1.0, h - 1.0]
        res = least_squares(
            residuals, np.clip(x0, lower, upper), method="trf",
            bounds=(lower, upper), x_scale=[0.01, 100.0, 100.0], max_nfev=200,
        )
        if res.cost <= r1.cost:
            k2, px, py = res.x
        else:
            k2, px, py = r1.x[0], pp0[0], pp0[1]

    model.distortion_k2 = float(k2)
    model.principal_point = np.array([px, py])
    return True
