"""Copy of vision_processor_tpu/calib/pair.py for the port (host code:
numpy, scipy).

Two-camera height calibration from shared-region observations.

A single near-nadir camera viewing the planar field cannot separate focal
length from mounting height: scaling both leaves the z=0 projection
exactly invariant (for a straight-down view it is a pure homothety), so
the `camera_height: 0` single-camera fit
(reference src/calib/GeomModel.cpp:426-503, the calib_height branch) is
ill-conditioned along that direction — and the ambiguity survives a joint
two-camera LINE fit too, because scaling (h, f0, f1) together moves along
the shared invariant manifold.

What does break it: an object of KNOWN nonzero height seen by BOTH
cameras of the pair. Unprojecting the observation to z=obj_height applies
a parallax correction proportional to (h - z)/h; with the rig height
wrong, each camera's corrected ground position shifts toward its own
nadir point — in opposite directions for a camera pair looking at the
overlap region from two sides. Robots (GC team height, default 143 mm)
and the ball (21.5 mm, weaker lever) in the overlap provide exactly these
observations; the reference's per-camera processes exchange them over the
tracker anyway (reference src/udpsocket.cpp:204-256).

The solver walks the ambiguity manifold: for candidate rig height h every
camera keeps its plane-consistent calibration by scaling focal with
height (f_i' = f_i * h / h_i), and h minimizes the disagreement of the
unprojected shared observations.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import minimize_scalar

from ..models.camera import CameraModel
from ..utils.log import get_logger

log = get_logger(__name__)


def _scaled_model(model: CameraModel, h: float) -> CameraModel:
    """The plane-consistent variant of `model` at rig height h: focal
    scales with height so all z=0 projections are preserved (the exact
    invariance that makes single-camera height unobservable)."""
    return CameraModel(
        focal_length=model.focal_length * h / model.pos[2],
        principal_point=model.principal_point.copy(),
        distortion_k2=model.distortion_k2,
        pos=np.array([model.pos[0], model.pos[1], h]),
        quat=model.quat.copy(),
        size=model.size.copy(),
    )


def height_from_shared_objects(
    models: list[CameraModel],
    observations: list[tuple[int, np.ndarray, int, np.ndarray, float]],
    h_bounds: tuple[float, float] = (1500.0, 15000.0),
    free: set[int] | None = None,
) -> float | None:
    """Solve the shared rig height from dual-view object observations.

    observations: (cam_a, px_a, cam_b, px_b, obj_z) tuples — the same
    physical object (center pixel px, object height obj_z in mm) seen by
    two cameras. models: the plane-consistent per-camera calibrations
    (any height on their ambiguity manifolds). ``free``: camera indices
    whose height is being solved (default all); cameras NOT in ``free``
    have operator-measured heights and stay fixed in the cost — a
    trusted camera in an overlap pair pins h even harder than two free
    ones. Returns the fitted height or None; models are NOT modified
    (use apply_height on the free subset).
    """
    if free is None:
        free = set(range(len(models)))
    else:
        free = set(free)
    # observations between two trusted cameras carry no information
    # about h (their models do not move with it)
    observations = [o for o in observations if o[0] in free or o[2] in free]
    if not observations:
        return None

    def cost(h):
        ms = {}
        total = 0.0
        for cam_a, px_a, cam_b, px_b, obj_z in observations:
            for c in (cam_a, cam_b):
                if c not in ms:
                    ms[c] = (_scaled_model(models[c], h)
                             if c in free else models[c])
            pa = ms[cam_a].image2field(np.asarray(px_a, float)[None, :], obj_z)[0]
            pb = ms[cam_b].image2field(np.asarray(px_b, float)[None, :], obj_z)[0]
            total += float(np.sum((pa[:2] - pb[:2]) ** 2))
        return total / len(observations)

    try:
        res = minimize_scalar(cost, bounds=h_bounds, method="bounded",
                              options={"xatol": 1.0})
    except Exception as exc:
        log.warning("pair height fit failed: %s", exc)
        return None
    if not res.success:
        return None
    h = float(res.x)
    log.info(
        "pair height calibration: h=%.0f mm (mean overlap disagreement "
        "%.1f -> %.1f mm)", h,
        np.sqrt(cost(float(np.mean([m.pos[2] for m in models])))),
        np.sqrt(res.fun),
    )
    return h


def apply_height(models: list[CameraModel], h: float) -> None:
    """Move every model to rig height h along its plane-consistent
    manifold (focal scales with height), in place."""
    for m in models:
        m.focal_length = m.focal_length * h / m.pos[2]
        m.pos[2] = h


def observations_from_detections(
    dets_by_cam: dict[int, list],
    models: list[CameraModel],
    max_pair_dist: float = 500.0,
) -> list[tuple[int, np.ndarray, int, np.ndarray, float]]:
    """Build dual-view observations from per-camera detections.

    dets_by_cam: cam_id -> list of (bot_id, pixel_xy, obj_height_mm).
    Two cameras' detections of the same bot id whose current unprojected
    positions fall within max_pair_dist are treated as the same physical
    robot (the overlap-region case)."""
    obs = []
    cams = sorted(dets_by_cam)
    for i, ca in enumerate(cams):
        for cb in cams[i + 1:]:
            for id_a, px_a, za in dets_by_cam[ca]:
                for id_b, px_b, zb in dets_by_cam[cb]:
                    if id_a != id_b or za != zb:
                        continue
                    pa = models[ca].image2field(
                        np.asarray(px_a, float)[None, :], za)[0]
                    pb = models[cb].image2field(
                        np.asarray(px_b, float)[None, :], zb)[0]
                    if np.sum((pa[:2] - pb[:2]) ** 2) < max_pair_dist ** 2:
                        obs.append((ca, np.asarray(px_a, float),
                                    cb, np.asarray(px_b, float), za))
    return obs
