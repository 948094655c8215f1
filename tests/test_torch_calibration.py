"""The port's single-camera auto-calibration (``calib/lines.py``,
``calib/distortion.py``, ``calib/geometry.py``) on the CPU: the six cases
of tests/test_calibration.py on the port's modules and its plain geometry,
then parity with the JAX package on one rendered image (the same numpy RGB
through both): the line pixels and segments equal, the fitted camera model
within 1e-9 relative (both are the same float64 host code on numpy, scipy
and cv2). The camera-model conversions the fits use are held to the JAX
package's in tests/test_torch_pair_calib.py.
"""
from __future__ import annotations

import numpy as np
import pytest

from vision_processor_tpu.calib import geometry as JG
from vision_processor_tpu.calib import lines as JL
from vision_processor_tpu.models import camera as JC
from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig
from vision_processor_tpu_torch.calib import geometry as G
from vision_processor_tpu_torch.calib import lines as L
from vision_processor_tpu_torch.calib.distortion import calibrate_distortion
from vision_processor_tpu_torch.io.synthetic import Scene, render_rgb
from vision_processor_tpu_torch.models.camera import (
    CameraModel,
    visible_field_extent_estimation,
)
from vision_processor_tpu_torch.net.geometry_io import geometry_from_dict
from vision_processor_tpu_torch.utils.config import VisionConfig

FIELD = {"field": {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000,
    "goal_depth": 180, "goal_height": 160, "penalty_area_depth": 1000,
    "penalty_area_width": 2000, "goal_center_to_penalty_mark": 6000,
    "boundary_width": 300, "boundary_width_goal_line": 300,
    "center_circle_radius": 500, "line_thickness": 10,
    "ball_radius": 21.5, "max_robot_radius": 90.0,
}}


@pytest.fixture(scope="module")
def field():
    """The port's plain Division B field (no protobuf)."""
    return geometry_from_dict(FIELD).field


@pytest.fixture(scope="module")
def true_model():
    return CameraModel(
        focal_length=950.0,
        principal_point=np.array([470.0, 365.0]),
        distortion_k2=0.03,
        pos=np.array([-2150.0, 80.0, 4300.0]),
        size=np.array([960, 720]),
    )


@pytest.fixture(scope="module")
def field_image(true_model, field):
    # 4-camera rig: this camera sees quadrant 0
    return render_rgb(true_model, field, Scene(bots=[], balls=[], noise_sigma=1.0))


def _gray(rgb):
    import cv2

    return cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)


def _line_pixel_groups(lines, field_image):
    """Detected long-line pixel groups, as the calibration builds them."""
    gray = _gray(field_image)
    thresh = lines.threshold_image(gray, 2, 5)
    segs = lines.detect_segments(thresh, 10.0)
    groups = lines.group_line_segments(segs, np.deg2rad(3.0), 10.0)
    merged = lines.merge_line_segments(groups)
    pixels = lines.get_line_pixels(thresh)
    merged_pixels = []
    for group, (a, b) in zip(groups, merged):
        if np.linalg.norm(b - a) < gray.shape[0] / 2:
            continue
        sel = np.zeros(len(pixels), dtype=bool)
        for seg in group:
            v = seg[1] - seg[0]
            vv = float(v @ v)
            if vv == 0:
                continue
            w = pixels - seg[0]
            t = np.clip((w @ v) / vv, 0.0, 1.0)
            d2 = np.sum((w - t[:, None] * v) ** 2, axis=-1)
            sel |= d2 <= 4.0
        if sel.sum() > 10:
            merged_pixels.append(pixels[sel])
    return merged_pixels


def test_threshold_image_finds_lines(field_image):
    thresh = L.threshold_image(_gray(field_image), 2, 5)
    assert (thresh > 0).sum() > 500


def test_segments_and_grouping(field_image):
    thresh = L.threshold_image(_gray(field_image), 2, 5)
    segs = L.detect_segments(thresh, 10.0)
    assert len(segs) >= 6
    merged = L.merge_line_segments(L.group_line_segments(segs, np.deg2rad(3.0), 10.0))
    assert len(merged) <= len(segs)
    # the long touch and goal lines survive as long merged lines
    assert max(np.linalg.norm(b - a) for a, b in merged) > 300


def test_distortion_calibration_improves(field_image, true_model):
    groups = _line_pixel_groups(L, field_image)
    assert len(groups) >= 2
    model = CameraModel(
        focal_length=true_model.focal_length,
        principal_point=true_model.principal_point.copy(),
        distortion_k2=0.0, pos=true_model.pos.copy(), quat=true_model.quat.copy(),
        size=true_model.size.copy(),
    )
    assert calibrate_distortion(groups, model)
    assert abs(model.distortion_k2 - 0.03) < abs(0.0 - 0.03)


def _config(cls, true_model, field):
    """Camera 0 of 4 at the rig's measured height (a near-nadir view cannot
    separate focal length from height), line corners from the true model,
    the first the min-x/min-y corner and the rest shuffled."""
    cfg = cls()
    cfg.cam_id, cfg.camera_amount, cfg.camera_height = 0, 4, 4300.0
    lo, hi = visible_field_extent_estimation(0, 4, field, False)
    corners = [[lo[0], lo[1]], [lo[0], hi[1]], [hi[0], hi[1]], [hi[0], lo[1]]]
    px = [true_model.field2image(np.array([c[0], c[1], 0.0])) for c in corners]
    cfg.line_corners = [px[0], px[2], px[1], px[3]]
    return cfg


@pytest.fixture(scope="module")
def calibrated(field_image, true_model, field, tmp_path_factory):
    cfg = _config(VisionConfig, true_model, field)
    return G.geometry_calibration(cfg, field, field_image,
                                  out_dir=tmp_path_factory.mktemp("calib_img"))


def test_geometry_calibration_accuracy(calibrated, true_model):
    assert calibrated is not None
    pts = np.array([[x, y, 0.0] for x in np.linspace(-4400, -100, 8)
                    for y in np.linspace(-2900, 2900, 8)])
    true_px = true_model.field2image(pts)
    got_px = calibrated.field2image(pts)
    inside = ((true_px[:, 0] > 0) & (true_px[:, 0] < 960)
              & (true_px[:, 1] > 0) & (true_px[:, 1] < 720))
    err = np.linalg.norm(true_px[inside] - got_px[inside], axis=-1)
    assert np.median(err) < 5.0, f"median reprojection error {np.median(err):.2f} px"


def test_model_error_metric(calibrated, field_image, field):
    pixels = L.get_line_pixels(L.threshold_image(_gray(field_image), 2, 5))
    rate = G.model_error(field, calibrated, pixels) / len(pixels)
    assert rate < 0.3, f"model error rate {rate:.3f}"


def test_wide_angle_principal_point_identifiable(field):
    """k2 0.12: the joint (k2, principal point) stage recovers both from a
    wrong initial principal point."""
    true_pp = np.array([505.0, 330.0])
    wide = CameraModel(focal_length=560.0, principal_point=true_pp.copy(),
                       distortion_k2=0.12, pos=np.array([-2150.0, 80.0, 3400.0]),
                       size=np.array([960, 720]))
    img = render_rgb(wide, field, Scene(bots=[], balls=[], noise_sigma=1.0))
    groups = _line_pixel_groups(L, img)
    assert len(groups) >= 2
    fit = CameraModel(focal_length=wide.focal_length,
                      principal_point=np.array([480.0, 360.0]), distortion_k2=0.0,
                      pos=wide.pos.copy(), quat=wide.quat.copy(), size=wide.size.copy())
    assert calibrate_distortion(groups, fit, fit_principal_point=True)
    assert abs(fit.distortion_k2 - 0.12) < 0.05, fit.distortion_k2
    err0 = np.linalg.norm(np.array([480.0, 360.0]) - true_pp)
    assert np.linalg.norm(fit.principal_point - true_pp) < err0


# -- parity with the JAX package ---------------------------------------------


def test_lines_match_jax(field_image, field, divb_field):
    """Threshold map, line pixels, segments, groups and merged lines equal
    on the same image, and the half line width from the port's plain field
    equal to the JAX package's from the proto."""
    gray = _gray(field_image)
    assert L.half_line_width_estimation(field, 0, 4, gray.shape) == \
        JL.half_line_width_estimation(divb_field.geometry.field, 0, 4, gray.shape)
    thresh = L.threshold_image(gray, 2, 5)
    np.testing.assert_array_equal(thresh, JL.threshold_image(gray, 2, 5))
    np.testing.assert_array_equal(L.get_line_pixels(thresh), JL.get_line_pixels(thresh))
    segs, jsegs = L.detect_segments(thresh, 10.0), JL.detect_segments(thresh, 10.0)
    assert len(segs) == len(jsegs)
    for (a, b), (ja, jb) in zip(segs, jsegs):
        np.testing.assert_array_equal(np.stack([a, b]), np.stack([ja, jb]))
    merged = L.merge_line_segments(L.group_line_segments(segs, np.deg2rad(3.0), 10.0))
    jmerged = JL.merge_line_segments(JL.group_line_segments(jsegs, np.deg2rad(3.0), 10.0))
    np.testing.assert_array_equal(np.array(merged), np.array(jmerged))


def _model_vector(m) -> np.ndarray:
    return np.concatenate([m.pos, m.quat, [m.focal_length], m.principal_point,
                           [m.distortion_k2]])


def test_calibration_matches_jax(calibrated, field_image, true_model, divb_field,
                                 tmp_path):
    """The same image and config through the JAX package's
    geometry_calibration (the proto field) and the port's (its plain
    field): the fitted pose, quaternion, focal length, principal point and
    k2 within 1e-9 relative (scale: each quantity's magnitude, at least
    1). Both diagnostics files hold the same fit."""
    import json

    jtrue = JC.CameraModel(focal_length=true_model.focal_length,
                           principal_point=true_model.principal_point,
                           distortion_k2=true_model.distortion_k2, pos=true_model.pos,
                           quat=true_model.quat, size=true_model.size)
    jcfg = _config(JVisionConfig, jtrue, divb_field.geometry.field)
    want = JG.geometry_calibration(jcfg, divb_field.geometry.field, field_image,
                                   out_dir=tmp_path / "jax")
    assert want is not None and calibrated is not None
    got_v, want_v = _model_vector(calibrated), _model_vector(want)
    scale = np.maximum(np.abs(want_v), 1.0)
    assert np.max(np.abs(got_v - want_v) / scale) <= 1e-9, (got_v, want_v)
    port = G.geometry_calibration(_config(VisionConfig, true_model, divb_field.geometry.field),
                                  divb_field.geometry.field, field_image,
                                  out_dir=tmp_path / "port")
    np.testing.assert_allclose(_model_vector(port), want_v, rtol=1e-9, atol=1e-9)
    a = json.loads((tmp_path / "jax" / "0.calib.json").read_text())
    b = json.loads((tmp_path / "port" / "0.calib.json").read_text())
    assert a.keys() == b.keys()
    assert {k: a[k] for k in ("line_pixel_count", "raw_line_segments",
                              "merged_line_count", "half_line_width", "total_error")} \
        == {k: b[k] for k in ("line_pixel_count", "raw_line_segments",
                              "merged_line_count", "half_line_width", "total_error")}

