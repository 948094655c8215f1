"""The port's rig-height calibration from camera pairs (``calib/pair.py``,
``MultiCamApp``'s pair-height solve) on the CPU: the seven cases of
tests/test_pair_calib.py on the port's modules, then
``height_from_shared_objects`` and the camera-model conversions against the
JAX package's on seeded inputs.

A single near-nadir camera cannot separate focal length from mounting
height; the same robot (of known height) seen by two cameras of a pair
can.
"""
from __future__ import annotations

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from vision_processor_tpu.calib import pair as JP
from vision_processor_tpu.models import camera as JC
from vision_processor_tpu.net.geometry_io import geometry_from_dict as jgeometry_from_dict
from vision_processor_tpu_torch.calib.pair import (
    apply_height,
    height_from_shared_objects,
    observations_from_detections,
)
from vision_processor_tpu_torch.models import camera as C
from vision_processor_tpu_torch.models.camera import (
    CameraModel,
    visible_field_extent_estimation,
)
from vision_processor_tpu_torch.net.geometry_io import geometry_from_dict

TRUE_H = 4500.0
BOT_Z = 143.0
FIELD = {"field": {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000,
    "goal_depth": 180, "penalty_area_depth": 1000,
    "penalty_area_width": 2000, "boundary_width": 300,
    "center_circle_radius": 500, "line_thickness": 10,
    "ball_radius": 21.5, "max_robot_radius": 90.0,
}}
GROUP, PORT = "224.99.99.121", 18721


def _field():
    return geometry_from_dict(FIELD).field


def _true_models(field, n_cams=2):
    models = []
    for cam_id in range(n_cams):
        lo, hi = visible_field_extent_estimation(cam_id, n_cams, field, False)
        center = (lo + hi) / 2
        models.append(CameraModel(
            focal_length=900.0, principal_point=np.array([480.0, 270.0]),
            distortion_k2=0.0, pos=np.array([center[0], center[1], TRUE_H]),
            size=np.array([960, 540]),
        ))
    return models


def _wrong_guess(model, h_wrong):
    """The focal/height-compensated wrong model: the direction no plane
    observation can fix."""
    return CameraModel(
        focal_length=model.focal_length * h_wrong / model.pos[2],
        principal_point=model.principal_point.copy(),
        distortion_k2=model.distortion_k2,
        pos=np.array([model.pos[0], model.pos[1], h_wrong]),
        quat=model.quat.copy(), size=model.size.copy(),
    )


def _shared_dets(true_models, seed):
    """Four robots in the overlap strip seen by both true cameras (centre
    pixel at robot-top height), +-0.3 px detection noise."""
    rng = np.random.default_rng(seed)
    dets = {0: [], 1: []}
    for k, (bx, by) in enumerate([(0.0, -1800.0), (150.0, 0.0), (-120.0, 1500.0),
                                  (60.0, 800.0)]):
        p = np.array([bx, by, BOT_Z])
        for cam in (0, 1):
            px = true_models[cam].field2image(p[None, :])[0]
            dets[cam].append((k, px + rng.normal(0.0, 0.3, 2), BOT_Z))
    return dets


def test_single_camera_height_ambiguity_is_real():
    field = _field()
    model = _true_models(field)[0]
    wrong = _wrong_guess(model, 3600.0)  # 20 % height error
    lo, hi = visible_field_extent_estimation(0, 2, field, True)
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 24), np.linspace(lo[1], hi[1], 24))
    pts = np.stack([gx.reshape(-1), gy.reshape(-1), np.zeros(gx.size)], axis=-1)
    err = np.linalg.norm(model.field2image(pts) - wrong.field2image(pts), axis=-1)
    assert np.max(err) < 1.0, f"compensated model differs by {np.max(err):.2f} px"


def test_pair_calibration_recovers_height():
    field = _field()
    true_models = _true_models(field)
    wrong = [_wrong_guess(m, 3600.0) for m in true_models]
    obs = observations_from_detections(_shared_dets(true_models, 4), wrong)
    assert len(obs) == 4
    h = height_from_shared_objects(wrong, obs)
    assert h is not None and abs(h - TRUE_H) < 0.03 * TRUE_H, h
    apply_height(wrong, h)
    p = np.array([[0.0, -1800.0, BOT_Z]])
    for cam in (0, 1):
        px = true_models[cam].field2image(p)
        err = np.linalg.norm(true_models[cam].image2field(px, BOT_Z)[0][:2]
                             - wrong[cam].image2field(px, BOT_Z)[0][:2])
        assert err < 10.0, f"cam {cam}: residual parallax error {err:.1f} mm"


def test_pair_calibration_rejects_empty():
    wrong = [_wrong_guess(m, 3600.0) for m in _true_models(_field())]
    assert height_from_shared_objects(wrong, []) is None


def test_pair_calibration_trusted_camera_pins_height():
    """Camera 1 has a measured height and is not free: it stays fixed in the
    cost, and camera 0's height comes from the observations alone."""
    true_models = _true_models(_field())
    models = [_wrong_guess(true_models[0], 3600.0), true_models[1]]
    obs = observations_from_detections(_shared_dets(true_models, 11), models)
    assert len(obs) == 4
    h = height_from_shared_objects(models, obs, free={0})
    assert h is not None and abs(h - TRUE_H) < 0.03 * TRUE_H, h
    assert models[1].pos[2] == TRUE_H
    assert models[1].focal_length == true_models[1].focal_length


def test_free_height_camera_selection():
    """Only operator-measured nonzero heights anchor the rig solve."""
    from vision_processor_tpu_torch.app.multicam_app import free_height_cameras

    cfgs = [SimpleNamespace(camera_height=0.0, camera_height_set=True),
            SimpleNamespace(camera_height=3900.0, camera_height_set=True),
            SimpleNamespace(camera_height=0.0, camera_height_set=False)]
    assert free_height_cameras(cfgs) == {0, 2}


def test_pair_calibration_all_trusted_is_no_information():
    models = _true_models(_field())
    p = np.array([0.0, -1800.0, BOT_Z])
    obs = [(0, models[0].field2image(p[None, :])[0],
            1, models[1].field2image(p[None, :])[0], BOT_Z)]
    assert height_from_shared_objects(models, obs, free=set()) is None


@pytest.fixture
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_multicam_app_pair_height_refinement(tmp_path, _one_torch_thread):
    """The port's MultiCamApp under `camera_height: 0.0`: the published
    calibrations sit on the ambiguity manifold at a 20 % wrong height; the
    fleet gathers dual-view robot observations, solves the rig height and
    broadcasts corrected, plane-consistent calibrations near the true
    height."""
    from vision_processor_tpu.net.udp import UDPSocket
    from vision_processor_tpu.proto import SSL_WrapperPacket
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.io.camera import SyntheticDriver, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBot

    field = jgeometry_from_dict(FIELD).geometry.field
    n_cams = 2
    true_models = [CameraModel.initial_guess(np.array([960, 720]), c, n_cams, TRUE_H, field)
                   for c in range(n_cams)]
    wrong_models = [_wrong_guess(m, 0.8 * TRUE_H) for m in true_models]
    shared = SceneBot(7, "yellow", 0.0, 300.0, 0.5)
    scenes = [
        Scene(bots=[shared, SceneBot(3, "blue", float(true_models[0].pos[0]), -500.0, 1.2)],
              balls=[], noise_sigma=1.0),
        Scene(bots=[shared, SceneBot(9, "blue", float(true_models[1].pos[0]), 600.0, -0.7)],
              balls=[], noise_sigma=1.0),
    ]
    register_driver("SYNTH_PAIRH", lambda cam_cfg: SyntheticDriver(
        true_models[int(cam_cfg.path)], field, scenes[int(cam_cfg.path)], fmt="RGGB",
        fps=100.0, frames=14))
    cfg_paths = []
    for cam_id in range(n_cams):
        config = {
            "cam_id": cam_id, "bot_heights_file": str(tmp_path / "none.yml"),
            "camera": {"driver": "SYNTH_PAIRH", "path": str(cam_id)},
            "geometry": {"camera_amount": n_cams, "camera_height": 0.0},
            "network": {"vision_ip": GROUP, "vision_port": PORT,
                        "gc_ip": "224.99.99.122", "gc_port": PORT + 1},
            "stream": {"active": False}, "debug": {"wait_for_geometry": True},
            "thresholds": {"blobs": 128},
        }
        p = tmp_path / f"config{cam_id}.yml"
        p.write_text(yaml.dump(config))
        cfg_paths.append(str(p))

    wrapper = SSL_WrapperPacket()
    wrapper.geometry.field.CopyFrom(field)
    for cam_id, w in enumerate(wrong_models):
        wrapper.geometry.calib.append(w.to_proto(cam_id))
    refined = []

    class Publisher(UDPSocket):
        def _parse(self, data):
            got = SSL_WrapperPacket()
            got.ParseFromString(data)
            if got.HasField("geometry") and len(got.geometry.calib):
                for calib in got.geometry.calib:  # absorb, like geom_publisher.py
                    refined.append(calib)
                    for mine in wrapper.geometry.calib:
                        if mine.camera_id == calib.camera_id:
                            mine.CopyFrom(calib)
                            break

    publisher = Publisher(GROUP, PORT)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            publisher.send(wrapper)
            time.sleep(0.05)

    thread = threading.Thread(target=publish, daemon=True)
    thread.start()
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        app = MultiCamApp(cfg_paths, device="cpu")
        assert app._pair_height_active and app._height_obs_target == 32
        app._height_obs_target = 8
        app.run()
        time.sleep(0.3)
    finally:
        os.chdir(cwd)
        stop.set()
        thread.join()
        publisher.close()

    assert not app._pair_height_active  # solved once
    by_cam = {c.camera_id: c for c in refined}  # the last one a camera sent
    assert set(by_cam) == {0, 1}
    for cam_id, calib in by_cam.items():
        got = CameraModel.from_proto(calib)
        assert abs(got.pos[2] - TRUE_H) < 0.05 * TRUE_H, (cam_id, got.pos[2])
        w = wrong_models[cam_id]
        pts = np.array([[w.pos[0], w.pos[1], 0.0], [w.pos[0] - 700.0, w.pos[1] + 400.0, 0.0]])
        assert np.max(np.linalg.norm(got.field2image(pts) - w.field2image(pts), axis=-1)) < 2.0


# -- parity with the JAX package ---------------------------------------------


def _jmodel(m):
    return JC.CameraModel(focal_length=m.focal_length, principal_point=m.principal_point,
                          distortion_k2=m.distortion_k2, pos=m.pos, quat=m.quat,
                          size=m.size)


@pytest.mark.parametrize("free", [None, {0}, {1}])
def test_height_from_shared_objects_matches_jax(free):
    """The same observations, models and free set through both solvers:
    the same height, to the last bit (the same float64 code on scipy's
    bounded scalar minimiser), and the same observations built."""
    rng = np.random.default_rng(17 if free is None else 17 + min(free))
    true_models = _true_models(_field())
    h_wrong = float(rng.uniform(3000.0, 6000.0))
    models = [_wrong_guess(m, h_wrong) for m in true_models]
    dets = _shared_dets(true_models, int(rng.integers(1000)))
    obs = observations_from_detections(dets, models)
    jobs = JP.observations_from_detections(dets, [_jmodel(m) for m in models])
    assert len(obs) == len(jobs) == 4
    for a, b in zip(obs, jobs):
        assert a[0] == b[0] and a[2] == b[2] and a[4] == b[4]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[3], b[3])
    h = height_from_shared_objects(models, obs, free=free)
    jh = JP.height_from_shared_objects([_jmodel(m) for m in models], jobs, free=free)
    assert h is not None and h == jh
    apply_height(models, h)
    jmodels = [_jmodel(m) for m in [_wrong_guess(m, h_wrong) for m in true_models]]
    JP.apply_height(jmodels, jh)
    for m, jm in zip(models, jmodels):
        assert m.focal_length == jm.focal_length
        np.testing.assert_array_equal(m.pos, jm.pos)


def test_camera_conversions_match_jax():
    """matrix_to_quat, euler_to_matrix, matrix_to_euler, initial_guess,
    get_euler, update_euler and undistort against the JAX package's on
    seeded inputs: the same float64 code, equal to the last bit."""
    rng = np.random.default_rng(8)
    field = _field()
    jfield = jgeometry_from_dict(FIELD).geometry.field
    for _ in range(20):
        euler = rng.uniform(-np.pi, np.pi, 3)
        rot = C.euler_to_matrix(euler)
        np.testing.assert_array_equal(rot, JC.euler_to_matrix(euler))
        np.testing.assert_array_equal(C.matrix_to_quat(rot), JC.matrix_to_quat(rot))
        np.testing.assert_array_equal(C.matrix_to_euler(rot), JC.matrix_to_euler(rot))
    for cam_id, amount, height in ((0, 1, 0.0), (1, 2, 4500.0), (3, 4, 3900.0),
                                   (5, 8, 0.0)):
        size = np.array([960, 720])
        got = CameraModel.initial_guess(size, cam_id, amount, height, field)
        want = JC.CameraModel.initial_guess(size, cam_id, amount, height, jfield)
        for name in ("focal_length", "principal_point", "distortion_k2", "pos", "quat",
                     "size"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        euler = rng.uniform(-0.3, 0.3, 3) + np.array([np.pi, 0.0, 0.0])
        got.update_euler(euler)
        want.update_euler(euler)
        np.testing.assert_array_equal(got.quat, want.quat)
        np.testing.assert_array_equal(got.get_euler(), want.get_euler())
        got.distortion_k2 = want.distortion_k2 = 0.02
        px = rng.uniform(0, 960, (50, 2))
        np.testing.assert_array_equal(got.undistort(px), want.undistort(px))
