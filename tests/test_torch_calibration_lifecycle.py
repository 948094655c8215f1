"""The calibration lifecycle of the port's apps on the CPU, over isolated
multicast groups (the pattern of tests/test_calibration_lifecycle.py and
tests/test_multicam_selfcalib.py): geometry without calibrations arrives,
the app calibrates from the frame's field lines and broadcasts the model,
the publisher absorbs it and the bus brings it back, and the detection
path runs on the remaining frames.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch
import yaml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corner_pixels(model, field, cam_id, cam_amount):
    from vision_processor_tpu_torch.models.camera import visible_field_extent_estimation

    lo, hi = visible_field_extent_estimation(cam_id, cam_amount, field, False)
    corners = [[lo[0], lo[1]], [lo[0], hi[1]], [hi[0], hi[1]], [hi[0], lo[1]]]
    return [[float(v) for v in model.field2image(np.array([c[0], c[1], 0.0]))]
            for c in corners]


class _Bus:
    """A geometry publisher that starts without calibrations and absorbs
    the apps' calibration broadcasts (like geom_publisher.py), and a
    recorder of the detections and calibrations sent on the group."""

    def __init__(self, field, group, port):
        from vision_processor_tpu.net.udp import UDPSocket
        from vision_processor_tpu.proto import SSL_WrapperPacket

        bare = SSL_WrapperPacket()
        bare.geometry.field.CopyFrom(field)
        self.detections, self.calibs = [], []

        class Sender(UDPSocket):
            def _parse(self, data):
                wrapper = SSL_WrapperPacket()
                wrapper.ParseFromString(data)
                if wrapper.HasField("geometry"):
                    for calib in wrapper.geometry.calib:
                        for mine in bare.geometry.calib:
                            if mine.camera_id == calib.camera_id:
                                mine.CopyFrom(calib)
                                break
                        else:
                            bare.geometry.calib.append(calib)

        detections, calibs = self.detections, self.calibs

        class Recorder(UDPSocket):
            def _parse(self, data):
                wrapper = SSL_WrapperPacket()
                wrapper.ParseFromString(data)
                if wrapper.HasField("detection"):
                    detections.append(wrapper.detection)
                if wrapper.HasField("geometry") and len(wrapper.geometry.calib):
                    calibs.extend(wrapper.geometry.calib)

        self.sender, self.recorder = Sender(group, port), Recorder(group, port)
        self.stop = threading.Event()

        def publish():
            while not self.stop.is_set():
                self.sender.send(bare)
                time.sleep(0.05)

        self.thread = threading.Thread(target=publish, daemon=True)
        self.thread.start()

    def close(self):
        self.stop.set()
        self.thread.join()
        self.sender.close()
        self.recorder.close()


def _config(tmp_path, cam_id, driver, group, port, geometry, path=None):
    config = {
        "cam_id": cam_id,
        "bot_heights_file": str(tmp_path / "none.yml"),
        "camera": {"driver": driver} | ({"path": path} if path is not None else {}),
        "geometry": geometry,
        "network": {"vision_ip": group, "vision_port": port,
                    "gc_ip": group, "gc_port": port + 1},
        "stream": {"active": False},
        "debug": {"wait_for_geometry": True},
        "thresholds": {"blobs": 128},
    }
    p = tmp_path / f"config{cam_id}.yml"
    p.write_text(yaml.dump(config))
    return str(p)


def test_calibrate_then_detect(tmp_path, divb_field, overhead_model):
    """The single-camera App: frame 1 calibrates and broadcasts, the model
    comes back over the bus and is adopted, and the later frames detect the
    robot."""
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import SyntheticDriver, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBot
    from vision_processor_tpu_torch.models.camera import CameraModel

    group, port = "224.99.99.124", 18731
    field = divb_field.geometry.field
    model = CameraModel(focal_length=overhead_model.focal_length,
                        principal_point=overhead_model.principal_point,
                        distortion_k2=overhead_model.distortion_k2, pos=overhead_model.pos,
                        quat=overhead_model.quat, size=overhead_model.size)
    scene = Scene(bots=[SceneBot(6, "yellow", -2700.0, 300.0, 0.9)], balls=[],
                  noise_sigma=1.0)
    register_driver("SYNTH_LIFECYCLE", lambda cam_cfg: SyntheticDriver(
        model, field, scene, fmt="RGGB", fps=100.0, frames=5))
    cfg = _config(tmp_path, 0, "SYNTH_LIFECYCLE", group, port, {
        "camera_amount": 4, "camera_height": float(model.pos[2]),
        "line_corners": _corner_pixels(model, field, 0, 4)})
    bus = _Bus(field, group, port)
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)  # calibration diagnostics land in img/
        app = App(cfg, device="cpu")
        app.run()
        time.sleep(0.3)
    finally:
        os.chdir(cwd)
        bus.close()
    assert bus.calibs, "no calibration broadcast"
    assert bus.calibs[0].camera_id == 0
    fitted = CameraModel.from_proto(bus.calibs[0])
    pts = np.array([[-3000.0, 0.0, 0.0], [-2000.0, 1000.0, 0.0]])
    err = np.linalg.norm(fitted.field2image(pts) - model.field2image(pts), axis=-1)
    assert np.max(err) < 5.0, err
    assert app.processor.perspective.geometry_version  # adopted
    assert bus.detections, "no detections after calibration"
    last = bus.detections[-1]
    assert [r.robot_id for r in last.robots_yellow] == [6]
    assert abs(last.robots_yellow[0].x - -2700.0) < 30
    assert abs(last.robots_yellow[0].y - 300.0) < 30


def test_multicam_app_self_calibrates(tmp_path, divb_field):
    """MultiCamApp: geometry without calibrations; the fleet calibrates
    both cameras, the broadcasts come back, and the batched step then
    detects each camera's robot."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.io.camera import SyntheticDriver, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBot
    from vision_processor_tpu_torch.models.camera import (
        CameraModel,
        visible_field_extent_estimation,
    )

    group, port = "224.99.99.126", 18741
    field = divb_field.geometry.field
    n_cams = 2
    models = []
    for cam_id in range(n_cams):
        lo, hi = visible_field_extent_estimation(cam_id, n_cams, field, False)
        center = (lo + hi) / 2
        models.append(CameraModel(focal_length=900.0,
                                  principal_point=np.array([480.0, 270.0]),
                                  distortion_k2=0.0,
                                  pos=np.array([center[0], center[1], 4500.0]),
                                  size=np.array([960, 540])))
    scenes = [
        Scene(bots=[SceneBot(4, "yellow", float(models[0].pos[0]), float(models[0].pos[1]),
                             0.4)], balls=[], noise_sigma=1.0),
        Scene(bots=[SceneBot(11, "blue", float(models[1].pos[0]), float(models[1].pos[1]),
                             -0.8)], balls=[], noise_sigma=1.0),
    ]
    register_driver("SYNTH_MC_SELFCAL", lambda cam_cfg: SyntheticDriver(
        models[int(cam_cfg.path)], field, scenes[int(cam_cfg.path)], fmt="RGGB",
        fps=100.0, frames=6))
    cfgs = [_config(tmp_path, c, "SYNTH_MC_SELFCAL", group, port, {
        "camera_amount": n_cams, "camera_height": 4500.0,
        "line_corners": _corner_pixels(models[c], field, c, n_cams)}, path=str(c))
        for c in range(n_cams)]
    bus = _Bus(field, group, port)
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        app = MultiCamApp(cfgs, device="cpu")
        assert not app._pair_height_active  # measured heights: no pair solve
        app.run()
        time.sleep(0.3)
    finally:
        os.chdir(cwd)
        bus.close()
    assert {c.camera_id for c in bus.calibs} == {0, 1}
    for c in bus.calibs:
        fitted = CameraModel.from_proto(c)
        true = models[c.camera_id]
        pts = np.array([[true.pos[0], true.pos[1], 0.0],
                        [true.pos[0] - 800.0, true.pos[1] + 500.0, 0.0]])
        err = np.linalg.norm(fitted.field2image(pts) - true.field2image(pts), axis=-1)
        assert np.max(err) < 5.0, err
    by_cam = {}
    for det in bus.detections:
        by_cam.setdefault(det.camera_id, []).append(det)
    assert set(by_cam) == {0, 1}, f"detection cams: {set(by_cam)}"
    assert [r.robot_id for r in by_cam[0][-1].robots_yellow] == [4]
    assert [r.robot_id for r in by_cam[1][-1].robots_blue] == [11]


def test_detection_path_imports_no_calibration():
    """The apps import the calibration code (and with it scipy) only where
    a camera is calibrated: importing both apps and running a calibrated
    camera's detection path loads neither ``calib`` nor scipy (in a fresh
    interpreter)."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import sys
import numpy as np
from vision_processor_tpu_torch.app.main import App
from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
from vision_processor_tpu_torch.app.processor import Processor, TrackedArrays
from vision_processor_tpu_torch.io.synthetic import Scene, SceneBot, render_raw
from vision_processor_tpu_torch.models.camera import CameraModel
from vision_processor_tpu_torch.net.geometry_io import calibration_from_model, geometry_from_dict
from vision_processor_tpu_torch.utils.config import VisionConfig

geometry = geometry_from_dict({"field": {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000, "goal_depth": 180,
    "penalty_area_depth": 1000, "penalty_area_width": 2000, "boundary_width": 300,
    "center_circle_radius": 500, "line_thickness": 10, "ball_radius": 21.5,
    "max_robot_radius": 90.0}})
model = CameraModel(focal_length=900.0, principal_point=np.array([480.0, 360.0]),
                    distortion_k2=0.02, pos=np.array([-2250.0, 0.0, 4500.0]),
                    size=np.array([960, 720]))
geometry.calib = [calibration_from_model(model, 0)]
cfg = VisionConfig()
cfg.max_blobs = 128
proc = Processor(cfg, device="cpu")
proc.geometry_check(960, 720, geometry, 1)
raw = render_raw(model, geometry.field,
                 Scene(bots=[SceneBot(5, "yellow", -2600.0, 400.0, 1.1)], noise_sigma=1.0))
out = proc.device_step(raw, "RGGB", TrackedArrays.build({}, 0.0, 32))
wrapper, _, _ = proc.finish_frame(out, 0.0)
assert [r.robot_id for r in wrapper.detection.robots_yellow] == [5], wrapper
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "scipy"
                or m.startswith("vision_processor_tpu_torch.calib"))
print(loaded[:5])
sys.exit(1 if loaded else 0)
"""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
