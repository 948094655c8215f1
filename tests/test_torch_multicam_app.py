"""The port's MultiCamApp end to end on the CPU: two synthetic cameras, a
geometry publisher and a detection recorder on an isolated multicast group
(the pattern of tests/test_multicam_app.py and tests/test_multicam_outage.py),
the offline fleet that chip_smoke.py drives, main() with N configs, and the
rule that a kernel failure leaves both apps' run().
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

from vision_processor_tpu.models.camera import CameraModel as JCameraModel
from vision_processor_tpu.net.geometry_io import geometry_from_dict as jgeometry_from_dict

GROUP, PORT = "224.99.99.101", 18601
N_CAMS = 2
FIELD = {"field": {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000,
    "goal_depth": 180, "penalty_area_depth": 1000,
    "penalty_area_width": 2000, "boundary_width": 300,
    "center_circle_radius": 500, "line_thickness": 10,
    "ball_radius": 21.5, "max_robot_radius": 90.0,
}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    """Two cameras over the two field halves (960x720 models), one robot
    each and a ball in front of camera 0, each frame rendered once."""
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot
    from vision_processor_tpu_torch.io.synthetic import render_raw
    from vision_processor_tpu_torch.models.camera import CameraModel

    field = jgeometry_from_dict(FIELD).geometry.field
    jmodels = [JCameraModel.initial_guess(np.array([960, 720]), c, N_CAMS, 4500.0, field)
               for c in range(N_CAMS)]
    models = [CameraModel(focal_length=m.focal_length, principal_point=m.principal_point,
                          distortion_k2=m.distortion_k2, pos=m.pos, quat=m.quat, size=m.size)
              for m in jmodels]
    x0, x1 = float(models[0].pos[0]), float(models[1].pos[0])
    scenes = [
        Scene(bots=[SceneBot(3, "blue", x0, -500.0, 1.2)],
              balls=[SceneBall(x0 + 400.0, 300.0)], noise_sigma=1.0),
        Scene(bots=[SceneBot(9, "yellow", x1, 600.0, -0.7)], balls=[], noise_sigma=1.0),
    ]
    raws = [render_raw(m, field, s, "RGGB") for m, s in zip(models, scenes)]
    return SimpleNamespace(field=field, jmodels=jmodels, models=models, scenes=scenes,
                           raws=raws)


def _register(name, fleet, frames, outage=()):
    """A synthetic camera driver serving the pre-rendered frames; camera 1
    returns None (a timed-out read) at the frame indices in ``outage``."""
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver

    class Cached(CameraDriver):
        def __init__(self, c):
            self.c, self.i = c, 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return self.i * 0.01

        def read_image(self):
            if self.i >= frames:
                return None
            i, self.i = self.i, self.i + 1
            if self.c == 1 and i in outage:
                return None
            return RawFrame(data=fleet.raws[self.c], fmt="RGGB", width=960, height=720)

    register_driver(name, lambda cam_cfg: Cached(int(cam_cfg.path)))


def _configs(tmp_path, driver, port, ports=None, wait=True, geometry=None, debug=None):
    """One config per camera; ``ports``: each camera's vision port (default
    all ``port``); ``geometry``: camera -> more keys of its geometry
    section; ``debug``: more keys of every debug section."""
    paths = []
    for c in range(N_CAMS):
        config = {
            "cam_id": c,
            "bot_heights_file": str(tmp_path / "none.yml"),
            "camera": {"driver": driver, "path": str(c)},
            "geometry": {"camera_amount": N_CAMS} | (geometry or {}).get(c, {}),
            "network": {"vision_ip": GROUP, "vision_port": ports[c] if ports else port,
                        "gc_ip": "224.99.99.102", "gc_port": port + 1},
            "stream": {"active": False},
            "debug": {"wait_for_geometry": wait} | (debug or {}),
            "thresholds": {"blobs": 128},
        }
        p = tmp_path / f"{driver}{c}.yml"
        p.write_text(yaml.dump(config))
        paths.append(str(p))
    return paths


class _Bus:
    """Publishes the geometry (field + both calibrations) on the group,
    absorbs the calibrations the fleet broadcasts (like geom_publisher.py)
    and records the detection frames and calibrations sent there."""

    def __init__(self, fleet, port, calibrated=range(N_CAMS)):
        from vision_processor_tpu.net.udp import UDPSocket
        from vision_processor_tpu.proto import SSL_WrapperPacket

        self.by_cam = {c: [] for c in range(N_CAMS)}
        self.calibs = []
        geometry = SSL_WrapperPacket()
        geometry.geometry.field.CopyFrom(fleet.field)
        for c in calibrated:
            geometry.geometry.calib.append(fleet.jmodels[c].to_proto(c))
        by_cam, calibs = self.by_cam, self.calibs

        class Socket(UDPSocket):
            def _parse(self, data):
                got = SSL_WrapperPacket()
                got.ParseFromString(data)
                if got.HasField("detection"):
                    by_cam[got.detection.camera_id].append(got.detection)
                if got.HasField("geometry"):
                    for calib in got.geometry.calib:
                        if calib.camera_id in {c.camera_id for c in geometry.geometry.calib}:
                            continue
                        calibs.append(calib)
                        geometry.geometry.calib.append(calib)

        self.socket = Socket(GROUP, port)
        self.stop = threading.Event()

        def publish():
            while not self.stop.is_set():
                self.socket.send(geometry)
                time.sleep(0.05)

        self.thread = threading.Thread(target=publish, daemon=True)
        self.thread.start()

    def close(self):
        self.stop.set()
        self.thread.join()
        self.socket.close()


def _run(tmp_path, fleet, driver, port, frames, outage=(), patch=None):
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    _register(driver, fleet, frames, outage)
    bus = _Bus(fleet, port)
    try:
        app = MultiCamApp(_configs(tmp_path, driver, port), device="cpu")
        if patch is not None:
            patch(app)
        try:
            app.run()  # closes the app at its end
        except BaseException:
            app.close()
            raise
        time.sleep(0.3)
    finally:
        bus.close()
    return app, bus.by_cam


def _check_detections(fleet, det, cam):
    truth = fleet.scenes[cam].bots[0]
    team = det.robots_blue if truth.team == "blue" else det.robots_yellow
    assert [r.robot_id for r in team] == [truth.bot_id]
    assert np.hypot(team[0].x - truth.x, team[0].y - truth.y) < 30.0
    if fleet.scenes[cam].balls:
        ball = fleet.scenes[cam].balls[0]
        assert min(np.hypot(b.x - ball.x, b.y - ball.y) for b in det.balls) < 40.0


@pytest.mark.parametrize("staggered", ["0", "1"])
def test_multicam_app_two_cameras(tmp_path, fleet, monkeypatch, staggered):
    """Both cameras' detections reach the wire, frame numbers advancing per
    camera, in the pipelined batched mode and the frame-serial staggered
    mode."""
    monkeypatch.setenv("VPTPU_PIPELINE", "1" if staggered == "0" else "0")
    monkeypatch.setenv("VPTPU_STAGGERED", staggered)
    app, by_cam = _run(tmp_path, fleet, f"SYNTH_MC{staggered}", PORT + 2 * int(staggered),
                       frames=4)
    assert app.staggered is (staggered == "1")
    assert app.mc_cfg.bm.resample_mode == "gather"  # "auto" on the CPU
    for cam in range(N_CAMS):
        assert [d.frame_number for d in by_cam[cam]] == [1, 2, 3, 4]
        _check_detections(fleet, by_cam[cam][-1], cam)


def test_one_camera_outage_keeps_fleet_alive(tmp_path, fleet):
    """Camera 1 delivers nothing for two frame-sets: camera 0 keeps
    emitting every frame-set, camera 1's reused frames stay off the wire,
    and it detects its robot again after recovering."""
    n_frames, outage = 6, (2, 3)
    _, by_cam = _run(tmp_path, fleet, "SYNTH_MC_OUT", PORT + 4, frames=n_frames,
                     outage=outage)
    assert len(by_cam[0]) == n_frames
    assert len(by_cam[1]) == n_frames - len(outage)
    _check_detections(fleet, by_cam[1][-1], 1)
    fn0 = [d.frame_number for d in by_cam[0]]
    assert fn0 == sorted(fn0) and len(set(fn0)) == n_frames


def test_fleet_waits_for_a_camera_without_geometry(tmp_path, fleet):
    """Camera 0 calibrated, camera 1 with no geometry yet (its socket on a
    port nobody publishes to), the default wait_for_geometry false: no
    camera needs the calibration path, so the fleet waits for camera 1's
    geometry, frame-set after frame-set, and sends nothing."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    port = PORT + 20
    _register("SYNTH_MC_WAIT", fleet, frames=3)
    bus = _Bus(fleet, port)
    try:
        app = MultiCamApp(_configs(tmp_path, "SYNTH_MC_WAIT", port, ports=[port, port + 2],
                                   wait=False), device="cpu")
        assert not app.configs[0].wait_for_geometry
        deadline = time.monotonic() + 10.0
        while app.sockets[0].geometry_version == 0 and time.monotonic() < deadline:
            app.sockets[0].geometry_check()
            time.sleep(0.01)
        app.run()  # closes the app at its end
        time.sleep(0.3)
    finally:
        bus.close()
    assert app.processors[0].perspective.geometry_version
    assert not app.processors[1].perspective.geometry_version
    assert not app.sockets[1].geometry_version
    assert not any(bus.by_cam.values())


def test_fleet_refuses_only_a_camera_to_calibrate(tmp_path, fleet):
    """Named for the guard it replaces: the fleet calibrates. Field geometry
    with camera 0's calibration only: camera 1 has geometry and no
    calibration, so the fleet calibrates camera 1 alone from its frame
    (line corners and height in its config), broadcasts it, adopts it when
    the bus brings it back, and then runs both cameras."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.models.camera import visible_field_extent_estimation

    port = PORT + 24
    model = fleet.models[1]
    lo, hi = visible_field_extent_estimation(1, N_CAMS, fleet.field, False)
    corners = [[float(v) for v in model.field2image(np.array([x, y, 0.0]))]
               for x, y in ((lo[0], lo[1]), (lo[0], hi[1]), (hi[0], hi[1]), (hi[0], lo[1]))]
    _register("SYNTH_MC_CAL", fleet, frames=6)
    bus = _Bus(fleet, port, calibrated=[0])
    try:
        app = MultiCamApp(_configs(tmp_path, "SYNTH_MC_CAL", port, geometry={
            1: {"camera_height": 4500.0, "line_corners": corners}}), device="cpu")
        cwd = os.getcwd()
        os.chdir(tmp_path)  # the calibration's diagnostics go to img/
        try:
            app.run()  # closes the app at its end
        finally:
            os.chdir(cwd)
        time.sleep(0.3)
    finally:
        bus.close()
    assert [c.camera_id for c in bus.calibs] == [1]  # camera 0 kept its own
    fitted = app.processors[1].perspective.model
    pts = np.array([[model.pos[0], model.pos[1], 0.0],
                    [model.pos[0] - 800.0, model.pos[1] + 500.0, 0.0]])
    assert np.max(np.linalg.norm(fitted.field2image(pts) - model.field2image(pts),
                                 axis=-1)) < 5.0
    assert all(p.perspective.geometry_version for p in app.processors)
    for cam in range(N_CAMS):
        assert bus.by_cam[cam], f"camera {cam} sent no detections"
        _check_detections(fleet, bus.by_cam[cam][-1], cam)


def test_kernel_failure_leaves_multicam_run(tmp_path, fleet):
    """A KernelError in the dispatch ends run() with that error; any other
    exception is logged and the fleet goes on."""
    from vision_processor_tpu_torch.ops.cuda import KernelError

    calls = []

    def failing(err):
        def patch(app):
            def dispatch(*args, **kwargs):
                calls.append(err)
                raise err("kernel launch refused")
            app.dispatch_frames = dispatch
        return patch

    with pytest.raises(KernelError, match="launch refused"):
        _run(tmp_path, fleet, "SYNTH_MC_KE", PORT + 6, frames=3, patch=failing(KernelError))
    assert calls == [KernelError]
    _run(tmp_path, fleet, "SYNTH_MC_RE", PORT + 6, frames=3, patch=failing(RuntimeError))
    assert calls[1:] == [RuntimeError] * 3


def test_kernel_failure_leaves_app_run(tmp_path, fleet, monkeypatch):
    """The single-camera App lets a KernelError from its detection path out
    of run() too."""
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.app.processor import Processor
    from vision_processor_tpu_torch.ops.cuda import KernelError

    def device_step(self, *args, **kwargs):
        raise KernelError("CUDA kernel band_pass failed: cudaError 9")

    monkeypatch.setattr(Processor, "device_step", device_step)
    _register("SYNTH_APP_KE", fleet, frames=3)
    bus = _Bus(fleet, PORT + 8)
    try:
        app = App(_configs(tmp_path, "SYNTH_APP_KE", PORT + 8)[0], device="cpu")
        with pytest.raises(KernelError, match="band_pass"):
            app.run()
        app.close()
    finally:
        bus.close()


def test_offline_fleet_dispatch_and_finish(fleet):
    """The fleet without sockets or cameras (what chip_smoke.py drives):
    plain geometry, the tracked prior fed back by the caller, 2 device->host
    reads per camera inside the dispatch (the compaction and anchor-window
    tier choices), wrappers returned unsent."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.net.geometry_io import (
        calibration_from_model, geometry_from_dict,
    )
    from vision_processor_tpu_torch.utils.config import VisionConfig

    geometry = geometry_from_dict(FIELD)
    geometry.calib = [calibration_from_model(m, c) for c, m in enumerate(fleet.models)]
    configs = []
    for c in range(N_CAMS):
        cfg = VisionConfig()
        cfg.cam_id, cfg.max_blobs, cfg.stream_active = c, 128, False
        configs.append(cfg)
    app = MultiCamApp.offline(configs, device="cpu")
    assert app.sockets == [] and app.cameras == []
    for proc in app.processors:
        proc.geometry_check(960, 720, geometry, 1)
    frames = [RawFrame(data=r, fmt="RGGB", width=960, height=720) for r in fleet.raws]

    class CountReads(TorchDispatchMode):
        reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                CountReads.reads += 1
            return func(*args, **(kwargs or {}))

    tracked = TrackedArrays.build({}, 0.0, 32)
    for frame in range(2):
        with CountReads():
            out = app.dispatch_frames(frames, frame * 0.01, tracked)
        assert CountReads.reads == 2 * N_CAMS
        CountReads.reads = 0
        wrappers = app.finish_frames(out, frame * 0.01, frames)
        ents = {}
        for cam, wrapper in enumerate(wrappers):
            _check_detections(fleet, wrapper.detection, cam)
            d = wrapper.detection
            ents[cam] = [SimpleNamespace(id=r.robot_id + off, x=r.x, y=r.y, z=r.height,
                                         w=r.orientation, vx=0.0, vy=0.0, vw=0.0,
                                         timestamp=frame * 0.01)
                         for team, off in ((d.robots_yellow, 0), (d.robots_blue, 16))
                         for r in team]
        tracked = TrackedArrays.build(ents, frame * 0.01 + 0.01, 32)
    assert sorted(tracked.id[tracked.valid].tolist()) == [9, 19]
    assert (out[1]["bot_tracked_id"][out[1]["bot_valid"]] >= 0).any()
    app.close()


def test_main_dispatches_on_the_config_count(monkeypatch):
    """One config runs App, more run MultiCamApp; --device applies to both
    and defaults to the card."""
    import inspect

    from vision_processor_tpu_torch.app import main as M
    from vision_processor_tpu_torch.app import multicam_app as MA

    assert inspect.signature(MA.MultiCamApp).parameters["device"].default == "cuda"
    assert inspect.signature(MA.MultiCamApp.offline).parameters["device"].default == "cuda"
    seen = []

    def fake(kind):
        class Fake:
            def __init__(self, config, device):
                seen.append((kind, config, device))

            def run(self):
                pass

            def stop(self, *_):
                pass
        return Fake

    monkeypatch.setattr(M, "App", fake("app"))
    monkeypatch.setattr(MA, "MultiCamApp", fake("multi"))
    monkeypatch.setattr(M.signal, "signal", lambda *a: None)
    M.main(["a.yml", "b.yml"])
    M.main(["a.yml", "b.yml", "c.yml", "--device", "cpu"])
    M.main(["a.yml"])
    M.main([])
    assert seen == [("multi", ["a.yml", "b.yml"], "cuda"),
                    ("multi", ["a.yml", "b.yml", "c.yml"], "cpu"),
                    ("app", "a.yml", "cuda"), ("app", "config.yml", "cuda")]


@pytest.mark.parametrize("overrides", [
    {"stream": {"active": True}},
    {"debug": {"debug_images": True}},
    {"debug": {"debug_stream_interval_ms": 100}},
])
def test_multicam_refuses_unported_paths(tmp_path, fleet, overrides):
    """Named for the guard it replaces: the fleet takes the debug stream
    (one streamer per camera, on an isolated group), the debug images and
    the snapshots."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    _register("SYNTH_MC_DEBUG", fleet, frames=1)
    paths = []
    for c in range(N_CAMS):
        config = {"cam_id": c, "camera": {"driver": "SYNTH_MC_DEBUG", "path": str(c)},
                  "network": {"vision_ip": GROUP, "vision_port": PORT + 30,
                              "gc_ip": "224.99.99.102", "gc_port": PORT + 31},
                  "stream": {"active": False, "ip_base_prefix": "224.99.99.",
                             "ip_base_end": 110, "port": PORT + 32}}
        for key, val in overrides.items():
            config[key] = config.get(key, {}) | val
        p = tmp_path / f"refuse{c}.yml"
        p.write_text(yaml.dump(config))
        paths.append(str(p))
    app = MultiCamApp(paths, device="cpu")
    try:
        active = overrides.get("stream", {}).get("active", False)
        assert [s.active for s in app.streamers] == [active] * N_CAMS
        assert [s.codec for s in app.streamers] == ["h264-native" if active else None] * N_CAMS
        assert app.snapshots is not None
    finally:
        app.close()


def test_debug_render_failure_leaves_multicam_run(tmp_path, fleet, monkeypatch):
    """The fleet's debug render runs one camera a frame-set, round-robin. A
    KernelError raised inside it ends run() with that error; any other
    exception is logged and the fleet goes on detecting."""
    from vision_processor_tpu_torch.app.processor import Processor
    from vision_processor_tpu_torch.ops.cuda import KernelError

    monkeypatch.chdir(tmp_path)
    calls = []

    def failing(err):
        def debug_views(self, raw, fmt, keys=()):
            calls.append((self.config.cam_id, err))
            raise err("render refused")
        return debug_views

    def run(err, driver):
        monkeypatch.setattr(Processor, "debug_views", failing(err))
        _register(driver, fleet, frames=3)
        bus = _Bus(fleet, PORT + 34)
        try:
            app = MultiCamApp(_configs(tmp_path, driver, PORT + 34,
                                       debug={"debug_stream_interval_ms": 1}), device="cpu")
            try:
                app.run()
            except BaseException:
                app.close()
                raise
            time.sleep(0.3)
        finally:
            bus.close()
        return bus.by_cam

    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    with pytest.raises(KernelError, match="render refused"):
        run(KernelError, "SYNTH_MC_DKE")
    assert calls == [(1, KernelError)]
    by_cam = run(RuntimeError, "SYNTH_MC_DRE")
    assert calls[1:] == [(1, RuntimeError), (0, RuntimeError), (1, RuntimeError)]
    for cam in range(N_CAMS):
        assert [d.frame_number for d in by_cam[cam]] == [1, 2, 3]
