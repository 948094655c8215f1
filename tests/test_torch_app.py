"""The PyTorch port's App loop end to end: synthetic camera + geometry
publisher + App + detection recorder over an isolated multicast group (the
pattern of tests/test_app_integration.py), and the NotImplementedError
guards of the paths the port does not carry yet.
"""
import threading
import time

import pytest
import torch
import yaml

GROUP, PORT = "224.99.99.43", 17585


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(model):
    from vision_processor_tpu_torch.models.camera import CameraModel

    return CameraModel(
        focal_length=model.focal_length, principal_point=model.principal_point,
        distortion_k2=model.distortion_k2, pos=model.pos, quat=model.quat,
        size=model.size,
    )


def _write_config(tmp_path, **overrides):
    config = {
        "cam_id": 0,
        "bot_heights_file": str(tmp_path / "heights.yml"),
        "camera": {"driver": "SYNTHETIC"},
        "network": {
            "vision_ip": GROUP, "vision_port": PORT,
            "gc_ip": "224.99.99.44", "gc_port": 17586,
        },
        "stream": {"active": False},
        "debug": {"wait_for_geometry": True},
        "thresholds": {"blobs": 128},
    }
    for key, val in overrides.items():
        config.setdefault(key, {}).update(val)
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text(yaml.dump(config))
    (tmp_path / "heights.yml").write_text(yaml.dump({"TeamA": 143.0, "TeamB": 147.0}))
    return cfg_path


@pytest.fixture
def publisher(divb_field, overhead_model):
    """Publishes the geometry (with this camera's calibration) on the group."""
    from vision_processor_tpu.net.udp import UDPSocket

    geometry = divb_field
    geometry.geometry.ClearField("calib")
    geometry.geometry.calib.append(overhead_model.to_proto(0))

    class Sender(UDPSocket):
        def _parse(self, data):
            pass

    sender = Sender(GROUP, PORT)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            sender.send(geometry)
            time.sleep(0.05)

    thread = threading.Thread(target=publish, daemon=True)
    thread.start()
    yield
    stop.set()
    thread.join()
    sender.close()


def _run_app(cfg_path, scene, divb_field, overhead_model, frames):
    from vision_processor_tpu.net.udp import UDPSocket
    from vision_processor_tpu.proto import SSL_WrapperPacket
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import SyntheticDriver, register_driver

    model = _port_model(overhead_model)
    register_driver(
        "SYNTHETIC",
        lambda cam_cfg: SyntheticDriver(model, divb_field.geometry.field, scene,
                                        fmt="RGGB", fps=100.0, frames=frames),
    )
    received = []

    class Recorder(UDPSocket):
        def _parse(self, data):
            wrapper = SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("detection"):
                received.append(wrapper.detection)

    recorder = Recorder(GROUP, PORT)
    try:
        app = App(str(cfg_path), device="cpu")
        app.run()
        time.sleep(0.3)
    finally:
        recorder.close()
    return app, received


@pytest.mark.parametrize("pipelined", ["0", "1"])
def test_app_full_loop(tmp_path, publisher, divb_field, overhead_model, monkeypatch,
                       pipelined):
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot

    monkeypatch.setenv("VPTPU_PIPELINE", pipelined)
    scene = Scene(
        bots=[SceneBot(5, "yellow", -2600.0, 400.0, 1.1)],
        balls=[SceneBall(-3200.0, -1100.0)],
        noise_sigma=1.0,
    )
    app, received = _run_app(_write_config(tmp_path), scene, divb_field,
                             overhead_model, frames=4)
    assert app.pipeline == (pipelined == "1")
    assert len(received) == 4, f"got {len(received)} detection frames"
    assert sorted(d.frame_number for d in received) == [1, 2, 3, 4]
    last = max(received, key=lambda d: d.frame_number)
    assert len(last.robots_yellow) == 1
    bot = last.robots_yellow[0]
    assert bot.robot_id == 5
    assert abs(bot.x - -2600.0) < 30
    assert abs(bot.y - 400.0) < 30
    assert bot.height == pytest.approx(145.0, abs=1.0)
    assert len(last.balls) == 1
    assert abs(last.balls[0].x - -3200.0) < 40
    assert last.t_capture == pytest.approx(4 / 100.0, abs=1e-6)


@pytest.mark.parametrize("overrides", [
    {"stream": {"active": True}},
    {"debug": {"debug_images": True}},
    {"debug": {"debug_stream_interval_ms": 100}},
])
def test_app_refuses_unported_outputs(tmp_path, overrides):
    from vision_processor_tpu_torch.app.main import App

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        App(str(_write_config(tmp_path, **overrides)), device="cpu")


def test_app_refuses_calibration_path(tmp_path, divb_field, overhead_model):
    """Geometry without this camera's calibration reaches the calibration
    path, which raises instead of being skipped."""
    from vision_processor_tpu.net.udp import UDPSocket
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import SyntheticDriver, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene

    geometry = divb_field
    geometry.geometry.ClearField("calib")
    model = _port_model(overhead_model)
    register_driver(
        "SYNTHETIC",
        lambda cam_cfg: SyntheticDriver(model, divb_field.geometry.field, Scene(),
                                        frames=2),
    )

    class Sender(UDPSocket):
        def _parse(self, data):
            pass

    sender = Sender(GROUP, PORT)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            sender.send(geometry)
            time.sleep(0.05)

    thread = threading.Thread(target=publish, daemon=True)
    thread.start()
    try:
        app = App(str(_write_config(tmp_path)), device="cpu")
        with pytest.raises(NotImplementedError, match="calibration"):
            app.run()
        app.close()
    finally:
        stop.set()
        thread.join()
        sender.close()


def test_open_camera_refuses_unported_drivers():
    from vision_processor_tpu.utils.config import CameraSection
    from vision_processor_tpu_torch.io.camera import open_camera

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        open_camera(CameraSection(driver="OPENCV"))
    with pytest.raises(ValueError):
        open_camera(CameraSection(driver="NOPE"))
