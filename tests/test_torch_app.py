"""The PyTorch port's App loop end to end: synthetic camera + geometry
publisher + App + detection recorder over an isolated multicast group (the
pattern of tests/test_app_integration.py), the idle path before geometry
under the default config, the calibration path of a camera with geometry
and no calibration, the debug stream (RTP packets that depacketize into
H.264 access units) and the debug images, the shipped configs, and the
dispatch of every camera driver name.
"""
import threading
import time
from pathlib import Path

import pytest
import torch
import yaml

GROUP, PORT = "224.99.99.43", 17585
STREAM_GROUP_END, STREAM_PORT = 45, 17587  # the debug stream's group: 224.99.99.45
ROOT = Path(__file__).resolve().parents[1]


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
        "stream": {"active": False, "ip_base_prefix": "224.99.99.",
                   "ip_base_end": STREAM_GROUP_END, "port": STREAM_PORT},
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
    """Named for the guard it replaces: the debug stream, the debug images
    and the interval snapshots are ported, and the App takes each of them
    (the stream with the native H.264 encoder, built from native/)."""
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import CameraDriver, register_driver

    register_driver("SYNTHETIC", lambda cam_cfg: CameraDriver())
    debug = {"wait_for_geometry": False, **overrides.get("debug", {})}
    app = App(str(_write_config(tmp_path, **{**overrides, "debug": debug})), device="cpu")
    try:
        assert app.streamer.active == overrides.get("stream", {}).get("active", False)
        assert app.streamer.codec == ("h264-native" if app.streamer.active else None)
        assert app.config.debug_images == bool(overrides.get("debug", {}).get("debug_images"))
    finally:
        app.close()


IDLE_FRAMES = 100  # the idle path saves frame 100


def test_app_idle_until_geometry(tmp_path, divb_field, overhead_model, monkeypatch):
    """The default config (wait_for_geometry false): the App runs the idle
    path on the 100 frames served before the geometry publisher starts,
    saves frame 100 as img/0.raw.jpg and sends nothing; once geometry with
    this camera's calibration arrives, its detections meet
    test_app_full_loop's bounds."""
    import cv2

    from vision_processor_tpu.net.udp import UDPSocket
    from vision_processor_tpu.proto import SSL_WrapperPacket
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import CameraDriver, RawFrame, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot, render_raw

    monkeypatch.chdir(tmp_path)
    scene = Scene(
        bots=[SceneBot(5, "yellow", -2600.0, 400.0, 1.1)],
        balls=[SceneBall(-3200.0, -1100.0)],
        noise_sigma=1.0,
    )
    model = _port_model(overhead_model)
    raw = render_raw(model, divb_field.geometry.field, scene, "RGGB")
    n_after = 3
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
    holder = {}

    class Camera(CameraDriver):
        """The rendered frame IDLE_FRAMES times, then the publisher starts
        and, once this App's socket holds the geometry, n_after more."""

        def __init__(self):
            self.i = 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def get_time(self):
            return self.i * 0.01

        def read_image(self):
            if self.i >= IDLE_FRAMES + n_after:
                return None
            if self.i == IDLE_FRAMES:
                thread.start()
                sock, deadline = holder["app"].socket, time.monotonic() + 10.0
                while sock.geometry_version == 0 and time.monotonic() < deadline:
                    sock.geometry_check()
                    time.sleep(0.01)
            self.i += 1
            return RawFrame(data=raw, fmt="RGGB", width=960, height=720)

    register_driver("SYNTHETIC_IDLE", lambda cam_cfg: Camera())
    received = []

    class Recorder(UDPSocket):
        def _parse(self, data):
            wrapper = SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("detection"):
                received.append(wrapper.detection)

    recorder = Recorder(GROUP, PORT)
    cfg_path = _write_config(tmp_path, camera={"driver": "SYNTHETIC_IDLE"},
                             debug={"wait_for_geometry": False})
    try:
        app = holder["app"] = App(str(cfg_path), device="cpu")
        assert not app.config.wait_for_geometry
        app.run()  # closes the App, and with it the snapshot writer
        time.sleep(0.3)
    finally:
        stop.set()
        if thread.is_alive():
            thread.join()
        recorder.close()
        sender.close()
    sample = cv2.imread(str(tmp_path / "img" / "0.raw.jpg"))
    assert sample is not None and sample.shape == (raw.shape[0] // 2, raw.shape[1] // 2, 3)
    assert sorted(d.frame_number for d in received) == list(range(1, n_after + 1))
    assert all(d.t_capture > IDLE_FRAMES * 0.01 for d in received)  # none before geometry
    last = max(received, key=lambda d: d.frame_number)
    assert [b.robot_id for b in last.robots_yellow] == [5]
    bot = last.robots_yellow[0]
    assert abs(bot.x - -2600.0) < 30
    assert abs(bot.y - 400.0) < 30
    assert len(last.balls) == 1
    assert abs(last.balls[0].x - -3200.0) < 40


def _corner_pixels(model, field, cam_id=0, cam_amount=4):
    """The config's line_corners: the visible extent's corners projected
    by the camera's true model, the min-x/min-y corner first."""
    import numpy as np

    from vision_processor_tpu_torch.models.camera import visible_field_extent_estimation

    lo, hi = visible_field_extent_estimation(cam_id, cam_amount, field, False)
    corners = [[lo[0], lo[1]], [lo[0], hi[1]], [hi[0], hi[1]], [hi[0], lo[1]]]
    return [[float(v) for v in model.field2image(np.array([c[0], c[1], 0.0]))]
            for c in corners]


def test_app_refuses_calibration_path(tmp_path, divb_field, overhead_model, monkeypatch):
    """Named for the guard it replaces: the calibration path is ported. A
    camera with field geometry and no calibration is calibrated from its
    frame's field lines (line corners and height in the config) and the
    model is broadcast on the App's socket, close to the true camera; no
    NotImplementedError."""
    import numpy as np

    from vision_processor_tpu.net.udp import UDPSocket
    from vision_processor_tpu.proto import SSL_WrapperPacket
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.io.camera import SyntheticDriver, register_driver
    from vision_processor_tpu_torch.io.synthetic import Scene
    from vision_processor_tpu_torch.models.camera import CameraModel

    monkeypatch.chdir(tmp_path)  # the calibration's diagnostics go to img/
    geometry = divb_field
    geometry.geometry.ClearField("calib")
    model = _port_model(overhead_model)
    field = divb_field.geometry.field
    register_driver(
        "SYNTHETIC",
        lambda cam_cfg: SyntheticDriver(model, field, Scene(noise_sigma=1.0), frames=2),
    )
    calibs = []

    class Sender(UDPSocket):
        def _parse(self, data):
            wrapper = SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("geometry"):
                calibs.extend(wrapper.geometry.calib)

    sender = Sender(GROUP, PORT)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            sender.send(geometry)
            time.sleep(0.05)

    thread = threading.Thread(target=publish, daemon=True)
    thread.start()
    cfg_path = _write_config(tmp_path, geometry={
        "camera_amount": 4, "camera_height": float(overhead_model.pos[2]),
        "line_corners": _corner_pixels(model, field)})
    try:
        App(str(cfg_path), device="cpu").run()  # closes the App at its end
        time.sleep(0.3)
    finally:
        stop.set()
        thread.join()
        sender.close()
    assert calibs, "no calibration broadcast"
    assert {c.camera_id for c in calibs} == {0}
    fitted = CameraModel.from_proto(calibs[0])
    pts = np.array([[-3000.0, 0.0, 0.0], [-2000.0, 1000.0, 0.0]])
    err = np.linalg.norm(fitted.field2image(pts) - model.field2image(pts), axis=-1)
    assert np.max(err) < 5.0, err
    assert (tmp_path / "img" / "0.calib.json").exists()


def test_geometry_builds_the_blob_kernel_ahead(divb_field, overhead_model, monkeypatch):
    """On the card, adopting a calibration builds the blob kernel at the
    geometry's radii (B2's (o, r, dr) score-first, B5's (o, r)
    circularity-first), so that the first detection frame runs no nvcc;
    on the CPU nothing is built. Shown here with the build recorded, not
    run."""
    from vision_processor_tpu_torch.app import processor as P
    from vision_processor_tpu_torch.ops.pipeline import BlobMachineConfig
    from vision_processor_tpu_torch.utils.config import VisionConfig

    built = []
    monkeypatch.setattr(P, "build_kernels", built.extend)
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(overhead_model.to_proto(0))
    cpu = P.Processor(VisionConfig(), device="cpu")
    cpu.geometry_check(960, 720, geometry, 1)
    assert cpu.perspective.geometry_version == 1 and built == []
    for score_first, version in (("1", 1), ("0", 2)):
        monkeypatch.setenv("VPTPU_SCOREFIRST", score_first)
        card = P.Processor(VisionConfig(), device="cuda")
        card.geometry_check(960, 720, geometry, version)
        cfg = BlobMachineConfig.from_perspective(card.perspective, "RGGB", (1440, 1920))
        want = (cfg.grad_offset, cfg.sat_radius,
                cfg.disc_radius if score_first == "1" else None)
        assert built[-1] == want
        card.geometry_check(960, 720, geometry, version)  # unchanged: no build
    assert len(built) == 2


def test_open_camera_refuses_unported_drivers(tmp_path):
    """Each of the five hardware driver names dispatches to its driver,
    which raises as the JAX package's does where its device, SDK or library
    is missing: V4L2 on a path that is no device (RuntimeError, from the
    port's V4L2Driver), SPINNAKER and MVIMPACT without their SDKs, GENICAM
    and ARAVIS without libaravis (RuntimeError naming what is missing, the
    JAX message). OPENCV (the default) is the file replay: a missing image
    raises FileNotFoundError."""
    from vision_processor_tpu.io.camera import open_camera as jax_open_camera
    from vision_processor_tpu.utils.config import CameraSection
    from vision_processor_tpu_torch.io.camera import OpenCVDriver, open_camera
    from vision_processor_tpu_torch.utils.config import CameraSection as PortSection

    for name in ("V4L2", "SPINNAKER", "MVIMPACT", "GENICAM", "ARAVIS"):
        path = str(tmp_path / "no-video") if name == "V4L2" else None
        with pytest.raises(RuntimeError) as want:
            jax_open_camera(CameraSection(driver=name, path=path))
        with pytest.raises(RuntimeError) as got:
            open_camera(PortSection(driver=name, path=path))
        assert str(got.value) == str(want.value)
        assert got.traceback[-1].path.parent.name == "io"
        assert "vision_processor_tpu_torch" in str(got.traceback[-1].path)
    with pytest.raises(FileNotFoundError):
        open_camera(CameraSection(driver="OPENCV", path=str(tmp_path / "none.png")))
    import cv2
    import numpy as np

    cv2.imwrite(str(tmp_path / "one.png"), np.zeros((4, 6, 3), np.uint8))
    assert isinstance(open_camera(CameraSection(path=str(tmp_path / "one.png"))),
                      OpenCVDriver)
    with pytest.raises(ValueError):
        open_camera(CameraSection(driver="NOPE"))


class _Packets:
    """Every datagram sent to ``group:port``, as bytes."""

    def __init__(self, group, port):
        from vision_processor_tpu_torch.net.udp import UDPSocket

        self.got = []
        got = self.got

        class Sock(UDPSocket):
            def _parse(self, data):
                got.append(data)

        self.sock = Sock(group, port)

    def close(self):
        self.sock.close()


def _access_units(packets) -> list:
    """RTP/H.264 packets -> annex-B access units, one per RTP timestamp in
    arrival order (io/rtp.py depacketize_h264)."""
    import struct

    from vision_processor_tpu_torch.io.rtp import RTP_H264_PT, depacketize_h264

    by_ts = {}
    for pkt in packets:
        assert pkt[1] & 0x7F == RTP_H264_PT
        by_ts.setdefault(struct.unpack("!I", pkt[4:8])[0], []).append(pkt)
    return [depacketize_h264(group) for group in by_ts.values()]


def _nal_types(access_unit: bytes) -> list:
    from vision_processor_tpu_torch.io.rtp import split_annexb

    return [nal[0] & 0x1F for nal in split_annexb(access_unit)]


def _detections(received):
    out = {}
    for d in received:
        bots = sorted((team, r.robot_id, r.x, r.y, r.orientation)
                      for team, robots in (("y", d.robots_yellow), ("b", d.robots_blue))
                      for r in robots)
        out[d.frame_number] = (bots, sorted((b.x, b.y) for b in d.balls))
    return out


def test_app_streams_rtp_with_equal_detections(tmp_path, publisher, divb_field,
                                               overhead_model, monkeypatch):
    """With stream.active on an isolated group, debug images and 1 ms
    snapshots, the App's detection frames stream H.264 over RTP: the packets
    depacketize into access units, the first an IDR picture behind its SPS
    and PPS; the detections equal those of the same frames with the stream
    off; the debug images and the four snapshots are written to the
    working directory at the views' shapes."""
    import cv2

    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot

    monkeypatch.chdir(tmp_path)
    scene = Scene(bots=[SceneBot(5, "yellow", -2600.0, 400.0, 1.1)],
                  balls=[SceneBall(-3200.0, -1100.0)], noise_sigma=1.0)
    _, plain = _run_app(_write_config(tmp_path), scene, divb_field, overhead_model,
                        frames=4)
    rtp = _Packets(f"224.99.99.{STREAM_GROUP_END}", STREAM_PORT)
    try:
        app, streamed = _run_app(
            _write_config(tmp_path, stream={"active": True},
                          debug={"debug_images": True, "debug_stream_interval_ms": 1}),
            scene, divb_field, overhead_model, frames=4)
        time.sleep(0.3)
    finally:
        rtp.close()
    assert app.streamer.codec == "h264-native"
    assert len(plain) == 4
    assert _detections(streamed) == _detections(plain)
    units = _access_units(rtp.got)
    assert units, "no RTP packets on the stream group"
    assert _nal_types(units[0])[:3] == [7, 8, 5]  # SPS, PPS, IDR slice
    hf, wf = app.processor._bm_cfg.flat_shape
    for name in (".flat.1.png", ".gradDot.1.png", ".blob.1.png"):
        img = cv2.imread(str(tmp_path / name))
        assert img is not None and img.shape == (hf, wf, 3), name
    for name, shape in (("raw", (720, 960, 3)), ("flat", (hf, wf, 3)),
                        ("gradient", (hf, wf, 3)), ("blob", (hf, wf, 3))):
        img = cv2.imread(str(tmp_path / "img" / f"0.{name}.jpg"))
        assert img is not None and img.shape == shape, name


def _shipped_config(tmp_path, name: str, image: Path, port: int) -> Path:
    """The repository's ``name`` as shipped, with the camera path and the
    vision, GC and stream addresses moved to an isolated group."""
    config = yaml.safe_load((ROOT / name).read_text())
    config["camera"] = {**(config.get("camera") or {}), "path": str(image)}
    config["network"] = {"vision_ip": "224.99.99.47", "vision_port": port,
                         "gc_ip": "224.99.99.47", "gc_port": port + 1}
    config["stream"] = {**(config.get("stream") or {}), "ip_base_prefix": "224.99.99.",
                        "ip_base_end": 48, "port": port + 2}
    path = tmp_path / f"moved-{name}"
    path.write_text(yaml.dump(config))
    return path


@pytest.mark.parametrize("name", ["config.yml", "config-minimal.yml"])
def test_apps_start_under_the_shipped_configs(tmp_path, monkeypatch, name):
    """App and MultiCamApp under config.yml and config-minimal.yml as
    shipped (the stream on by default, the OPENCV driver), the camera path
    pointed at a one-frame image and the addresses moved: both construct,
    pick the native H.264 encoder, replay the frame through the idle path
    (no geometry) and close."""
    import cv2
    import numpy as np

    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.io.camera import OpenCVDriver

    monkeypatch.chdir(tmp_path)
    image = tmp_path / "frame.png"
    rng = np.random.default_rng(0)
    cv2.imwrite(str(image), rng.integers(0, 256, (36, 64, 3), dtype=np.uint8))
    path = _shipped_config(tmp_path, name, image, 17591)
    app = App(str(path), device="cpu")
    assert app.config.stream_active and not app.config.wait_for_geometry
    assert app.streamer.codec == "h264-native"
    assert isinstance(app.camera, OpenCVDriver)
    app.run()  # one idle frame, then the end of the replay; closes the App
    fleet = MultiCamApp([str(path), str(path)], device="cpu")
    assert [s.codec for s in fleet.streamers] == ["h264-native"] * 2
    fleet.run()
