"""The codec round trip through the port's App: the counterpart of
tests/test_codec_roundtrip.py.

The JAX test's scene is rendered by the port (io/synthetic.py), encoded to
an on-disk H.264 stream by the port's native encoder (io/native.py
``H264Encoder``, CAVLC at qp 24), decoded by cv2, re-mosaicked to RGGB
and fed to the port's ``App(..., device="cpu")`` through a registered
camera driver, geometry from a publisher on an isolated multicast group,
detections recorded off the wire. They must meet the JAX test's bars and
equal the JAX ``App``'s on the same decoded frames: ids equal, positions
within 0.5 mm, orientations within 1e-3 rad (tests/test_torch_drivers.py's
contract for an App on the CPU against the JAX App). Skips only where the
JAX test skips: without the native library.
"""
from __future__ import annotations

import importlib
import threading
import time

import numpy as np
import pytest
import torch
import yaml

cv2 = pytest.importorskip("cv2")

PKGS = ("vision_processor_tpu", "vision_processor_tpu_torch")
GROUP, PORT = "224.99.99.176", 19180
GC_GROUP, GC_PORT = "224.99.99.177", 19181
QP = 24
N_SLICES = 4  # fixed, so that the stream does not depend on the machine's cores
FRAMES = 4


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def roundtrip_rgb(rgb_frames, path, enc):
    """Encode RGB frames to an annex-B file with ``enc``, decode it with
    cv2 (its ffmpeg), return the decoded RGB frames."""
    h, w = rgb_frames[0].shape[:2]
    with open(path, "wb") as fh:
        for rgb in rgb_frames:
            fh.write(enc.encode_rgb(rgb))
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[:h, :w, ::-1].copy())  # BGR -> RGB, unpad
    cap.release()
    assert len(out) == len(rgb_frames), f"decoded {len(out)}/{len(rgb_frames)} frames"
    return out


@pytest.fixture(scope="module")
def decoded(tmp_path_factory, divb_field, overhead_model):
    """The JAX test's scene rendered by the port, through the port's
    encoder (its stream byte-equal to the JAX encoder's) and cv2."""
    from vision_processor_tpu.io.native import H264Encoder as JEncoder
    from vision_processor_tpu_torch.io.native import H264Encoder
    from vision_processor_tpu_torch.io.synthetic import (
        Scene, SceneBall, SceneBot, render_rgb,
    )
    from vision_processor_tpu_torch.models.camera import CameraModel

    try:
        enc = H264Encoder(qp=QP, n_slices=N_SLICES)
        jenc = JEncoder(qp=QP, n_slices=N_SLICES)
    except RuntimeError:
        pytest.skip("native library unavailable")
    model = CameraModel(focal_length=overhead_model.focal_length,
                        principal_point=overhead_model.principal_point.copy(),
                        distortion_k2=overhead_model.distortion_k2,
                        pos=overhead_model.pos.copy(), quat=overhead_model.quat.copy(),
                        size=overhead_model.size.copy())
    scene = Scene(bots=[SceneBot(5, "yellow", -2600.0, 400.0, 1.1),
                        SceneBot(2, "blue", -1800.0, -300.0, -0.4)],
                  balls=[SceneBall(-3200.0, -1100.0)], noise_sigma=1.5)
    rgb = [render_rgb(model, divb_field.geometry.field, scene) for _ in range(FRAMES)]
    tmp = tmp_path_factory.mktemp("codec_torch")
    frames = roundtrip_rgb(rgb, tmp / "run.h264", enc)
    assert b"".join(jenc.encode_rgb(f) for f in rgb) == (tmp / "run.h264").read_bytes()
    delta = np.abs(frames[0].astype(int) - rgb[0].astype(int))
    assert delta.max() > 0 and delta.mean() > 0.1, "codec was a no-op?"
    return frames, scene


def _run_app(pkg: str, tmp_path, frames, packet: bytes, size) -> list:
    """``pkg``'s App on ``frames`` (re-mosaicked to RGGB by its driver, one
    every 50 ms of wall so that each frame's detections are back on its
    socket before the next dispatch), the JAX test's config; returns the
    detection frames it sent."""
    camera = _mod(pkg, "io.camera")
    synthetic = _mod(pkg, "io.synthetic")
    UDPSocket = _mod(pkg, "net.udp").UDPSocket
    proto = _mod(pkg, "proto")

    class CodecDriver(camera.CameraDriver):
        def __init__(self):
            self._idx = 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 1.0 / 100.0

        def get_time(self):
            return self._idx / 100.0

        def read_image(self):
            if self._idx >= len(frames):
                return None
            if self._idx:
                time.sleep(0.05)
            raw = synthetic.rgb_to_bayer(frames[self._idx], "RGGB")
            self._idx += 1
            return camera.RawFrame(data=raw, fmt="RGGB", width=size[0], height=size[1])

    camera.register_driver("CODEC_RT", lambda cam_cfg: CodecDriver())
    received = []

    class Recorder(UDPSocket):
        def _parse(self, data):
            wrapper = proto.SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("detection"):
                received.append(wrapper.detection)

    class Sender(UDPSocket):
        def _parse(self, data):
            pass

    sender, stop = Sender(GROUP, PORT), threading.Event()

    def publish():
        while not stop.is_set():
            sender.sock.sendto(packet, (GROUP, PORT))
            time.sleep(0.05)

    thread = threading.Thread(target=publish, daemon=True)
    thread.start()
    recorder = Recorder(GROUP, PORT)
    try:
        App = _mod(pkg, "app.main").App
        app = App(str(tmp_path / "config.yml"),
                  **({"device": "cpu"} if pkg.endswith("_torch") else {}))
        app.run()
        time.sleep(0.3)
    finally:
        stop.set()
        thread.join()
        recorder.close()
        sender.close()
    return received


def _by_frame(received) -> dict:
    out = {}
    for d in received:
        bots = sorted((team, r.robot_id, r.x, r.y, r.orientation)
                      for team, robots in (("y", d.robots_yellow), ("b", d.robots_blue))
                      for r in robots)
        out[d.frame_number] = (bots, sorted((b.x, b.y) for b in d.balls))
    return out


def test_codec_roundtrip_detection_equals_the_jax_app(tmp_path, monkeypatch, decoded,
                                                      divb_field, overhead_model):
    """tests/test_codec_roundtrip.py:54 on the port's App: four detection
    frames; in the last, yellow 5 and blue 2 within 30 mm and the ball
    within 40 mm; every frame's robots (team, id) equal to the JAX App's,
    positions within 0.5 mm, orientations within 1e-3 rad, balls within
    0.5 mm."""
    frames, scene = decoded
    (tmp_path / "heights.yml").write_text(yaml.dump({"TeamA": 143.0, "TeamB": 147.0}))
    (tmp_path / "config.yml").write_text(yaml.dump({
        "cam_id": 0, "bot_heights_file": str(tmp_path / "heights.yml"),
        "camera": {"driver": "CODEC_RT"},
        "network": {"vision_ip": GROUP, "vision_port": PORT, "gc_ip": GC_GROUP,
                    "gc_port": GC_PORT},
        "stream": {"active": False}, "debug": {"wait_for_geometry": True},
        "thresholds": {"blobs": 128},
    }))
    geometry = type(divb_field)()
    geometry.CopyFrom(divb_field)
    geometry.geometry.ClearField("calib")
    geometry.geometry.calib.append(overhead_model.to_proto(0))
    packet = geometry.SerializeToString()
    size = (int(overhead_model.size[0]), int(overhead_model.size[1]))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = {pkg: _by_frame(_run_app(pkg, tmp_path, frames, packet, size))
               for pkg in PKGS}
    finally:
        torch.set_num_threads(n)
    jax_f, port_f = got[PKGS[0]], got[PKGS[1]]
    assert sorted(port_f) == sorted(jax_f) == list(range(1, FRAMES + 1))
    for fn, (bots, balls) in port_f.items():
        jbots, jballs = jax_f[fn]
        assert [b[:2] for b in bots] == [b[:2] for b in jbots], f"frame {fn}"
        np.testing.assert_allclose([b[2:4] for b in bots], [b[2:4] for b in jbots],
                                   atol=0.5)
        np.testing.assert_allclose([b[4] for b in bots], [b[4] for b in jbots], atol=1e-3)
        assert len(balls) == len(jballs)
        np.testing.assert_allclose(balls, jballs, atol=0.5)
    bots, balls = port_f[FRAMES]
    by_id = {(team, i): (x, y) for team, i, x, y, _ in bots}
    assert sorted(by_id) == [("b", 2), ("y", 5)]
    for truth in scene.bots:
        x, y = by_id[("y" if truth.team == "yellow" else "b", truth.bot_id)]
        assert abs(x - truth.x) < 30 and abs(y - truth.y) < 30
    assert len(balls) == 1 and abs(balls[0][0] - scene.balls[0].x) < 40
