"""Degraded footage through the port's App: the counterpart of
tests/test_perturbation.py on the CPU.

``python/make_dataset.py`` (2 cameras, 6 frames) runs once for the module
and ``python/perturb.py`` once for each profile a row needs (blur,
vignette, white balance, noise, JPEG). Each row of the JAX test's table
(``tests/test_perturbation.py:35-72``: profile, circularity, recall bars,
error bar, resampling factor) runs the port's App as a process,
``python -m vision_processor_tpu_torch.app.main <config> --device cpu``,
over camera 0's perturbed mp4 through the OPENCV driver, under the JAX
test's config on a bus of its own; its detections on the wire are scored
against ``scene0.manual.json`` with the JAX test's bars.

Parity: for light at factor 1.0 and medium at factor 1.25 the same
decoded frames go through the JAX ``Processor`` and the port's
``Processor(device="cpu")`` in this process; every frame must give the
same robot ids and teams, with x and y within 0.5 mm, and the same
number of balls.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
GROUP, PORT = "224.99.99.161", 19161
GC_GROUP, GC_PORT = "224.99.99.162", 19162
FRAMES = 6
POS_MM = 0.5
ENV = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
       "OMP_NUM_THREADS": "2"}
# tests/test_perturbation.py:35-72, row for row
ROWS = [
    ("light", 15.0, 0.9, 0.5, 25.0, 1.0),
    ("moderate", 8.0, 0.8, 0.5, 30.0, 1.0),
    ("medium", 8.0, 0.7, 0.15, 40.0, 1.0),
    ("light", 15.0, 0.9, 0.5, 27.0, 1.5),
    ("light", 15.0, 0.9, 0.15, 27.0, 1.25),
    ("medium", 8.0, 0.7, 0.15, 42.0, 1.25),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def perturbed(tmp_path_factory):
    """Camera 0 of the perturbed dataset, by profile (built on first use)."""
    root = tmp_path_factory.mktemp("perturbation")
    subprocess.run(
        [sys.executable, str(REPO / "python" / "make_dataset.py"), "--out", str(root / "data"),
         "--cams", "2", "--frames", str(FRAMES)],
        check=True, cwd=str(REPO / "python"), env=ENV, capture_output=True, timeout=300)
    made = {}

    def folder(profile: str) -> Path:
        if profile not in made:
            subprocess.run(
                [sys.executable, str(REPO / "python" / "perturb.py"), "--data",
                 str(root / "data"), "--out", str(root / profile), "--profile", profile],
                check=True, cwd=str(REPO / "python"), env=ENV, capture_output=True,
                timeout=300)
            made[profile] = root / profile / "synthetic" / "cam0"
        return made[profile]

    return folder


def _config(folder: Path, out: Path, circularity: float, factor: float) -> Path:
    """tests/test_perturbation.py:100-107's config on this file's bus."""
    cfg = yaml.safe_load((folder / "ssl-vision-config" / "config.yml").read_text())
    cfg["camera"]["path"] = str(folder / "scene0.mp4")
    cfg["network"] = {"vision_ip": GROUP, "vision_port": PORT,
                      "gc_ip": GC_GROUP, "gc_port": GC_PORT}
    cfg["stream"] = {"active": False}
    cfg["debug"] = {"wait_for_geometry": True}
    cfg["thresholds"] = {"blobs": 128, "circularity": circularity,
                         "resampling_factor": factor}
    path = out / "config.yml"
    path.write_text(yaml.dump(cfg))
    return path


def _wire_detections(config: Path, geometry: bytes, workdir: Path) -> list:
    """The port's App as a process over the config's video, geometry
    published every 100 ms: the detection frames on the bus (the bus
    drops the datagrams it sent itself)."""
    from vision_processor_tpu_torch.net.udp import UDPSocket
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket

    detections = []

    class Bus(UDPSocket):
        def _parse(self, data):
            if data == geometry:
                return
            wrapper = SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("detection"):
                detections.append(wrapper.detection)

    bus = Bus(GROUP, PORT)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            bus.sock.sendto(geometry, bus.address)
            stop.wait(0.1)

    publisher = threading.Thread(target=publish, daemon=True)
    publisher.start()
    log = workdir / "app.log"
    try:
        with open(log, "wb") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "vision_processor_tpu_torch.app.main", str(config),
                 "--device", "cpu"],
                env=ENV, cwd=str(workdir), stdout=fh, stderr=subprocess.STDOUT)
            try:
                rc = proc.wait(timeout=240)
                time.sleep(0.5)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
    finally:
        stop.set()
        publisher.join(timeout=5)
        bus.close()
    assert rc == 0, f"app rc={rc}; log tail: {log.read_text()[-2000:]}"
    assert len(detections) == FRAMES, log.read_text()[-2000:]
    return detections


def score(detections, truth: list) -> tuple[float, float, float, list]:
    """tests/test_perturbation.py's scoring: robot recall by id, ball recall
    (a ball sent in a frame with a ball), the matched robots' errors."""
    found_bots, total_bots, errs, ball_found, ball_total = 0, 0, [], 0, 0
    for det in detections:
        gt = truth[det.frame_number - 1]
        gt_bots = [(b["robot_id"], b["x"], b["y"]) for b in gt.get("robots_yellow", [])]
        gt_bots += [(b["robot_id"] + 16, b["x"], b["y"]) for b in gt.get("robots_blue", [])]
        got = [(r.robot_id, r.x, r.y) for r in det.robots_yellow]
        got += [(r.robot_id + 16, r.x, r.y) for r in det.robots_blue]
        for rid, x, y in gt_bots:
            total_bots += 1
            match = [g for g in got if g[0] == rid]
            if match:
                found_bots += 1
                errs.append(float(np.hypot(match[0][1] - x, match[0][2] - y)))
        if gt.get("balls"):
            ball_total += 1
            ball_found += bool(len(det.balls))
    return (found_bots / max(total_bots, 1), ball_found / max(ball_total, 1),
            float(np.mean(errs)) if errs else float("inf"), errs)


def _geometry(folder: Path) -> bytes:
    from vision_processor_tpu_torch.net.geometry_io import load_geometry

    return load_geometry(folder / "geometry.yml").SerializeToString()


@pytest.mark.parametrize("profile,circularity,min_bot_recall,min_ball_recall,max_err,factor",
                         ROWS)
def test_perturbed_scene_detection_through_the_port_app(perturbed, tmp_path, profile,
                                                         circularity, min_bot_recall,
                                                         min_ball_recall, max_err, factor):
    folder = perturbed(profile)
    config = _config(folder, tmp_path, circularity, factor)
    detections = _wire_detections(config, _geometry(folder), tmp_path)
    truth = json.loads((folder / "scene0.manual.json").read_text())
    recall, ball_recall, mean_err, errs = score(detections, truth)
    assert recall >= min_bot_recall, f"{profile}: robot recall {recall:.2f}, errs {errs}"
    assert ball_recall >= min_ball_recall, f"{profile}: ball recall {ball_recall:.2f}"
    assert mean_err < max_err, f"{profile}: mean position error {mean_err:.1f} mm"


def _robots(det) -> dict:
    return {(team, r.robot_id): (r.x, r.y)
            for team, robots in (("yellow", det.robots_yellow), ("blue", det.robots_blue))
            for r in robots}


@pytest.mark.parametrize("profile,circularity,factor", [("light", 15.0, 1.0),
                                                        ("medium", 8.0, 1.25)])
def test_perturbed_frames_equal_jax(perturbed, tmp_path, profile, circularity, factor):
    """The decoded perturbed frames through both packages' Processor."""
    from vision_processor_tpu.app.processor import Processor as JProcessor
    from vision_processor_tpu.io.camera import RawFrame as JRawFrame
    from vision_processor_tpu.proto import SSL_WrapperPacket as JWrapper
    from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig
    from vision_processor_tpu_torch.app.processor import Processor
    from vision_processor_tpu_torch.io.camera import open_camera
    from vision_processor_tpu_torch.proto import SSL_WrapperPacket
    from vision_processor_tpu_torch.utils.config import VisionConfig

    folder = perturbed(profile)
    config = _config(folder, tmp_path, circularity, factor)
    geometry = _geometry(folder)
    tcfg, jcfg = VisionConfig.load(str(config)), JVisionConfig.load(str(config))
    wrapper, jwrapper = SSL_WrapperPacket(), JWrapper()
    wrapper.ParseFromString(geometry)
    jwrapper.ParseFromString(geometry)
    tp, jp = Processor(tcfg, device="cpu"), JProcessor(jcfg)
    camera = open_camera(tcfg.camera)
    n = 0
    try:
        while (frame := camera.read_image()) is not None:
            n += 1
            tp.geometry_check(frame.width, frame.height, wrapper.geometry, 1)
            jp.geometry_check(frame.width, frame.height, jwrapper.geometry, 1)
            got, _, _ = tp.process_frame(frame, {}, now=frame.timestamp)
            want, _, _ = jp.process_frame(
                JRawFrame(frame.data, frame.fmt, frame.width, frame.height, frame.timestamp),
                {}, now=frame.timestamp)
            a, b = _robots(got.detection), _robots(want.detection)
            assert sorted(a) == sorted(b), (profile, factor, n)
            for key, (x, y) in a.items():
                assert x == pytest.approx(b[key][0], abs=POS_MM), (profile, factor, n, key)
                assert y == pytest.approx(b[key][1], abs=POS_MM), (profile, factor, n, key)
            assert len(got.detection.balls) == len(want.detection.balls), (profile, factor, n)
    finally:
        camera.close()
    assert n == FRAMES
