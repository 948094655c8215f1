"""The port as the dataset harness runs it: one OS process per camera
through the launchers under ``vision_processor_tpu_torch/scripts/``, on
``python/make_dataset.py``'s synthetic dataset (2 cameras, 4 frames), on
the CPU (``--device cpu``).

The counterpart of tests/test_multiprocess.py for the port, plus parity
with the JAX package: each camera's detections on the bus against the JAX
Processor run in this process on the same decoded frames (the same robot
ids and teams, x and y within 0.5 mm, orientation within 1e-3 rad, as in
tests/test_torch_replay.py), and the harness's ``run_binary`` with the
port's blob-benchmark launcher against the JAX blob benchmark's
``[BlobMachine]`` line (within 1e-3 relative, the processing time left
out).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "vision_processor_tpu_torch" / "scripts"
LAUNCHERS = {name: SCRIPTS / f"{name}.py"
             for name in ("vision_processor", "blob_benchmark", "geometry_benchmark")}
GROUP, PORT = "224.99.99.131", 18811
GC_GROUP, GC_PORT = "224.99.99.132", 18812
FRAMES = 4
# the harness's environment (python/binary.py _subprocess_env); two torch
# threads a child leave the cores to the other test workers
ENV = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
       "OMP_NUM_THREADS": "2"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory) -> Path:
    """python/make_dataset.py's synthetic field: cam0 and cam1, one scene of
    FRAMES frames each (the harness's layout)."""
    out = tmp_path_factory.mktemp("data")
    subprocess.run(
        [sys.executable, str(REPO / "python" / "make_dataset.py"), "--out", str(out),
         "--cams", "2", "--frames", str(FRAMES)],
        check=True, cwd=str(REPO / "python"), env=ENV, capture_output=True, timeout=300)
    return out / "synthetic"


class Bus:
    """The vision bus as a geometry publisher sees it: sends the merged
    geometry every 100 ms and records every detection frame, ignoring the
    datagrams it sent itself (multicast loopback hands them back)."""

    def __init__(self, geometry: bytes):
        from vision_processor_tpu_torch.net.udp import UDPSocket
        from vision_processor_tpu_torch.proto import SSL_WrapperPacket

        self.geometry, self.detections = geometry, []
        detections = self.detections

        class Sock(UDPSocket):
            def _parse(self, data):
                if data == geometry:
                    return
                wrapper = SSL_WrapperPacket()
                wrapper.ParseFromString(data)
                if wrapper.HasField("detection"):
                    detections.append(wrapper.detection)

        self.sock = Sock(GROUP, PORT)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._publish, daemon=True)
        self.thread.start()

    def _publish(self):
        while not self.stop.is_set():
            self.sock.sock.sendto(self.geometry, self.sock.address)
            time.sleep(0.1)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()
        self.sock.close()


def _configs(dataset: Path, out: Path) -> list[Path]:
    """Each camera's dataset config with test_multiprocess.py's changes:
    the scene's video, the isolated bus, no stream, wait for geometry,
    128 blobs."""
    paths = []
    for cam in range(2):
        folder = dataset / f"cam{cam}"
        cfg = yaml.safe_load((folder / "ssl-vision-config" / "config.yml").read_text())
        cfg["camera"]["path"] = str(folder / "scene0.mp4")
        cfg["network"] = {"vision_ip": GROUP, "vision_port": PORT,
                          "gc_ip": GC_GROUP, "gc_port": GC_PORT}
        cfg["stream"] = {"active": False}
        cfg["debug"] = {"wait_for_geometry": True}
        cfg["thresholds"] = {"blobs": 128}
        path = out / f"cam{cam}.yml"
        path.write_text(yaml.dump(cfg))
        paths.append(path)
    return paths


def _merged_geometry(dataset: Path) -> bytes:
    from vision_processor_tpu_torch.net.geometry_io import load_geometry

    merged = load_geometry(dataset / "cam0" / "geometry.yml")
    other = load_geometry(dataset / "cam1" / "geometry.yml")
    merged.geometry.calib.append(other.geometry.calib[0])
    return merged.SerializeToString()


def _jax_detections(config: Path, geometry: bytes) -> list:
    """The JAX Processor on the camera's decoded frames, in this process:
    its detection frames, in order."""
    from vision_processor_tpu.app.processor import Processor as JProcessor
    from vision_processor_tpu.io.camera import open_camera
    from vision_processor_tpu.proto import SSL_WrapperPacket
    from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig

    cfg = JVisionConfig.load(str(config))
    wrapper = SSL_WrapperPacket()
    wrapper.ParseFromString(geometry)
    camera = open_camera(cfg.camera)
    proc = JProcessor(cfg)
    out = []
    try:
        while (frame := camera.read_image()) is not None:
            proc.geometry_check(frame.width, frame.height, wrapper.geometry, 1)
            det, _, _ = proc.process_frame(frame, {}, now=frame.timestamp)
            out.append(det.detection)
    finally:
        camera.close()
    return out


def _robots(det) -> list:
    return sorted((team, r.robot_id, r.x, r.y, r.orientation)
                  for team, robots in (("yellow", det.robots_yellow), ("blue", det.robots_blue))
                  for r in robots)


def test_two_port_processes_shared_bus(dataset, tmp_path):
    """Two port processes (cam 0 and cam 1) and a geometry publisher on one
    multicast group: 4 detection frames from each camera on the bus, robots
    found, clock-sync offsets flowing, both exit 0; each camera's frames
    equal the JAX Processor's on the same frames."""
    configs = _configs(dataset, tmp_path)
    geometry = _merged_geometry(dataset)
    bus = Bus(geometry)
    logs = [open(tmp_path / f"cam{cam}.log", "wb") for cam in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(LAUNCHERS["vision_processor"]), str(cfg), "--device", "cpu"],
        env=ENV, cwd=str(tmp_path), stdout=subprocess.DEVNULL, stderr=log)
        for cfg, log in zip(configs, logs)]
    try:
        for cam, proc in enumerate(procs):
            assert proc.wait(timeout=180) == 0, (tmp_path / f"cam{cam}.log").read_text()
        time.sleep(0.5)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for log in logs:
            log.close()
        bus.close()

    by_cam = {}
    for det in bus.detections:
        by_cam.setdefault(det.camera_id, []).append(det)
    assert set(by_cam) == {0, 1}, f"cams seen: {set(by_cam)}"
    for cam, dets in by_cam.items():
        assert len(dets) == FRAMES, cam
        assert [d.frame_number for d in dets] == list(range(1, FRAMES + 1))
        assert sum(len(d.robots_yellow) + len(d.robots_blue) for d in dets) > 0, cam
    assert any(len(d.t_offsets) > 0 for d in bus.detections)

    for cam, dets in by_cam.items():
        want = _jax_detections(configs[cam], geometry)
        assert len(want) == FRAMES
        for got, ref in zip(dets, want):
            a, b = _robots(got), _robots(ref)
            assert [r[:2] for r in a] == [r[:2] for r in b], (cam, got.frame_number)
            for x, y in zip(a, b):
                assert x[2] == pytest.approx(y[2], abs=0.5)
                assert x[3] == pytest.approx(y[3], abs=0.5)
                assert x[4] == pytest.approx(y[4], abs=1e-3)
            assert len(got.balls) == len(ref.balls)
            for x, y in zip(got.balls, ref.balls):
                assert x.x == pytest.approx(y.x, abs=0.5) and x.y == pytest.approx(y.y, abs=0.5)


def _blob_machine(lines) -> list[float]:
    got = [ln for ln in lines if ln.startswith("[BlobMachine]")]
    assert len(got) == 1, lines
    return [float(v) for v in got[0].split()[1:]]


def test_blob_benchmark_through_the_harness(dataset, tmp_path, capsys, monkeypatch):
    """python/binary.py ``run_binary`` with a ``.py`` binary that runs the
    port's blob-benchmark launcher with ``--device cpu`` on cam0's scene:
    the ``[BlobMachine]`` line the harness reads off the child's stdout
    equals the JAX blob benchmark's on the same rewritten config (within
    1e-3 relative, the processing time left out)."""
    import shutil

    monkeypatch.syspath_prepend(str(REPO / "python"))
    from binary import run_binary
    from dataset import Dataset
    from visionsocket import VisionRecorder

    from vision_processor_tpu.app import blob_benchmark as JBB

    folder = tmp_path / "synthetic" / "cam0"
    shutil.copytree(dataset / "cam0", folder)
    binary = tmp_path / "vp_torch_blob_benchmark.py"
    launcher = str(LAUNCHERS["blob_benchmark"])
    binary.write_text(
        "import runpy, sys\n"
        f"sys.argv = [{launcher!r}, *sys.argv[1:], '--device', 'cpu']\n"
        f"runpy.run_path({launcher!r}, run_name='__main__')\n")
    data = Dataset(folder)
    lines = []
    recorder = VisionRecorder(GROUP, PORT)
    try:
        run_binary(binary, recorder, data, folder / "scene0.mp4", stdoutconsumer=lines.append)
    finally:
        recorder.socket.close()
    got = _blob_machine(lines)
    capsys.readouterr()
    assert JBB.main([str(data.processor_config)]) == 0
    want = _blob_machine(capsys.readouterr().out.splitlines())
    assert len(got) == len(want) == 14
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-3)
    assert got[0] == FRAMES and got[1] > 0


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_binary_command_runs_the_port_launchers(name, tmp_path, monkeypatch):
    """python/binary.py runs each launcher as ``[python, path, config]``;
    under the harness's PYTHONPATH, ``--help`` exits 0 and names
    ``--device``."""
    monkeypatch.syspath_prepend(str(REPO / "python"))
    from binary import binary_command

    launcher, cfg = LAUNCHERS[name], tmp_path / "config.yml"
    assert binary_command(Path(launcher), cfg) == [sys.executable, str(launcher), str(cfg)]
    proc = subprocess.run([sys.executable, str(launcher), "--help"], env=ENV, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout


def test_launcher_without_device_refuses_the_cpu(dataset, tmp_path):
    """Without ``--device`` the launcher runs on the card; on a machine
    without one it exits non-zero with the CUDA error, and no detection
    reaches the bus."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    configs = _configs(dataset, tmp_path)
    bus = Bus(_merged_geometry(dataset))
    try:
        proc = subprocess.run(
            [sys.executable, str(LAUNCHERS["vision_processor"]), str(configs[0])],
            env=ENV, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
        time.sleep(0.3)
    finally:
        bus.close()
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr.splitlines()[-1], proc.stderr[-2000:]
    assert bus.detections == []


def test_apps_refuse_a_cuda_device_without_a_card(dataset, tmp_path):
    """``App`` and ``MultiCamApp`` on their default device raise at start,
    naming CUDA, where torch reaches no card (the launcher's error above)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the apps would run on it")
    from vision_processor_tpu_torch.app.main import App
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp

    configs = [str(p) for p in _configs(dataset, tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        App(configs[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiCamApp(configs)


def test_console_scripts_name_the_port():
    """pyproject.toml's [project.scripts]: the port's three entry points
    resolve to its mains, and the JAX package's stand as they were."""
    import importlib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert {k: v for k, v in scripts.items() if "torch" not in k} == {
        "vision-processor-tpu": "vision_processor_tpu.app.main:main",
        "vptpu-blob-benchmark": "vision_processor_tpu.app.blob_benchmark:main",
        "vptpu-geometry-benchmark": "vision_processor_tpu.app.geometry_benchmark:main",
    }
    want = {"vision-processor-tpu-torch": "vision_processor_tpu_torch.app.main",
            "vptpu-torch-blob-benchmark": "vision_processor_tpu_torch.app.blob_benchmark",
            "vptpu-torch-geometry-benchmark":
                "vision_processor_tpu_torch.app.geometry_benchmark"}
    for script, module in want.items():
        mod, attr = scripts[script].split(":")
        assert mod == module
        assert getattr(importlib.import_module(mod), attr) is importlib.import_module(
            module).main
