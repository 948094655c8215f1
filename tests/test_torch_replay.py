"""The port's file replay and benchmark binaries against the JAX package:
the OpenCV driver, geometry.yml loading, the ground-truth file,
``Processor.process_frame``, and ``app/blob_benchmark.py`` /
``app/geometry_benchmark.py`` on a three-frame dataset written here (a
480x270 BGR camera over the penalty area, MJPG in AVI, its gt.yml and
geometry.yml).

Tolerances: frames, times and messages are equal; detections have the
same ids and counts, positions within 0.5 mm and orientations within 1e-3
rad, as in tests/test_torch_slice.py (float32 reassociation: 0.00024 mm
measured); the ``[BlobMachine]`` values agree within 1e-3 relative (the
processing time left out), ``[Model score]`` within 1e-6 relative.
"""
from __future__ import annotations

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vision_processor_tpu.app import blob_benchmark as JBB
from vision_processor_tpu.app import geometry_benchmark as JGB
from vision_processor_tpu.app import ground_truth as JGT
from vision_processor_tpu.app.processor import Processor as JProcessor
from vision_processor_tpu.io.camera import OpenCVDriver as JOpenCVDriver
from vision_processor_tpu.net import geometry_io as JG
from vision_processor_tpu.utils.config import CameraSection
from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig
from vision_processor_tpu_torch.app import blob_benchmark as BB
from vision_processor_tpu_torch.app import geometry_benchmark as GB
from vision_processor_tpu_torch.app import ground_truth as GT
from vision_processor_tpu_torch.app.processor import Processor
from vision_processor_tpu_torch.io.camera import OpenCVDriver, RawFrame
from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot, render_rgb
from vision_processor_tpu_torch.models.camera import CameraModel
from vision_processor_tpu_torch.net import geometry_io as G
from vision_processor_tpu_torch.utils.config import VisionConfig

cv2 = pytest.importorskip("cv2")

WIDTH, HEIGHT, FRAMES = 480, 270, 3
GROUP, PORT = "224.99.99.71", 17711
FIELD = {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000, "goal_depth": 180,
    "penalty_area_depth": 1000, "penalty_area_width": 2000, "boundary_width": 300,
    "center_circle_radius": 500, "line_thickness": 10, "ball_radius": 21.5,
    "max_robot_radius": 90.0,
}
# python/blob_benchmark.py's names for the values of the [BlobMachine] line
BLOB_MACHINE_FIELDS = [
    "frames", "blobs", "error", "sq_error", "worst_blob", "percentile",
    "balls", "ball_error", "ball_sq", "bots", "bot_error", "bot_sq",
    "field_scale", "processing_time",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gt_frame(model, scene, number: int) -> dict:
    """One gt.yml entry (the schema app/ground_truth.py parses)."""
    entry = {"camera_id": 0, "frame_number": number, "t_capture": number / 30.0,
             "t_sent": number / 30.0, "balls": [], "robots_yellow": [], "robots_blue": []}
    for ball in scene.balls:
        px = model.field2image(np.array([ball.x, ball.y, 0.0]))
        entry["balls"].append({"confidence": 1.0, "x": ball.x, "y": ball.y,
                               "pixel_x": float(px[0]), "pixel_y": float(px[1])})
    for bot in scene.bots:
        px = model.field2image(np.array([bot.x, bot.y, bot.height]))
        entry[f"robots_{bot.team}"].append({
            "confidence": 1.0, "robot_id": bot.bot_id, "x": bot.x, "y": bot.y,
            "orientation": bot.orientation, "pixel_x": float(px[0]),
            "pixel_y": float(px[1]), "height": bot.height})
    return entry


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The scene's frames as an MJPG AVI and a PNG, gt.yml, geometry.yml
    (field and calibration) and a config that replays the video."""
    root = tmp_path_factory.mktemp("dataset")
    model = CameraModel(focal_length=900.0, principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
                        distortion_k2=0.02, pos=np.array([-3300.0, -800.0, 4500.0]),
                        size=np.array([WIDTH, HEIGHT]))
    scene = Scene(bots=[SceneBot(3, "yellow", -3000.0, -600.0, 0.7),
                        SceneBot(9, "blue", -2500.0, -1100.0, -2.0)],
                  balls=[SceneBall(-2800.0, -300.0)], noise_sigma=1.5, seed=3)
    geometry = G.geometry_from_dict({"field": FIELD})
    bgr = np.ascontiguousarray(render_rgb(model, geometry.field, scene)[..., ::-1])
    writer = cv2.VideoWriter(str(root / "scene.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                             30.0, (WIDTH, HEIGHT))
    writer.set(cv2.VIDEOWRITER_PROP_QUALITY, 100)
    for _ in range(FRAMES):
        writer.write(bgr)
    writer.release()
    cv2.imwrite(str(root / "field.png"), bgr)
    calib = G.calibration_from_model(model, 0)
    (root / "geometry.yml").write_text(yaml.dump({
        "field": FIELD,
        "calib": [{f.name: getattr(calib, f.name) for f in dataclasses.fields(calib)}]}))
    (root / "gt.yml").write_text(yaml.dump([_gt_frame(model, scene, f + 1)
                                            for f in range(FRAMES)]))
    config = root / "config.yml"
    config.write_text(yaml.dump({
        "cam_id": 0, "camera": {"driver": "OPENCV", "path": str(root / "scene.avi")},
        "network": {"vision_ip": GROUP, "vision_port": PORT, "gc_ip": GROUP,
                    "gc_port": PORT + 1},
        "debug": {"ground_truth": str(root / "gt.yml")}}))
    return root, model, scene, config


def _replay(driver):
    out = []
    while (frame := driver.read_image()) is not None:
        out.append((frame.data.copy(), frame.fmt, frame.width, frame.height,
                    driver.get_time()))
    driver.close()
    return out


@pytest.mark.parametrize("name", ["scene.avi", "field.png"])
def test_opencv_driver_replays_as_the_jax_driver(dataset, name):
    """A video replays its frames, an image one frame: the same BGR frames,
    sizes and file times (frame index / fps) as the JAX driver."""
    root = dataset[0]
    section = CameraSection(driver="OPENCV", path=str(root / name))
    got, want = _replay(OpenCVDriver(section)), _replay(JOpenCVDriver(section))
    assert len(got) == len(want) == (FRAMES if name == "scene.avi" else 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:] and a[1:4] == ("BGR", WIDTH, HEIGHT)
    assert OpenCVDriver(section).expected_frametime() == pytest.approx(1 / 30.0)


def test_load_geometry_equals_the_jax_message(dataset):
    """geometry.yml -> SSL_WrapperPacket with the generated markings: the
    same message as the JAX package's, for the dataset's file and the
    repository's Division B file (optional lines switched off)."""
    from google.protobuf.json_format import MessageToDict

    from vision_processor_tpu_torch.models.camera import CameraModel as Model

    root = dataset[0]
    for path in (root / "geometry.yml",
                 Path(__file__).resolve().parents[1] / "geometry-divB.yml"):
        got, want = G.load_geometry(path), JG.load_geometry(path)
        assert MessageToDict(got) == MessageToDict(want)
        assert len(got.geometry.field.field_lines) >= 4
    cfg = G.yaml_load(root / "geometry.yml")
    assert MessageToDict(G.geometry_wrapper_from_dict(cfg)) == MessageToDict(
        JG.geometry_from_dict(cfg))
    calib = G.load_geometry(root / "geometry.yml").geometry.calib[0]
    np.testing.assert_allclose(Model.from_proto(calib).pos, dataset[1].pos, atol=0.01)
    assert G.yaml_load(root / "none.yml", default=dict) == {}
    with pytest.raises(FileNotFoundError):
        G.yaml_load(root / "none.yml")


def test_ground_truth_equals_the_jax_parser(dataset):
    root = dataset[0]
    got = GT.parse_ground_truth(root / "gt.yml")
    want = JGT.parse_ground_truth(root / "gt.yml")
    assert [f.SerializeToString() for f in got] == [f.SerializeToString() for f in want]
    for number in (0, 2, FRAMES + 1):
        a, b = GT.corresponding_frame(got, number), JGT.corresponding_frame(want, number)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.SerializeToString() == b.SerializeToString()
    GT.dump_ground_truth(got, root / "gt-again.yml")
    assert [f.SerializeToString() for f in GT.parse_ground_truth(root / "gt-again.yml")] == \
        [f.SerializeToString() for f in got]


def test_process_frame_equals_the_jax_processor(dataset):
    """Two frames of the dataset's camera as a Bayer frame through
    ``process_frame``, the second with the first's detections as the
    tracked prior: the detections equal the JAX Processor's (see the
    tolerances above)."""
    from types import SimpleNamespace

    from vision_processor_tpu.io.synthetic import render_raw

    root, model, scene, _ = dataset
    geometry = JG.load_geometry(root / "geometry.yml").geometry
    raw = render_raw(model, geometry.field, scene, "RGGB")
    configs = (JVisionConfig(), VisionConfig())
    for cfg in configs:
        cfg.max_blobs, cfg.resample_mode = 256, "gather"
    jp, tp = JProcessor(configs[0]), Processor(configs[1], device="cpu")
    tracked = {}
    for number in (1, 2):
        frame = RawFrame(data=raw, fmt="RGGB", width=WIDTH, height=HEIGHT,
                         timestamp=number / 30.0)
        out = []
        for p in (jp, tp):
            p.geometry_check(WIDTH, HEIGHT, geometry, 1)
            wrapper, blobs, _ = p.process_frame(frame, tracked, now=number / 30.0)
            out.append((wrapper.detection, int(blobs["count"])))
        (jdet, jcount), (det, count) = out
        assert count == jcount > 0
        for field in ("robots_yellow", "robots_blue", "balls"):
            a, b = getattr(det, field), getattr(jdet, field)
            assert len(a) == len(b), field
            for x, y in zip(a, b):
                assert x.x == pytest.approx(y.x, abs=0.5) and x.y == pytest.approx(y.y, abs=0.5)
                if field != "balls":
                    assert x.robot_id == y.robot_id
                    assert x.orientation == pytest.approx(y.orientation, abs=1e-3)
        assert det.frame_number == jdet.frame_number == number
        assert det.t_capture_camera == jdet.t_capture_camera == number / 30.0
        assert sorted(r.robot_id for r in det.robots_yellow) == [3]
        tracked = {0: [SimpleNamespace(id=r.robot_id + off, x=r.x, y=r.y, z=r.height,
                                       w=r.orientation, vx=0.0, vy=0.0, vw=0.0,
                                       timestamp=number / 30.0)
                       for robots, off in ((det.robots_yellow, 0), (det.robots_blue, 16))
                       for r in robots]}


def _line(out: str, tag: str) -> list[float]:
    lines = [ln for ln in out.splitlines() if ln.startswith(tag)]
    assert len(lines) == 1, out
    return [float(v) for v in lines[0][len(tag):].split()]


def test_benchmarks_equal_the_jax_binaries(dataset, capsys):
    """Both benchmarks on the dataset: the [BlobMachine] line parses into
    python/blob_benchmark.py's fields, with the JAX binary's values within
    1e-3 relative (the processing time left out) and 5 blobs per robot
    plus 1 per ball a frame found; the human lines name the same colours;
    [Model score] within 1e-6 relative."""
    config = str(dataset[3])
    assert BB.main([config, "--device", "cpu"]) == 0
    assert GB.main([config, "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert JBB.main([config]) == 0
    assert JGB.main([config]) == 0
    ref = capsys.readouterr().out
    got, want = _line(ours, "[BlobMachine]"), _line(ref, "[BlobMachine]")
    assert len(got) == len(want) == len(BLOB_MACHINE_FIELDS)
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-3)
    values = dict(zip(BLOB_MACHINE_FIELDS, got))
    assert values["frames"] == FRAMES
    assert values["blobs"] == FRAMES * (5 * 2 + 1)
    assert values["balls"] == FRAMES and values["bots"] == 2 * FRAMES
    assert np.isfinite(values["error"]) and values["error"] > 0

    def colours(out):
        return [ln.split(" error:")[0] for ln in out.splitlines()
                if ln.startswith("[Blob benchmark] Avg color")]

    assert colours(ours) == colours(ref) and len(colours(ours)) == 6
    score, jscore = _line(ours, "[Model score]"), _line(ref, "[Model score]")
    np.testing.assert_allclose(score, jscore, rtol=1e-6)
    assert np.isfinite(score[0])


def test_benchmarks_default_to_the_card():
    for mod in (BB, GB):
        assert "--device cpu" in mod.__doc__
    args = BB.parse_args([], "x")
    assert (args.config, args.device) == ("config.yml", "cuda")
    assert BB.parse_args(["a.yml", "--device", "cpu"], "x").device == "cpu"
    assert inspect.signature(GB.main).parameters["argv"].default is None
