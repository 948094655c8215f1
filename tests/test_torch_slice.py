"""The PyTorch port's per-camera slice against the JAX package.

The JAX ``Processor`` and the port's ``Processor`` run the same rendered
frames of a small camera (480x270 model, a pose ``warp_fits`` accepts,
max_blobs 256) through ``device_step`` -> ``finish_frame`` for 2 frames
with tracking fed back, in forced "gather" and "warp" modes and with the
host finishing path: blob count, bot ids and ball count must be equal,
positions within 0.5 mm and orientations within 1e-3 rad. Unit parity of
the detector's k-means, NMS and id estimate, the state transfer, and the
port's freedom from JAX imports are checked here too.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.app.processor import Processor as JProcessor
from vision_processor_tpu.app.processor import TrackedArrays as JTracked
from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
from vision_processor_tpu.models import detector as JD
from vision_processor_tpu.models import device_finish as JDF
from vision_processor_tpu.models.camera import CameraModel
from vision_processor_tpu.utils.config import VisionConfig
from vision_processor_tpu_torch.app.processor import Processor, TrackedArrays
from vision_processor_tpu_torch.models import detector as D
from vision_processor_tpu_torch.models import device_finish as DF
from vision_processor_tpu_torch.ops.warp import warp_fits
from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

ROOT = Path(__file__).resolve().parents[1]
WIDTH, HEIGHT = 480, 270


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig(divb_field):
    model = CameraModel(
        focal_length=900.0, principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
        distortion_k2=0.02, pos=np.array([-2250.0, -1500.0, 4500.0]),
        size=np.array([WIDTH, HEIGHT]),
    )
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(model.to_proto(0))
    scene = Scene(
        bots=[SceneBot(3, "yellow", -2500.0, -1300.0, 0.7),
              SceneBot(9, "blue", -1700.0, -1650.0, -2.0)],
        balls=[SceneBall(-2100.0, -1150.0)], noise_sigma=1.5, seed=3,
    )
    raw = render_raw(model, geometry.field, scene, "RGGB")
    return geometry, model, scene, raw


def _config(mode: str, device_finish: bool) -> VisionConfig:
    cfg = VisionConfig()
    cfg.max_blobs = 256
    cfg.resampling_factor = 1.25
    cfg.resample_mode = mode
    cfg.device_finish = device_finish
    return cfg


def _detections(wrapper):
    d = wrapper.detection
    bots = {}
    for team, off in ((d.robots_yellow, 0), (d.robots_blue, 16)):
        for r in team:
            bots[r.robot_id + off] = (r.x, r.y, r.orientation)
    balls = sorted((b.x, b.y) for b in d.balls)
    return bots, balls


def _tracked_from(wrapper, now, cls):
    ents = []
    for bid, (x, y, w) in _detections(wrapper)[0].items():
        ents.append(SimpleNamespace(id=bid, x=x, y=y, z=145.0, w=w, vx=0.0, vy=0.0,
                                    vw=0.0, timestamp=now))
    return cls.build({0: ents}, now + 0.01, 32)


@pytest.mark.parametrize("mode,device_finish", [
    ("gather", True), ("warp", True), ("gather", False),
])
def test_slice_parity(rig, mode, device_finish):
    geometry, model, scene, raw = rig
    jp = JProcessor(_config(mode, device_finish))
    tp = Processor(_config(mode, device_finish), device="cpu")
    for p in (jp, tp):
        p.geometry_check(WIDTH, HEIGHT, geometry, 1)
    j_tr = JTracked.build({}, 0.0, 32)
    t_tr = TrackedArrays.build({}, 0.0, 32)
    for frame in range(2):
        j_wrapper, j_blobs, _ = jp.finish_frame(jp.device_step(raw, "RGGB", j_tr),
                                                frame * 0.01)
        t_wrapper, t_blobs, _ = tp.finish_frame(tp.device_step(raw, "RGGB", t_tr),
                                                frame * 0.01)
        assert tp.resample_mode == jp._bm_cfg.resample_mode == mode
        bm = tp._bm_cfg
        assert warp_fits(model, bm.field_scale, bm.field_offset, bm.flat_shape,
                         bm.plane_shape, tp.max_bot_height)

        assert int(t_blobs["count"]) == int(j_blobs["count"])
        n = int(np.asarray(j_blobs["valid"]).sum())
        assert int(t_blobs["valid"].sum()) == n > 5
        np.testing.assert_allclose(t_blobs["field_pos"][:n],
                                   np.asarray(j_blobs["field_pos"])[:n], atol=0.5)

        j_bots, j_balls = _detections(j_wrapper)
        t_bots, t_balls = _detections(t_wrapper)
        assert sorted(t_bots) == sorted(j_bots) == [3, 25]
        for bid, (x, y, w) in j_bots.items():
            tx, ty, tw = t_bots[bid]
            assert abs(tx - x) < 0.5 and abs(ty - y) < 0.5
            assert abs(tw - w) < 1e-3
        assert len(t_balls) == len(j_balls) == 1
        np.testing.assert_allclose(t_balls, j_balls, atol=0.5)
        np.testing.assert_array_equal(tp.colors.packed(), jp.colors.packed())

        j_tr = _tracked_from(j_wrapper, frame * 0.01, JTracked)
        t_tr = _tracked_from(t_wrapper, frame * 0.01, TrackedArrays)
        assert t_tr.valid.sum() == 2


def test_state_roundtrip():
    cfg = _config("gather", True)
    tp = Processor(cfg, device="cpu")
    state = {
        "params": tp.params(),
        "colors": tp.colors.packed(),
        "tracked": TrackedArrays.build({}, 0.0, 32).as_dict(),
        "grid": {"idx": np.arange(6, dtype=np.int64).reshape(2, 3),
                 "ub": np.linspace(0, 1, 6).reshape(2, 3)},
    }
    dev = to_torch(state, "cpu")
    assert dev["tracked"]["id"].dtype == torch.int32
    assert dev["tracked"]["valid"].dtype == torch.bool
    assert dev["grid"]["idx"].dtype == torch.int32  # int64 narrows like JAX
    assert dev["grid"]["ub"].dtype == torch.float32
    back = to_numpy(dev)
    for key, val in state["params"].items():
        np.testing.assert_array_equal(back["params"][key], val)
    np.testing.assert_array_equal(back["colors"], state["colors"])
    np.testing.assert_array_equal(back["grid"]["idx"], state["grid"]["idx"])


def test_guarded_kmeans_and_ids_parity():
    rng = np.random.default_rng(2)
    b = 64
    colors = np.array([[192, 128, 64], [128, 128, 128], [255, 128, 0], [0, 128, 255],
                       [0, 255, 128], [255, 0, 128], [128, 128, 128]], np.float32)
    blob_color = rng.uniform(0, 255, (300, 3)).astype(np.float32)
    blob_color[:40] = colors[rng.integers(2, 6, 40)] + rng.normal(0, 8, (40, 3))
    idx = rng.integers(-1, 300, (b, 5)).astype(np.int32)
    idx[:20] = rng.integers(0, 40, (20, 5))
    tid = np.where(rng.uniform(size=b) < 0.3, rng.integers(0, 32, b), -1).astype(np.int32)
    det = {"bot_blob_idx": idx, "bot_tracked_id": tid}
    want = np.asarray(JD.estimate_bot_ids({k: jnp.asarray(v) for k, v in det.items()},
                                          jnp.asarray(blob_color), jnp.asarray(colors)))
    got = D.estimate_bot_ids({k: torch.from_numpy(v) for k, v in det.items()},
                             torch.from_numpy(blob_color), torch.from_numpy(colors))
    np.testing.assert_array_equal(got.numpy(), want)

    mask = rng.uniform(size=300) < 0.5
    vals = blob_color.astype(np.int32)
    for contrast in (colors[5], colors[3]):
        jw = JDF.masked_kmeans2(jnp.asarray(contrast), jnp.asarray(vals),
                                jnp.asarray(mask), jnp.asarray(colors[2]),
                                jnp.asarray(colors[3]))
        tw = DF.masked_kmeans2(torch.from_numpy(contrast), torch.from_numpy(vals),
                               torch.from_numpy(mask), torch.from_numpy(colors[2]),
                               torch.from_numpy(colors[3]))
        for a, b_ in zip(tw, jw):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_clipping_nms_parity():
    rng = np.random.default_rng(4)
    n = 64
    pos = rng.uniform(-600, 600, (n, 2)).astype(np.float32)
    orient = rng.uniform(-3, 3, n).astype(np.float32)
    score = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # score ties
    valid = rng.uniform(size=n) < 0.6
    want = np.asarray(JD.clipping_nms(jnp.asarray(pos), jnp.asarray(orient),
                                      jnp.asarray(score), jnp.asarray(valid), 10.0))
    got = D.clipping_nms(torch.from_numpy(pos), torch.from_numpy(orient),
                         torch.from_numpy(score), torch.from_numpy(valid), 10.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax module and nothing
    from the JAX package's directory (its modules, or its protobuf bindings
    under their flat ``ssl_*_pb2`` names)."""
    mods = sorted(
        "vision_processor_tpu_torch." + ".".join(p.relative_to(ROOT / "vision_processor_tpu_torch")
                                                 .with_suffix("").parts)
        for p in (ROOT / "vision_processor_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, os, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "jax = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        f"ref = os.path.join({str(ROOT)!r}, 'vision_processor_tpu') + os.sep\n"
        "ours = sorted(n for n, m in list(sys.modules.items())\n"
        "              if (getattr(m, '__file__', None) or '').startswith(ref))\n"
        "print(jax[:5], ours[:5]); sys.exit(1 if jax or ours else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 35


def test_entry_points_default_to_the_card(monkeypatch):
    """Processor, App and main() run on "cuda" unless the caller passes
    "cpu"; main() does not fall back when no GPU is found."""
    import inspect

    from vision_processor_tpu_torch.app import main as M

    assert inspect.signature(Processor).parameters["device"].default == "cuda"
    assert inspect.signature(M.App).parameters["device"].default == "cuda"
    seen = []

    class FakeApp:
        def __init__(self, config, device):
            seen.append(device)

        def run(self):
            pass

        def stop(self, *_):
            pass

    monkeypatch.setattr(M, "App", FakeApp)
    monkeypatch.setattr(M.signal, "signal", lambda *a: None)
    M.main(["config.yml"])
    M.main(["config.yml", "--device", "cpu"])
    assert seen == ["cuda", "cpu"]


def test_device_path_without_protobuf(rig, tmp_path):
    """With the protobuf bindings unimportable, the port's device path runs
    on its plain geometry and gives the on-device result of the parsed
    proto bit for bit."""
    geometry, model, _, raw = rig
    names = [f.name for f in geometry.field.DESCRIPTOR.fields
             if f.name not in ("field_lines", "field_arcs")]
    field = {n: getattr(geometry.field, n) for n in names if geometry.field.HasField(n)}
    cam = {k: np.asarray(getattr(model, k)).tolist() for k in (
        "focal_length", "principal_point", "distortion_k2", "pos", "quat", "size")}
    np.save(tmp_path / "raw.npy", raw)
    code = (
        "import importlib.abc, sys\n"
        "import numpy as np\n"
        "class NoProtobuf(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[:2] == ['google', 'protobuf']:\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, NoProtobuf())\n"
        "from vision_processor_tpu_torch.app.processor import (\n"
        "    Processor, TrackedArrays, VisionConfig)\n"
        "from vision_processor_tpu_torch.models.camera import CameraModel\n"
        "from vision_processor_tpu_torch.net.geometry_io import (\n"
        "    calibration_from_model, geometry_from_dict)\n"
        "from vision_processor_tpu_torch.utils.state import to_numpy\n"
        f"geometry = geometry_from_dict({{'field': {field!r}}})\n"
        f"geometry.calib = [calibration_from_model(CameraModel(**{cam!r}), 0)]\n"
        "cfg = VisionConfig()\n"
        "cfg.max_blobs, cfg.resampling_factor = 256, 1.25\n"
        "cfg.resample_mode, cfg.device_finish = 'warp', True\n"
        "proc = Processor(cfg, device='cpu')\n"
        f"proc.geometry_check({WIDTH}, {HEIGHT}, geometry, 1)\n"
        f"raw = np.load({str(tmp_path / 'raw.npy')!r})\n"
        "out = proc.device_step(raw, 'RGGB', TrackedArrays.build({}, 0.0, 32))\n"
        f"np.savez({str(tmp_path / 'fin.npz')!r}, **to_numpy(out[2]))\n"
        "sys.exit(any(m.startswith('google.protobuf') for m in sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(tmp_path / "fin.npz")

    tp = Processor(_config("warp", True), device="cpu")
    tp.geometry_check(WIDTH, HEIGHT, geometry, 1)
    want = to_numpy(tp.device_step(raw, "RGGB", TrackedArrays.build({}, 0.0, 32))[2])
    assert sorted(got.files) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert want["bot_valid"].sum() == 2 and want["ball_valid"].sum() == 1


def test_finalize_detections_batched_parity():
    """The camera-batched NMS + ball-clip completion equals the JAX vmap."""
    rng = np.random.default_rng(6)
    n, b, k = 2, 64, 40
    det = {
        "bot_pos": rng.uniform(-600, 600, (n, b, 2)).astype(np.float32),
        "bot_orientation": rng.uniform(-3, 3, (n, b)).astype(np.float32),
        "bot_score": rng.uniform(0, 1, (n, b)).astype(np.float32),
        "bot_valid": rng.uniform(size=(n, b)) < 0.5,
    }
    blob_pos = rng.uniform(-600, 600, (n, k, 2)).astype(np.float32)
    blob_valid = rng.uniform(size=(n, k)) < 0.8
    tol = np.array([10.0, 5.0], np.float32)
    want = JD.finalize_detections_batched(
        {key: jnp.asarray(v) for key, v in det.items()}, jnp.asarray(blob_pos),
        jnp.asarray(blob_valid), jnp.asarray(tol), 21.5)
    got = D.finalize_detections_batched(
        {key: torch.from_numpy(v) for key, v in det.items()},
        torch.from_numpy(blob_pos), torch.from_numpy(blob_valid),
        torch.from_numpy(tol), 21.5)
    for key in ("bot_valid", "ball_clipped"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "warp"])
def test_slice_on_card_matches_cpu(rig, mode, cuda_device):
    """The port on the card (kernels; the fused response) and on the CPU
    (plain versions; the eager response chain, as the JAX package off the
    TPU) emit the same detections on the small camera."""
    geometry, model, scene, raw = rig
    out = {}
    for dev in ("cpu", cuda_device):
        proc = Processor(_config(mode, True), device=dev)
        proc.geometry_check(WIDTH, HEIGHT, geometry, 1)
        tracked = TrackedArrays.build({}, 0.0, 32)
        for frame in range(2):
            wrapper, _, _ = proc.finish_frame(
                proc.device_step(raw, "RGGB", tracked), frame * 0.01)
            tracked = _tracked_from(wrapper, frame * 0.01, TrackedArrays)
        out[str(dev)] = _detections(wrapper)
    c_bots, c_balls = out["cpu"]
    g_bots, g_balls = out[str(cuda_device)]
    assert sorted(g_bots) == sorted(c_bots) == [3, 25]
    for bid, (x, y, w) in c_bots.items():
        gx, gy, gw = g_bots[bid]
        assert abs(gx - x) < 0.5 and abs(gy - y) < 0.5 and abs(gw - w) < 1e-3
    np.testing.assert_allclose(g_balls, c_balls, atol=0.5)
