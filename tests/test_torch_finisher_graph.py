"""The camera-batched finisher as a CUDA graph (``models/device_finish.py
FinisherGraph``): on the CPU the owner is ``finish_on_device_batched``
itself; on the card it captures once an input signature and replays,
bit-equal to the eager call, with the recorder's k-means counts of the
eager call. The card tests build the finisher's inputs at the benchmark
cell's shapes (4 cameras, 2,000 blob slots, 64 bot slots, the Division B
field's marks) from a seed, every value changing from call to call."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vision_processor_tpu_torch.models import detector as D
from vision_processor_tpu_torch.models import device_finish as DF
from vision_processor_tpu_torch.models.camera import CameraModel
from vision_processor_tpu_torch.models.colors import ColorState
from vision_processor_tpu_torch.net.geometry_io import geometry_from_dict
from vision_processor_tpu_torch.parallel import multicam as M
from vision_processor_tpu_torch.utils import timing as T

FIELD = {"field": {
    "field_length": 9000, "field_width": 6000, "goal_width": 1000,
    "goal_depth": 180, "penalty_area_depth": 1000,
    "penalty_area_width": 2000, "boundary_width": 300,
    "center_circle_radius": 500, "line_thickness": 10,
    "ball_radius": 21.5, "max_robot_radius": 90.0,
}}
N_CAMS, N_BLOBS, N_BOTS = 4, 2000, 64


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the finisher's and the loops' modules' place."""
    rec = T.Recorder()
    monkeypatch.setattr(D, "RECORDER", rec)
    monkeypatch.setattr(DF, "RECORDER", rec)
    return rec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def finisher_inputs(seed: int, device, n_cams=N_CAMS, n_blobs=N_BLOBS, n_bots=N_BOTS):
    """The finisher's arguments (blobs, det, colors7, colors7_refs,
    packed_cams, marks, params), every value drawn from ``seed``: blob
    colours near the colour table's rows, so that the k-means split them;
    the Division B cameras and marks moved a little; per-camera tunables."""
    rng = np.random.default_rng(seed)
    field = geometry_from_dict(FIELD).field
    f32 = np.float32

    def colors_near(table, shape):
        rows = rng.integers(0, 7, size=shape)
        return np.clip(np.rint(table[rows] + rng.normal(0, 12, (*shape, 3))), 0, 255)

    tables = np.stack([ColorState().packed() + rng.integers(-6, 7, (7, 3))
                       for _ in range(n_cams)]).astype(f32)
    refs = np.stack([ColorState().packed_refs() for _ in range(n_cams)]).astype(f32)
    packed = []
    for c in range(n_cams):
        model = CameraModel.initial_guess(np.array([1920, 1080]), c, n_cams, 4500.0, field)
        model.pos = model.pos + rng.normal(0, 20, 3)
        packed.append(model.packed())
    valid = rng.random((n_cams, n_blobs)) < 0.6
    blob_idx = rng.integers(0, n_blobs, (n_cams, n_bots, 5))
    blob_idx[rng.random((n_cams, n_bots, 5)) < 0.1] = -1
    tracked = np.where(rng.random((n_cams, n_bots)) < 0.2,
                       rng.integers(0, 32, (n_cams, n_bots)), -1)
    blobs = {
        "field_pos": rng.uniform([-4800, -3300], [4800, 3300], (n_cams, n_blobs, 2)),
        "color": np.stack([colors_near(t, (n_blobs,)) for t in tables]),
        "center": np.stack([colors_near(t, (n_blobs,)) for t in tables]),
        "circ": rng.uniform(0, 60, (n_cams, n_blobs)),
        "score": rng.uniform(0, 40, (n_cams, n_blobs)),
        "valid": valid,
        "count": valid.sum(axis=1).astype(np.int32),
    }
    det = {
        "bot_pos": rng.uniform([-4500, -3000], [4500, 3000], (n_cams, n_bots, 2)),
        "bot_orientation": rng.uniform(-np.pi, np.pi, (n_cams, n_bots)),
        "bot_score": rng.uniform(0, 1, (n_cams, n_bots)),
        "bot_blob_idx": blob_idx.astype(np.int32),
        "bot_tracked_id": tracked.astype(np.int32),
        "bot_valid": rng.random((n_cams, n_bots)) < 0.5,
        "ball_clipped": rng.random((n_cams, n_blobs)) < 0.1,
        "bot_id_est": rng.integers(0, 32, (n_cams, n_bots)).astype(np.int32),
    }
    marks = [DF.pack_field_marks(field, float(rng.uniform(5, 40))) for _ in range(n_cams)]
    params = {
        "max_bot_height": f32(rng.uniform(140, 160)),
        "ball_radius": f32(rng.uniform(20, 23)),
        "reference_force": rng.uniform(0.05, 0.2, n_cams),
        "history_force": rng.uniform(0.5, 0.8, n_cams),
        "min_confidence": rng.uniform(0.1, 0.4, n_cams),
        "min_score": rng.uniform(2, 8, n_cams),
        "min_cam_edge_distance": rng.uniform(100, 250, n_cams),
        "bot_heights_yb": rng.uniform(140, 150, 2),
    }

    def t(a):
        a = np.asarray(a)
        a = a.astype(f32) if a.dtype == np.float64 else a
        return torch.as_tensor(a, device=device)

    return (
        {k: t(v) for k, v in blobs.items()},
        {k: t(v) for k, v in det.items()},
        t(tables), t(refs), t(np.stack(packed)),
        {k: t(np.stack([m[k] for m in marks])) for k in marks[0]},
        {k: t(v) for k, v in DF.stack_finish_params(
            {k: np.asarray(v, dtype=f32) for k, v in params.items()}, n_cams).items()},
    )


def assert_bit_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w.isnan()), k
            g, w = torch.where(g.isnan(), 0.0, g), torch.where(w.isnan(), 0.0, w)
        assert torch.equal(g, w), k


def _counts(rec) -> dict:
    out = {}
    for c in rec.drain()["counts"]:
        out[c.name] = out.get(c.name, 0) + c.value
    return out


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "on", "device"])
def test_owner_on_cpu_is_the_eager_finisher(recorder, mode):
    """On CPU tensors the owner returns exactly what the eager finisher
    returns, captures nothing and counts ``finisher.eager``."""
    if mode != "off":
        recorder.enable(device_counting=mode == "device")
    args = finisher_inputs(1, "cpu", n_cams=2, n_blobs=96, n_bots=12)
    want = DF.finish_on_device_batched(*args)
    recorder.drain()
    owner = DF.FinisherGraph()
    for _ in range(2):
        assert_bit_equal(owner(*args), want)
    assert (owner.captures, owner.replays, owner.eager) == (0, 0, 2)
    counts = _counts(recorder)
    if mode == "off":
        assert counts == {}
    else:
        assert counts["finisher.eager"] == 2
        assert "finisher.graph.replay" not in counts
        assert counts["kmeans.rounds"] == 2 * 3 * 2 * 24


def _args(shape_blobs=96, dtype=torch.float32, device="cpu", fill=0.0):
    blobs = {"color": torch.full((2, shape_blobs, 3), fill, dtype=dtype, device=device),
             "valid": torch.zeros((2, shape_blobs), dtype=torch.bool, device=device)}
    det = {"bot_pos": torch.full((2, 12, 2), fill, device=device)}
    return (blobs, det, torch.full((2, 7, 3), fill, device=device))


@pytest.mark.parametrize("change", ["shape", "dtype", "device", "recorder_on",
                                    "device_counting", "key"])
def test_signature_tells_inputs_apart(recorder, change):
    """Equal shapes, dtypes, devices and recorder mode give equal keys (for
    other tensors with other values); each difference gives another key."""
    key = DF.finish_signature(_args())
    assert DF.finish_signature(_args(fill=3.0)) == key
    assert hash(DF.finish_signature(_args(fill=3.0))) == hash(key)
    if change == "shape":
        other = DF.finish_signature(_args(shape_blobs=97))
    elif change == "dtype":
        other = DF.finish_signature(_args(dtype=torch.float64))
    elif change == "device":
        other = DF.finish_signature(_args(device="meta"))
    elif change == "key":
        a = _args()
        a[1]["bot_score"] = a[1].pop("bot_pos")
        other = DF.finish_signature(a)
    else:
        recorder.enable(device_counting=change == "device_counting")
        other = DF.finish_signature(_args())
    assert other != key


def test_collected_rounds_replay_as_counted(recorder):
    """A loop's rounds logged by ``collect_rounds`` record nothing then, and
    ``replay_rounds`` records what the loop would have."""
    recorder.enable(device_counting=True)
    vals = torch.tensor([[0, 0, 0], [1, 1, 1], [50, 50, 50], [51, 51, 51]] * 2,
                        dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    contrast = torch.tensor([200, 200, 200])
    c1, c2 = torch.tensor([0, 0, 0]), torch.tensor([50, 50, 50])
    recorder.begin_frame_set()
    eager = DF.masked_kmeans2(contrast, vals, mask, c1, c2)
    recorder.reduce_rounds()
    recorder.read_rounds(recorder.frame_set)
    want = _counts(recorder)
    assert want == {"kmeans.rounds": 24, "kmeans.live_rounds": 1}
    recorder.begin_frame_set()
    with recorder.collect_rounds() as log:
        got = DF.masked_kmeans2(contrast, vals, mask, c1, c2)
    recorder.reduce_rounds()
    recorder.read_rounds(recorder.frame_set)
    assert _counts(recorder) == {} and len(log) == 1
    recorder.replay_rounds(log)
    recorder.reduce_rounds()
    recorder.read_rounds(recorder.frame_set)
    assert _counts(recorder) == want
    for g, w in zip(got, eager):
        assert torch.equal(g, w)


def test_each_step_owns_its_finisher():
    """Every step factory that reaches the finisher builds its own owner, so
    a rebuilt step starts without graphs."""
    cfg = M.MultiCamConfig(bm=None, det=None, n_cams=2)
    owners = [M.batched_step(cfg).finisher, M.batched_step(cfg).finisher,
              M.batched_step_host_tracked(cfg).finisher,
              M.staggered_tail_step(cfg).finisher]
    assert all(isinstance(o, DF.FinisherGraph) for o in owners)
    assert len({id(o) for o in owners}) == len(owners)


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_graph_bit_equal_over_changing_inputs(cuda_device):
    """Eight successive calls, every input changing (params, per-camera
    tunables and the marks' values included): the replayed outputs are the
    eager ones bit for bit, and call k's outputs survive call k + 1."""
    owner = DF.FinisherGraph()
    kept = []
    for k in range(8):
        args = finisher_inputs(100 + k, cuda_device)
        want = DF.finish_on_device_batched(*args)
        got = owner(*args)
        assert_bit_equal(got, want)
        kept.append((got, {n: v.clone() for n, v in want.items()}))
        if k:
            assert_bit_equal(*kept[k - 1])
    assert (owner.captures, owner.replays, owner.eager) == (1, 8, 0)
    # a changed shape captures a second graph and replays it
    for k in range(2):
        args = finisher_inputs(200 + k, cuda_device, n_blobs=1000)
        assert_bit_equal(owner(*args), DF.finish_on_device_batched(*args))
    assert (owner.captures, owner.replays, owner.eager) == (2, 10, 0)
    args = finisher_inputs(300, cuda_device)
    assert_bit_equal(owner(*args), DF.finish_on_device_batched(*args))
    assert (owner.captures, owner.replays) == (2, 11)


def _frame_set(rec, fn, args):
    """One frame-set of ``fn`` as the app runs it, and its counts."""
    rec.begin_frame_set()
    out = fn(*args)
    rec.reduce_rounds()
    torch.cuda.synchronize()
    rec.read_rounds(rec.frame_set)
    return out, _counts(rec)


@pytest.mark.cuda
@pytest.mark.parametrize("device_counting", [False, True])
def test_graph_counts_the_eager_rounds(recorder, cuda_device, device_counting):
    """With the recorder on (and device counting), every replayed frame-set
    records the eager call's ``kmeans.rounds`` (12 calls of 24 rounds) and
    ``kmeans.live_rounds``; the capture's own runs record none."""
    recorder.enable(device_counting=device_counting)
    owner = DF.FinisherGraph()
    for k in range(3):
        args = finisher_inputs(400 + k, cuda_device)
        want, want_counts = _frame_set(recorder, DF.finish_on_device_batched, args)
        got, got_counts = _frame_set(recorder, owner, args)
        assert_bit_equal(got, want)
        assert want_counts["kmeans.rounds"] == 12 * 24
        if device_counting:
            assert want_counts["kmeans.live_rounds"] > 0
        else:
            assert "kmeans.live_rounds" not in want_counts
        assert got_counts.pop("finisher.graph.replay") == 1
        assert got_counts.pop("finisher.graph.capture", 0) == (k == 0)
        assert got_counts == want_counts
    assert (owner.captures, owner.replays, owner.eager) == (1, 3, 0)


def _offline_fleet_run(device, pipeline: str, monkeypatch, eager: bool, n_sets: int = 6):
    """Two cameras (960x720 models over the field halves, a robot each, the
    ball before camera 0) through the offline ``MultiCamApp`` for
    ``n_sets`` frame-sets; returns the serialized wrappers and the app."""
    from vision_processor_tpu_torch.app.multicam_app import MultiCamApp
    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, SceneBot, render_raw
    from vision_processor_tpu_torch.net.geometry_io import calibration_from_model
    from vision_processor_tpu_torch.utils.config import VisionConfig

    monkeypatch.setenv("VPTPU_PIPELINE", pipeline)
    monkeypatch.delenv("VPTPU_STAGGERED", raising=False)
    if eager:
        monkeypatch.setattr(M, "FinisherGraph", lambda: DF.finish_on_device_batched)
    geometry = geometry_from_dict(FIELD)
    models = [CameraModel.initial_guess(np.array([960, 720]), c, 2, 4500.0, geometry.field)
              for c in range(2)]
    geometry.calib = [calibration_from_model(m, c) for c, m in enumerate(models)]
    x0, x1 = float(models[0].pos[0]), float(models[1].pos[0])
    scenes = [
        Scene(bots=[SceneBot(3, "blue", x0, -500.0, 1.2)],
              balls=[SceneBall(x0 + 400.0, 300.0)], noise_sigma=1.0),
        Scene(bots=[SceneBot(9, "yellow", x1, 600.0, -0.7)], balls=[], noise_sigma=1.0),
    ]
    frames = [RawFrame(data=render_raw(m, geometry.field, s, "RGGB"), fmt="RGGB",
                       width=960, height=720) for m, s in zip(models, scenes)]
    configs = []
    for c in range(2):
        cfg = VisionConfig()
        cfg.cam_id, cfg.max_blobs, cfg.stream_active = c, 128, False
        configs.append(cfg)
    app = MultiCamApp.offline(configs, device=device)
    for proc in app.processors:
        proc.geometry_check(960, 720, geometry, 1)
    wires = []
    for k in range(n_sets + 1):
        now = 0.01 * k
        if k < n_sets:
            _, wrappers = app.step_frames(frames, now, TrackedArrays.build({}, now, 32))
        else:
            wrappers = app._finish_pending()
        if wrappers is not None:
            wires.append([w.SerializePartialToString(deterministic=True) for w in wrappers])
    app.close()
    return wires, app, SimpleNamespace(frames=frames)


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_fleet_on_cpu_runs_the_finisher_eagerly(monkeypatch, pipeline):
    """The fleet's step (pipelined: the host-tracked step; frame-serial:
    the staggered tail) on the CPU calls the eager finisher every
    frame-set."""
    wires, app, _ = _offline_fleet_run("cpu", pipeline, monkeypatch, eager=False,
                                       n_sets=2)
    assert len(wires) == 2
    owner = (app._step if pipeline == "1" else app._tail_step).finisher
    assert (owner.captures, owner.replays, owner.eager) == (0, 0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_fleet_on_card_sends_the_eager_wire(monkeypatch, cuda_device, pipeline):
    """A short offline ``MultiCamApp`` run on the card gives the same wire
    frames whether its step's finisher replays or is forced eager."""
    graph_wires, app, _ = _offline_fleet_run(cuda_device, pipeline, monkeypatch,
                                             eager=False)
    owner = (app._step if pipeline == "1" else app._tail_step).finisher
    assert (owner.captures, owner.replays, owner.eager) == (1, 6, 0)
    eager_wires, _, _ = _offline_fleet_run(cuda_device, pipeline, monkeypatch, eager=True)
    assert len(graph_wires) == len(eager_wires) == 6
    assert graph_wires == eager_wires
