"""The port's headline bench (vision_processor_tpu_torch/bench.py) and its
dense-scene oracle (vision_processor_tpu_torch/dense_oracle.py) against
bench.py and python/dense_oracle.py, on the CPU at small sizes: the rigs,
the oracle, ``bot_recall`` and ``main``. The measurements that run the
JAX step are in tests/test_torch_bench_dense.py.

The rigs: 2 cameras of 480x270 models, max_blobs 600 (300 in ``main``),
dense with 40 extra blobs a camera (20 in ``main``), both resample modes.
Tolerances: raws, counts and the oracle's anchors equal; packed models,
scales and offsets within 1e-6; the oracle's positions and scores within
1e-9 (both are float64 numpy of the same expressions).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "python"))
sys.path.insert(0, str(REPO))

import bench as JB  # noqa: E402
import dense_oracle as JO  # noqa: E402

from test_dense_parity import build_scene  # noqa: E402

from vision_processor_tpu_torch import bench as PB  # noqa: E402
from vision_processor_tpu_torch import dense_oracle as PO  # noqa: E402

SMALL = dict(n_cams=2, max_blobs=600, width=480, height=270)
DENSE = dict(dense=True, dense_blobs=40, return_scenes=True)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene_tuple(scene):
    return ([(b.bot_id, b.team, b.x, b.y, b.orientation, b.height) for b in scene.bots],
            [(b.x, b.y, b.radius) for b in scene.balls], scene.noise_sigma, scene.seed)


# (a) -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["warp", "gather"])
@pytest.mark.parametrize("dense", [False, True])
def test_build_rig_equals_bench(mode, dense):
    kw = dict(SMALL, resampling_factor=1.25, resample_mode=mode, return_scenes=True)
    if dense:
        kw.update(DENSE)
    j = JB.build_rig(**kw)
    p = PB.build_rig(**kw, device=CPU)
    assert np.array_equal(j[1], p[1]) and j[1].dtype == p[1].dtype
    for a, b in zip(j[2:6], p[2:6]):  # packed, scales, offsets, colors
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=0, atol=1e-6)
    assert set(j[6]) == set(p[6])
    for k, v in j[6].items():
        assert p[6][k].device == CPU and p[6][k].dtype == torch.float32
        assert np.array_equal(np.asarray(v), p[6][k].numpy()), k
    jc, pc = j[0], p[0]
    for f in ("fmt", "raw_shape", "flat_shape", "field_scale", "field_offset",
              "grad_offset", "sat_radius", "disc_radius", "max_blobs", "resample_mode"):
        assert getattr(jc.bm, f) == getattr(pc.bm, f), f
    for f in ("max_blobs", "max_tracked", "max_anchors", "max_anchors_tier"):
        assert getattr(jc.det, f) == getattr(pc.det, f), f
    assert jc.n_cams == pc.n_cams
    assert [_scene_tuple(s) for s in j[9]] == [_scene_tuple(s) for s in p[9]]
    if dense:
        assert all(len(s.balls) == 41 for s in p[9])


def test_dense_factor1_reuses_the_factor125_raws():
    """bench.py's dense raws do not depend on the resampling factor, so the
    port's factor-1.0 rig takes the factor-1.25 raws: its raws, scenes and
    camera inputs equal bench.py's factor-1.0 rig."""
    kw = dict(SMALL, **DENSE, resample_mode="gather")
    j125 = JB.build_rig(**kw, resampling_factor=1.25)
    j1 = JB.build_rig(**kw, resampling_factor=1.0)
    assert np.array_equal(j125[1], j1[1])
    p1 = PB.build_rig(**kw, resampling_factor=1.0, device=CPU, raws=j125[1])
    assert np.array_equal(p1[1], j1[1])
    assert [_scene_tuple(s) for s in p1[9]] == [_scene_tuple(s) for s in j1[9]]
    for a, b in zip(j1[2:5], p1[2:5]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert p1[0].bm.flat_shape == j1[0].bm.flat_shape
    with pytest.raises(ValueError):
        PB.build_rig(**dict(kw, n_cams=1), resampling_factor=1.0, device=CPU,
                     raws=j125[1])


# (b) -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 31, 77])
def test_oracle_equals_python_oracle(seed):
    rng = np.random.default_rng(seed)
    _, pos, _, valid, _, _ = build_scene(rng, n_bots=4, n_spurious=300)
    valid = valid.copy()
    valid[rng.uniform(size=len(valid)) < 0.1] = False  # some invalid slots
    args = (pos, valid, 90.0)
    for jt, pt in zip(JO.best_hypotheses(*args), PO.best_hypotheses(*args)):
        assert jt.shape == pt.shape
        np.testing.assert_allclose(pt, jt, rtol=0, atol=1e-9)
    je = JO.emit_bots(pos, valid, 90.0, 0.2, 10.0)
    pe = PO.emit_bots(pos, valid, 90.0, 0.2, 10.0)
    assert je["n_hypotheses"] == pe["n_hypotheses"] > 0
    assert np.array_equal(je["anchor"], pe["anchor"]) and len(pe["pos"]) > 0
    for k in ("score", "orientation", "pos", "all_pos", "all_score"):
        assert je[k].shape == pe[k].shape
        np.testing.assert_allclose(pe[k], je[k], rtol=0, atol=1e-9)
    other = pe["pos"] + rng.normal(0, 8.0, pe["pos"].shape)
    for tol in (5.0, 20.0):
        assert JO.match_sets(je["pos"], other, tol) == PO.match_sets(pe["pos"], other, tol)
    assert PO.match_sets(np.zeros((0, 2)), other) == 0


# (c) -----------------------------------------------------------------------


def test_bot_recall_equals_bench():
    """One compact (2 frame-sets x 2 cameras x 16 slots), some slots on the
    planted robots within and beyond 40 mm, some invalid."""
    rig = PB.build_rig(**SMALL, return_scenes=True, resample_mode="gather", device=CPU)
    scenes = rig[9]
    rng = np.random.default_rng(5)
    pos = rng.uniform(-4000, 4000, (2, 2, 16, 2)).astype(np.float32)
    valid = rng.uniform(size=(2, 2, 16)) < 0.5
    for c, s in enumerate(scenes):
        for i, b in enumerate(s.bots):
            pos[-1, c, i] = (b.x + (10.0 if i < 3 else 45.0), b.y)
            valid[-1, c, i] = i != 1
    want = JB.bot_recall({"bot_valid": valid, "bot_pos": pos}, scenes)
    got = PB.bot_recall({"bot_valid": torch.from_numpy(valid),
                         "bot_pos": torch.from_numpy(pos)}, scenes)
    assert got == want == (4, 8)


# (g) -----------------------------------------------------------------------

DETAIL_KEYS = {
    "resample_mode", "resampling_factor", "factor_qualification", "card", "device",
    "rounds", "frames_per_round", "ms_per_4cam_frameset_device_sustained", "ms_band",
    "ms_band_inner", "device_busy_share", "device_busy_share_dense",
    "ms_per_4cam_frameset_device_sustained_factor1", "fps_pipelined_factor1",
    "fps_band_rounds_factor1", "fps_band_rounds_factor1_inner", "bots_found_factor1",
    "ms_per_4cam_frameset_device_sustained_dense",
    "ms_per_4cam_frameset_device_sustained_dense_factor1", "dense_bot_recall_factor1",
    "ms_host_finishing_per_frameset", "ms_host_finishing_single_camera",
    "ms_upload_per_frameset_pinned", "h2d_gbps_pinned", "upload_overlap_fraction_measured",
    "upload_overlap_fraction_control", "ms_upload_effective_after_measured_overlap",
    "p50_ms_serial", "p95_ms_serial",
    "p50_ms_pipelined", "p95_ms_pipelined", "fps_serial", "fps_device_only",
    "ms_percam_core", "ms_staggered_tail", "ms_staggered_device_total",
    "p50_frame_latency_ms_serial_staggered_derived", "staggered_budget_ok",
    "p50_ms_per_camera_process_derived", "bots_found_4cams", "blob_counts",
    "bots_found_dense", "blob_counts_dense", "dense_bot_recall", "dense_recall_ok",
    "dense_bots_device_untracked", "dense_bots_oracle", "dense_oracle_hypotheses",
    "dense_bot_precision", "dense_oracle_precision", "dense_planted_recall_untracked",
    "dense_oracle_agreement", "dense_device_to_oracle_ratio", "dense_bots_device_veto",
    "dense_bot_precision_veto", "dense_planted_recall_veto", "fps_band_rounds",
    "fps_band_rounds_inner", "fps_band_recent_runs", "n_recent_runs", "max_blobs",
    "detector_anchors",
} | {k + s for s in ("", "_veto") for k in (
    "dense_tracked_frames", "dense_precision_tracked_t20", "dense_recall_tracked_t20",
    "dense_noise_first_frame", "dense_noise_last_frame", "dense_noise_mean_per_frame",
    "dense_noise_locked_tracks_final", "dense_noise_persist_fraction")}
# measured by CUDA events or derived from them: null on the CPU
DEVICE_KEYS = {
    "card", "ms_per_4cam_frameset_device_sustained", "ms_band", "ms_band_inner",
    "device_busy_share", "device_busy_share_dense",
    "ms_per_4cam_frameset_device_sustained_factor1", "fps_pipelined_factor1",
    "fps_band_rounds_factor1", "fps_band_rounds_factor1_inner",
    "ms_per_4cam_frameset_device_sustained_dense",
    "ms_per_4cam_frameset_device_sustained_dense_factor1",
    "ms_upload_per_frameset_pinned", "h2d_gbps_pinned", "upload_overlap_fraction_measured",
    "upload_overlap_fraction_control", "ms_upload_effective_after_measured_overlap",
    "fps_device_only", "ms_percam_core",
    "ms_staggered_tail", "ms_staggered_device_total",
    "p50_frame_latency_ms_serial_staggered_derived", "staggered_budget_ok",
    "p50_ms_per_camera_process_derived", "fps_band_rounds", "fps_band_rounds_inner",
}


@pytest.mark.parametrize("mode", ["warp", "gather"])
def test_main_prints_one_json_line(mode, tmp_path, capsys, monkeypatch):
    history = REPO / "BENCH_HISTORY.jsonl"
    before = history.read_bytes()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    kw = dict(resample_mode=mode, device="cpu", out=str(out), rounds=1, frames=2,
              n_cams=2, width=480, height=270, max_blobs=300, dense_blobs=20,
              production_frames=2, tracked_frames=2)
    result = PB.main(**kw)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert set(result) == {"metric", "value", "unit", "detail"}
    assert result["unit"] == "fps" and result["value"] > 0
    detail = result["detail"]
    assert set(detail) == DETAIL_KEYS
    assert not [k for k in detail if any(w in k for w in ("relay", "corrected", "4GBps",
                                                          "baseline", "note"))]
    assert all(detail[k] is None for k in DEVICE_KEYS)
    assert detail["resample_mode"] == mode and detail["device"] == "cpu"
    assert detail["n_recent_runs"] == 1
    assert result["value"] == pytest.approx(2 / (detail["p50_ms_pipelined"] / 1e3), rel=0.01)
    assert len(detail["blob_counts_dense"]) == 2
    assert history.read_bytes() == before
    # the bench wrote only under --out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert [json.loads(s)["fps"] for s in (out / "history.jsonl").read_text().splitlines()
            ] == [result["value"]]


def test_main_refuses_cuda_without_a_card(tmp_path):
    """No fallback: asked for the card where torch reaches none, the bench
    raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PB.main(device="cuda", out=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_console_script_names_the_bench():
    import tomllib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["vptpu-torch-bench"] == "vision_processor_tpu_torch.bench:cli"


def test_rigs_reuse_their_renders(monkeypatch):
    """build_rigs renders each scene set once: the factor-1.0 rigs take the
    factor-1.25 raws, and a second set of rigs (the other resample mode)
    takes the first's."""
    from vision_processor_tpu_torch.io import synthetic

    calls = []
    render = synthetic.render_raw
    monkeypatch.setattr(synthetic, "render_raw",
                        lambda *a, **k: calls.append(1) or render(*a, **k))
    kw = dict(n_cams=2, width=480, height=270, max_blobs=300, dense_blobs=5)
    warp = PB.build_rigs("warp", CPU, **kw)
    assert len(calls) == 4 and set(warp) == {"plain", "factor1", "dense", "dense_factor1"}
    gather = PB.build_rigs("gather", CPU, **kw,
                           raws={k: warp[k][1] for k in ("plain", "dense")})
    assert len(calls) == 4
    for k in warp:
        assert np.array_equal(warp[k][1], gather[k][1])
        assert gather[k][0].bm.resample_mode == "gather"
    assert warp["factor1"][0].bm.flat_shape != warp["plain"][0].bm.flat_shape
