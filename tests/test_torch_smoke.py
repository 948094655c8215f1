"""chip_smoke.py's loader of another checkout (``--before DIR``), on the CPU.

The smoke times B2-B6 and E5 of another checkout through that checkout's own
package, imported under another name. Here the checkout is this one: its
package, loaded so, must be a second copy (its own modules and launch
counts) whose B2-B6 and E5 give what this package's give, bit for bit.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_processor_tpu_torch.ops import blob_fused as BF
from vision_processor_tpu_torch.ops import combo_fused as CF
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import topk as T

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_before_kernels_are_a_second_copy(smoke):
    before = smoke.before_kernels(ROOT)
    assert before["root"] == str(ROOT)
    assert before["cuda"] is not cuda and before["cuda"].LAUNCHES is not cuda.LAUNCHES
    assert before["B2"] is not BF.blob_response_fused
    assert before["B2"].__module__ == "vptpu_before.ops.blob_fused"

    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.uniform(0, 255, (37, 61, 3)).astype(np.float32))
    got = before["B2"](flat, 50.0, 1, 4, 3)
    want = BF.blob_response_fused(flat, 50.0, 1, 4, 3)
    for a, b in zip((got[0], got[1], *got[2], got[3]), (want[0], want[1], *want[2], want[3])):
        assert torch.equal(a, b)
    assert torch.equal(before["B5"](flat, 2, 5), BF.circularity_fused(flat, 2, 5))


def test_before_topk_kernels_are_a_second_copy(smoke):
    before = smoke.before_kernels(ROOT)
    assert before["B3"] is not T.row_topk and before["B4"] is not T.query_select_topk
    assert before["B3"].__module__ == before["B4"].__module__ == "vptpu_before.ops.topk"

    rng = np.random.default_rng(6)
    x = rng.normal(size=(12, 50)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.8] = -np.inf
    x = torch.from_numpy(x)
    for a, b in zip(before["B3"](x, 6), T.row_topk(x, 6)):
        assert torch.equal(a, b)
    qxy = torch.from_numpy(rng.uniform(-100, 100, (7, 2)).astype(np.float32))
    bxy = torch.from_numpy(rng.uniform(-100, 100, (40, 2)).astype(np.float32))
    r2 = torch.full((7,), 2500.0)
    rank = torch.from_numpy(rng.uniform(0, 5, 40).astype(np.float32))
    for by_rank in (True, False):
        got = before["B4"](qxy, r2, bxy, rank, m=4, by_rank=by_rank)
        want = T.query_select_topk(qxy, r2, bxy, rank, m=4, by_rank=by_rank)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_before_b6_e5_are_a_second_copy(smoke):
    before = smoke.before_kernels(ROOT)
    assert before["B6"] is not CF.combo_chain and before["E5"] is not T.row_topk_blk
    assert before["B6"].__module__ == "vptpu_before.ops.combo_fused"
    assert before["E5"].__module__ == "vptpu_before.ops.topk"

    rng = np.random.default_rng(7)
    a, c = 9, 40
    maps = torch.from_numpy(rng.normal(0, 50, (12, a, c)).astype(np.float32))
    pos = torch.from_numpy(rng.normal(0, 500, (a, 2)).astype(np.float32))
    rc = torch.from_numpy(rng.integers(0, 9, a).astype(np.int32))
    valid = torch.from_numpy(rng.random(a) > 0.3)
    cmax = torch.from_numpy(rng.integers(0, 8, c).astype(np.int32))
    pat = rng.normal(0, 50, (5, 2)).astype(np.float32)
    args = (maps, pos, rc, valid, cmax, pat, pat.sum(axis=0))
    assert all(torch.equal(a, b) for a, b in zip(before["B6"](*args), CF.combo_chain(*args)))
    x = rng.normal(size=(12, 50)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.8] = -np.inf
    x = torch.from_numpy(x)
    for a, b in zip(before["E5"](x, 6, 8), T.row_topk_blk(x, 6, 8)):
        assert torch.equal(a, b)


def test_before_e1_is_a_second_copy(smoke):
    """E1 comes as the other checkout's bare launch (no window check), which
    takes CUDA tensors only."""
    from vision_processor_tpu_torch.ops import band_warp as BW

    before = smoke.before_kernels(ROOT)
    assert before["E1"] is not BW._launch
    assert before["E1"].__module__ == "vptpu_before.ops.band_warp"
    assert before["E1"].__name__ == "_launch"
    with pytest.raises(ValueError, match="CUDA"):
        before["E1"](torch.zeros(1, 8, 128), torch.zeros(1, 8, 128),
                     torch.zeros(1, 1, dtype=torch.int32), 2)


def test_counting_runner_passes_argv_and_writes_the_counts(smoke, tmp_path):
    """The processes phase's runner runs a launcher as ``__main__`` with the
    arguments after its own two, keeps the launcher's exit code and writes
    the child's launch counts (every kernel's, 0 here) when it exits."""
    import json
    import subprocess
    import sys

    runner, counts = tmp_path / "runner.py", tmp_path / "counts.json"
    runner.write_text(smoke.COUNTING_RUNNER)
    launcher = smoke.LAUNCHER_DIR / "vision_processor.py"
    proc = subprocess.run([sys.executable, str(runner), str(launcher), str(counts), "--help"],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
    assert json.loads(counts.read_text()) == {name: 0 for name in cuda.LAUNCHES}
    proc = subprocess.run([sys.executable, str(runner), str(launcher), str(counts), "--bad"],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 2 and "--bad" in proc.stderr


def test_soak_scenes_loop_with_clutter_in_the_dense_entries(smoke):
    """The soak's bank (``soak_scenes`` over the bench's dense rig, not
    rendered): each camera's robots and ball move by SOAK_RADIUS mm on one
    loop of SOAK_BANK entries; only the SOAK_DENSE entries hold clutter,
    SOAK_CLEAR mm or more from every robot; the ball as well."""
    import math

    from vision_processor_tpu_torch.bench import build_rig

    rig = build_rig(smoke.N_CAMS, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((smoke.N_CAMS, 1080, 1920), np.uint8),
                    device="cpu")
    scenes = smoke.soak_scenes(rig[8], rig[9])
    assert len(scenes) == smoke.N_CAMS
    for base, bank in zip(rig[9], scenes):
        assert len(bank) == smoke.SOAK_BANK
        for k, scene in enumerate(bank):
            a = 2 * math.pi * k / smoke.SOAK_BANK
            step = smoke.SOAK_RADIUS * np.array([math.cos(a), math.sin(a)])
            for bot, first in zip(scene.bots, bank[0].bots):
                assert np.allclose([bot.x - first.x, bot.y - first.y],
                                   step - [smoke.SOAK_RADIUS, 0.0], atol=1e-6)
                assert bot.orientation == pytest.approx(first.orientation + a)
            ball = scene.balls[0]
            assert np.allclose([ball.x - base.balls[0].x, ball.y - base.balls[0].y], step)
            clutter = scene.balls[1:]
            assert bool(clutter) == (k in smoke.SOAK_DENSE)
            assert len(clutter) > 1500 or not clutter
            for s in scene.balls:
                assert min(math.hypot(s.x - b.x, s.y - b.y)
                           for b in scene.bots) >= smoke.SOAK_CLEAR


def test_jax_soak_found_reads_the_last_pass_for_every_later_one(smoke):
    found = smoke.JAX_SOAK_FOUND
    assert sorted(found) == list(range(smoke.N_CAMS))
    for c, by in found.items():
        for passes in by.values():
            assert passes and all(len(p) == smoke.SOAK_BANK and set(p) <= {"0", "1"}
                                  for p in passes)
        for number in (1, smoke.SOAK_BANK, smoke.SOAK_BANK + 1, 10_000):
            k, loop = (number - 1) % smoke.SOAK_BANK, (number - 1) // smoke.SOAK_BANK
            got = smoke.jax_soak_found(c, number)
            for key, passes in by.items():
                assert got[key] == (passes[min(loop, len(passes) - 1)][k] == "1")


def test_soak_found_counts_against_the_jax_package(smoke):
    """Camera 0's first pass: the JAX package names every robot but in
    dense entry 5 and finds the ball in entries 0-5, 7 and 9. A port that
    does the same in every frame agrees everywhere; one that misses the
    ball in entry 0 and names every robot in entry 5 falls short once
    and disagrees twice."""
    bank = smoke.SOAK_BANK
    want = smoke.JAX_SOAK_FOUND[0]

    def frame(number, ids, ball):
        k = (number - 1) % bank
        errs = [5.0] * 3 + [5.0 if ids else float("inf")]
        return (number, k, errs, [5.0] * 4, 5.0 if ball else float("inf"), 4, 1)

    same = [frame(n, want["ids"][0][n - 1] == "1", want["ball"][0][n - 1] == "1")
            for n in range(1, bank + 1)]
    got = smoke.soak_found(0, same)
    assert got == {"frames": bank, "robots": bank, "jax_ids": 10, "ids": 10,
                   "ids_agree": bank, "jax_ball": 8, "ball": 8, "ball_agree": bank}
    other = list(same)
    other[0] = frame(1, True, False)
    other[5] = frame(6, True, True)
    got = smoke.soak_found(0, other)
    assert (got["ids"], got["ids_agree"], got["ball"], got["ball_agree"]) == (10, 11, 7, 11)


def test_perturbation_is_perturb_frame_without_its_jpeg(smoke):
    """The smoke's numpy perturbation against python/perturb.py
    ``perturb_frame``'s steps before its JPEG step (cv2's blur, float32),
    on one 960x720 frame for every profile: within one u8 level."""
    import importlib.util

    import cv2

    spec = importlib.util.spec_from_file_location("perturb_under_test",
                                                  ROOT / "python" / "perturb.py")
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)
    assert smoke.perturb_profiles() == P.PROFILES
    rgb = np.random.default_rng(3).integers(0, 256, (720, 960, 3)).astype(np.uint8)
    for name, p in P.PROFILES.items():
        got = smoke.perturb_rgb(rgb, p, np.random.default_rng(5))
        img = cv2.GaussianBlur(rgb[..., ::-1].astype(np.float32), (0, 0), p["blur"])
        img *= P._vignette_mask(720, 960, p["vignette"])
        img *= np.asarray(p["wb"], dtype=np.float32)
        img += np.random.default_rng(5).normal(0.0, p["noise"], img.shape).astype(np.float32)
        want = np.clip(img, 0, 255).astype(np.uint8)[..., ::-1]
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert got.dtype == np.uint8 and got.shape == rgb.shape
        assert int(diff.max()) <= 1, name
        assert float((diff > 0).mean()) < 1e-3, name
        taps = smoke.gaussian_taps(p["blur"])
        assert len(taps) == (int(round(p["blur"] * 8 + 1)) | 1)
        assert np.all(taps * 2.0 ** smoke.PERTURB_TAP_BITS == np.round(
            taps * 2.0 ** smoke.PERTURB_TAP_BITS))


def test_perturbed_raws_have_one_digest_a_seed(smoke):
    """The same seed gives the same raws twice (the digest the witness and
    the card compare); another seed another digest."""
    import hashlib

    p = smoke.perturb_profiles()["medium"]
    rgb = np.random.default_rng(9).integers(0, 256, (120, 160, 3)).astype(np.uint8)

    def digest(seed):
        from vision_processor_tpu_torch.io.synthetic import rgb_to_bayer

        rng = np.random.default_rng(seed)
        raw = rgb_to_bayer(smoke.perturb_rgb(rgb, p, rng), "RGGB")
        return hashlib.sha256(raw.tobytes()).hexdigest()

    seed = smoke.perturb_seed("medium", 2, 5)
    assert digest(seed) == digest(list(seed))
    assert digest(seed) != digest(smoke.perturb_seed("medium", 2, 4))


def test_soak_found_takes_the_replayed_outcome(smoke):
    """A frame whose outcome differs from the JAX package's on the previous
    frame's prior agrees where the port's replay from the card's
    dispatched inputs gives the card's outcome, and only there."""
    want = smoke.JAX_SOAK_FOUND[0]
    assert want["ids"][0][5] == "0"  # camera 0 misnames a robot in dense entry 5
    frame = (6, 5, [5.0] * 4, [5.0] * 4, 5.0, 4, 1)  # the card names all four
    assert smoke.soak_found(0, [frame])["ids_agree"] == 0
    assert smoke.soak_found(0, [frame], {6: {"ids": True, "ball": True}})["ids_agree"] == 1
    assert smoke.soak_found(0, [frame], {6: {"ids": False, "ball": True}})["ids_agree"] == 0
    assert smoke.soak_found(0, [frame], {7: {"ids": True, "ball": True}})["ids_agree"] == 0


def test_dispatched_inputs_replay_to_the_same_detections(smoke):
    """The soak's record of what a fleet dispatched (``Dispatched``: the
    tracked prior, colour tables, reference colours, params), through JSON
    and back, replayed by ``replay_dispatched`` on a fresh fleet, gives
    the fleet's own detections; frames whose outcome equals the JAX
    package's are not kept."""
    import json
    from types import SimpleNamespace

    from vision_processor_tpu_torch.app.processor import TrackedArrays
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.camera import RawFrame
    from vision_processor_tpu_torch.io.synthetic import render_raw

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rig = build_rig(4, resampling_factor=1.25, return_scenes=True,
                        raws=np.zeros((4, 1080, 1920), np.uint8), device="cpu")
        geometry, cams = rig[7], rig[8]
        scenes = smoke.soak_scenes(cams, rig[9])[0][:3]
        size = tuple(int(v) for v in cams[0][0].size)
        raws = [render_raw(cams[0][0], geometry.field, s, "RGGB") for s in scenes]
        fleet = smoke.replay_fleet(torch, geometry, size, 0)
        by_cam = {0: []}
        shim = SimpleNamespace(empty=lambda *a, pin_memory, **k: torch.empty(*a, **k))
        dispatched = smoke.Dispatched(shim, fleet, by_cam, "test")
        slots = fleet.processors[0].det_cfg.max_tracked
        last, outcomes = {}, []
        for i, raw in enumerate(raws):
            now = 0.01 * i
            dispatched.harvest()
            dispatched.before(i, now)
            out = fleet.dispatch_frames(
                [RawFrame(data=raw, fmt="RGGB", width=size[0], height=size[1])], now,
                TrackedArrays.build(smoke.fleet_prior({0: last}, now), now, slots))
            bots, balls = smoke.fin_detections({k: v.numpy() for k, v in out[2].items()})
            last = bots
            outcomes.append(smoke.judged(scenes[i], bots, balls))
            # frame 1 on the wire as the JAX package saw it, the others not
            errs = [5.0] * 4 if i == 0 else [float("inf")] * 4
            by_cam[0].append((i + 1, i, errs, [5.0] * 4, 5.0, len(bots), len(balls)))
        dispatched.harvest()
        assert [r["frame"] for r in dispatched.records] == [2, 3] and not dispatched.lost
        assert outcomes[2]["all_ids"] and outcomes[1]["sent"]
        replay = smoke.replay_fleet(torch, geometry, size, 0)
        for rec in json.loads(json.dumps(dispatched.records)):
            got = smoke.replay_dispatched(torch, replay, raws[rec["entry"]],
                                          scenes[rec["entry"]], rec)
            assert got == outcomes[rec["frame"] - 1]
    finally:
        torch.set_num_threads(n)


def test_perturb_bank_gives_the_witness_digests(smoke):
    """Camera 0's light-profile raws, rendered and perturbed here, have the
    digest JAX_PERTURB_FOUND holds for every light row (the frames the
    card's phase must see); every row has its entry."""
    from vision_processor_tpu_torch.bench import build_rig

    assert sorted(smoke.JAX_PERTURB_FOUND) == list(range(len(smoke.PERTURB_ROWS)))
    rig = build_rig(4, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((4, 1080, 1920), np.uint8),
                    device="cpu")
    bank = smoke.perturb_bank(rig[8][:1], rig[7], rig[9][:1], profiles=["light"])
    assert [r.shape for r in bank["raws"]["light"][0]] == [(1080, 1920)] * 6
    for r, row in enumerate(smoke.PERTURB_ROWS):
        want = smoke.JAX_PERTURB_FOUND[r]
        assert len(want["digests"]) == len(want["ids"]) == len(want["ball"]) == 4
        if row[0] == "light":
            assert want["digests"][0] == bank["digests"]["light"][0]


@pytest.fixture(scope="module")
def codec(smoke, tmp_path_factory):
    """The codec phase's frames and geometry on the CPU (``codec_bank``)."""
    from vision_processor_tpu_torch.bench import build_rig
    from vision_processor_tpu_torch.io.native import H264Encoder

    try:
        H264Encoder(qp=smoke.CODEC_QP)
    except RuntimeError:
        pytest.skip("native library unavailable")
    rig = build_rig(4, dense=True, dense_blobs=1900, resampling_factor=1.25,
                    return_scenes=True, raws=np.zeros((4, 1080, 1920), np.uint8),
                    device="cpu")
    path = tmp_path_factory.mktemp("codec") / "codec.h264"
    return rig, smoke.codec_bank(rig[8], rig[7], rig[9], path)


def test_codec_bank_gives_the_witness_digest(smoke, codec):
    """Camera 0's frames through the encoder and cv2, here: the digest
    JAX_CODEC_FOUND holds (the frames the card's phase must see), six 1080p
    RGGB raws, a codec that changed the pixels."""
    _, bank = codec
    assert bank["digest"] == smoke.JAX_CODEC_FOUND["digest"]
    assert [r.shape for r in bank["raws"]] == [(1080, 1920)] * len(smoke.CODEC_ENTRIES)
    assert all(r.dtype == np.uint8 for r in bank["raws"])
    assert bank["mean_abs"] > 0.1
    assert len(smoke.JAX_CODEC_FOUND["frames"]) == len(bank["scenes"])


def test_codec_config_is_config_yml_with_the_phase_changes(smoke, tmp_path):
    """``codec_config``: config.yml as shipped but for the driver, the
    addresses, (stream=False) the stream and (mode) the resample mode."""
    import yaml

    shipped = yaml.safe_load((ROOT / "config.yml").read_text())
    changed = ("camera", "network", "stream", "thresholds")
    for stream, mode in ((True, None), (False, "warp")):
        got = yaml.safe_load(smoke.codec_config(tmp_path / str(stream), stream, mode)
                             .read_text())
        assert got["camera"]["driver"] == "SMOKE_CODEC"
        assert got["network"]["vision_ip"] == smoke.CODEC_GROUP
        assert got["stream"]["ip_base_end"] == smoke.CODEC_STREAM_END
        assert got["stream"].get("active", True) is stream
        th = dict(got["thresholds"])
        assert th.pop("resample_mode", None) == mode
        assert th == shipped["thresholds"]
        assert {k: v for k, v in got.items() if k not in changed} \
            == {k: v for k, v in shipped.items() if k not in changed}


def test_codec_phase_app_on_the_cpu_equals_the_witness(smoke, codec, tmp_path):
    """The phase's App run (``codec_app_run``: the SMOKE_CODEC driver, the
    GeometryBus, the wire recorder) with the port's App on the CPU, in the
    warp resample that "auto" takes on the card: one
    detection frame a scene, ``last`` called once before the last frame,
    and ``codec_verdict`` clears every bar, its printed keys all there."""
    rig, bank = codec
    size = tuple(int(v) for v in rig[8][0][0].size)
    calls = []
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        frames, app, run_s = smoke.codec_app_run(
            "vision_processor_tpu_torch", smoke.codec_config(tmp_path, False, "warp"),
            bank["raws"], size, smoke.geometry_packet(rig[7], 0), lambda: calls.append(1),
            device="cpu")
    finally:
        torch.set_num_threads(n)
    assert calls == [1] and run_s > 0
    got, bad = smoke.codec_verdict(frames, bank["scenes"], smoke.JAX_CODEC_FOUND,
                                   app.processor.resample_mode)
    assert bad == []
    assert sorted(got) == ["ball_err_mm", "frames", "ids", "jax_ids", "max_bot_err_mm",
                           "max_diff_from_jax_mm"]
    assert got["frames"] == len(bank["scenes"]) and got["ids"] == got["jax_ids"]
    assert got["max_diff_from_jax_mm"] <= smoke.CODEC_ERR_MM


def test_codec_verdict_fails_a_missed_bar(smoke, codec):
    """A robot 35 mm off, a robot 1.5 mm from the JAX package's, a renamed
    robot, a lost frame, the gather path or a wrong launch count each fails
    the phase; the witness's own frames pass."""
    import copy

    _, bank = codec
    want, scenes = smoke.JAX_CODEC_FOUND, bank["scenes"]
    n = len(scenes)
    launches = {k: v * n for k, v in smoke.CODEC_LAUNCHES.items()}
    launches["corner_stack"] = 0
    assert smoke.codec_verdict(want["frames"], scenes, want, "warp", launches)[1] == []

    def moved(frame: int, dx: float, rename: bool = False):
        frames = copy.deepcopy(want["frames"])
        bot = frames[frame]["bots"][0]
        bot[2] += dx
        if rename:
            bot[1] = 9
        return frames

    for frames, why in ((moved(2, 35.0), "bars 30 / 40 mm"),
                        (moved(0, 1.5), "from the JAX package's"),
                        (moved(4, 0.0, rename=True), "the JAX package"),
                        (want["frames"][:-1], "detection frames")):
        bad = smoke.codec_verdict(frames, scenes, want)[1]
        assert bad and any(why in b for b in bad), (why, bad)
    assert smoke.codec_verdict(want["frames"], scenes, want, "gather")[1]
    assert smoke.codec_verdict(want["frames"], scenes, want, "warp",
                               dict(launches, band_pass=2 * n - 1))[1]
    with pytest.raises(SystemExit):
        smoke.fail("codec round trip: " + "; ".join(
            smoke.codec_verdict(moved(2, 35.0), scenes, want)[1]))
