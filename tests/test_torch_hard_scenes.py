"""The hard scenes on the port, beside the JAX package: the counterparts of
tests/test_hard_scenes.py:39 (two close robots), :55 (the bot-ball
clipping hull), :81 (a far ball) and :125 (heavy sensor noise); :91 is
held by tests/test_torch_color_drift.py.

Each scene is rendered once by the port's renderer, checked byte-equal to
the JAX renderer's, and run through the JAX ``Processor`` and the port's
``Processor(device="cpu")`` (960x720 RGGB, max_blobs 256, the
``divb_field`` and ``overhead_model`` fixtures). The port's detections
must pass the JAX test's own assertion and equal the JAX package's: the
same ids and teams, x and y within 0.5 mm, orientations within 1e-3 rad
(as tests/test_torch_replay.py) and the same number of balls. The hull
is compared element-wise on the JAX test's six balls and on 256 seeded
random (bot, orientation, ball) triples.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import vision_processor_tpu.io.synthetic as JS
import vision_processor_tpu_torch.io.synthetic as TS
from vision_processor_tpu.app.processor import Processor as JProcessor
from vision_processor_tpu.io.camera import RawFrame as JRawFrame
from vision_processor_tpu.utils.config import VisionConfig as JVisionConfig
from vision_processor_tpu_torch.app.processor import Processor
from vision_processor_tpu_torch.io.camera import RawFrame
from vision_processor_tpu_torch.utils.config import VisionConfig

POS_MM, ORIENT_RAD = 0.5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def processors(divb_field, overhead_model):
    """(JAX, port) processors of tests/test_hard_scenes.py's fixture."""
    jcfg, tcfg = JVisionConfig(), VisionConfig()
    jcfg.max_blobs = tcfg.max_blobs = 256
    jp, tp = JProcessor(jcfg), Processor(tcfg, device="cpu")
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(overhead_model.to_proto(0))
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=1)
    return jp, tp


def _robots(det) -> dict:
    return {(team, r.robot_id): r for team, robots in (("yellow", det.robots_yellow),
                                                      ("blue", det.robots_blue))
            for r in robots}


def _run(processors, divb_field, bots, balls, noise_sigma, seed=0):
    """The scene through both packages; returns the port's detection frame
    once it equals the JAX package's."""
    jp, tp = processors
    field = divb_field.geometry.field
    tscene = TS.Scene(bots=[TS.SceneBot(*b) for b in bots],
                      balls=[TS.SceneBall(*b) for b in balls],
                      noise_sigma=noise_sigma, seed=seed)
    jscene = JS.Scene(bots=[JS.SceneBot(*b) for b in bots],
                      balls=[JS.SceneBall(*b) for b in balls],
                      noise_sigma=noise_sigma, seed=seed)
    raw = TS.render_raw(tp.perspective.model, field, tscene, "RGGB")
    np.testing.assert_array_equal(raw, JS.render_raw(jp.perspective.model, field, jscene,
                                                     "RGGB"))
    jw, _, _ = jp.process_frame(JRawFrame(raw, "RGGB", 960, 720, 0.0), tracked_by_cam={},
                                now=1.0)
    tw, _, _ = tp.process_frame(RawFrame(raw, "RGGB", 960, 720, 0.0), tracked_by_cam={},
                                now=1.0)
    got, want = _robots(tw.detection), _robots(jw.detection)
    assert sorted(got) == sorted(want)
    for key, r in got.items():
        assert r.x == pytest.approx(want[key].x, abs=POS_MM)
        assert r.y == pytest.approx(want[key].y, abs=POS_MM)
        assert r.orientation == pytest.approx(want[key].orientation, abs=ORIENT_RAD)
    assert len(tw.detection.balls) == len(jw.detection.balls)
    return tw.detection


def test_two_close_robots_both_kept_as_jax(processors, divb_field):
    """:39 — 195 mm apart, both robots survive the clipping NMS."""
    det = _run(processors, divb_field,
               [(1, "yellow", -2600.0, 0.0, 0.0), (9, "blue", -2600.0, 195.0, 3.1)], [], 1.0)
    assert len(det.robots_yellow) == 1
    assert len(det.robots_blue) == 1


def _clipping(bot_pos, orient, balls):
    """Both packages' ``bot_ball_clipping`` at the JAX test's ball radius
    (21.5 mm) and tolerance (10 mm), as numpy masks."""
    import jax.numpy as jnp

    from vision_processor_tpu.models.detector import bot_ball_clipping as jclip
    from vision_processor_tpu_torch.models.detector import bot_ball_clipping

    f32 = np.float32
    want = np.asarray(jclip(jnp.asarray(bot_pos, f32), jnp.asarray(orient, f32),
                            jnp.asarray(balls, f32), jnp.float32(21.5), jnp.float32(10.0)))
    got = bot_ball_clipping(torch.tensor(bot_pos, dtype=torch.float32),
                            torch.tensor(orient, dtype=torch.float32),
                            torch.tensor(balls, dtype=torch.float32),
                            torch.tensor(21.5), torch.tensor(10.0)).numpy()
    return got, want


def test_bot_ball_clipping_geometry_as_jax():
    """:55 — the flat front at 55 mm and the circular hull at 85 mm, on the
    JAX test's six balls; then 256 random triples around the hull, each
    mask element equal to the JAX package's."""
    balls = [[100.0, 0.0], [60.0, 0.0], [45.0, 0.0], [-90.0, 0.0], [-100.0, 0.0],
             [0.0, 400.0]]
    got, want = _clipping([[0.0, 0.0]], [0.0], balls)
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [False, False, True, True, False, False]

    rng = np.random.default_rng(55)
    n = 256
    bots = rng.uniform(-3000.0, 3000.0, (n, 2))
    orient = rng.uniform(-np.pi, np.pi, n)
    radius, angle = rng.uniform(0.0, 150.0, n), rng.uniform(-np.pi, np.pi, n)
    balls = bots + np.stack([radius * np.cos(angle), radius * np.sin(angle)], axis=1)
    got, want = _clipping(bots, orient, balls)
    np.testing.assert_array_equal(np.diagonal(got), np.diagonal(want))
    # the batch reaches both sides of the hull
    assert 0 < int(np.diagonal(got).sum()) < n


def test_far_ball_survives_as_jax(processors, divb_field):
    """:81 — a ball 400 mm from the robot is kept."""
    det = _run(processors, divb_field, [(4, "yellow", -2600.0, 0.0, 2.0)],
               [(-2600.0, 400.0)], 1.0)
    assert len(det.balls) == 1


def test_noise_robustness_as_jax(processors, divb_field):
    """:125 — four robots and a ball under sensor noise of sigma 10."""
    poses = [(-4200, -1400, "yellow", 1), (-3600, 0, "blue", 5),
             (-2600, 1100, "yellow", 14), (-1300, 600, "blue", 6)]
    det = _run(processors, divb_field,
               [(i, team, float(x), float(y), 0.4 * i) for (x, y, team, i) in poses],
               [(-2000.0, -400.0)], 10.0, seed=1)
    assert set(_robots(det)) == {(team, i) for (x, y, team, i) in poses}
    assert len(det.balls) == 1
