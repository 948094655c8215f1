"""The colour chain under drift on the port, beside the JAX package: the
counterparts of tests/test_hard_scenes.py:91 ``test_color_drift_adaptation``
and tests/test_id_parity.py:35 ``test_ids_match_host_under_drift``.

* Drifted cover colours (a darker yellow, shifted green and pink), the
  same frame four times through the JAX and the port's ``Processor``
  (on-device finishing, the colour table carried from frame to frame):
  after every frame the port's colour tables equal the JAX package's
  within 1e-4 relative, and the ids are equal; after four the side
  colours have adapted and the ids are right, as the JAX test gates.
* The in-graph id estimate (guarded 2-means) under each parametrised
  drift: the port's ``estimate_bot_ids`` gives the JAX package's ids, and
  both equal the host's ``calc_bot_id`` of either package.
* Ball-coloured clutter on the field lines, then clean frames: the
  field-line colour learns the ball's orange and both packages drop the
  real ball alike (the chip soak's finding, ROADMAP section 3).
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

COLOR_RTOL = 1e-4
DRIFTED = {"YELLOW": [200, 170, 60], "GREEN": [70, 190, 110], "PINK": [200, 90, 150]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(wrapper):
    d = wrapper.detection
    return sorted((team, r.robot_id) for team, robots in (("yellow", d.robots_yellow),
                                                          ("blue", d.robots_blue))
                  for r in robots)


def test_color_drift_adaptation_matches_jax(divb_field, overhead_model):
    jcfg, tcfg = JVisionConfig(), VisionConfig()
    jcfg.max_blobs = tcfg.max_blobs = 256
    jp, tp = JProcessor(jcfg), Processor(tcfg, device="cpu")
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(overhead_model.to_proto(0))
    for p in (jp, tp):
        p.geometry_check(960, 720, geometry=geometry, version=1)

    saved = {mod: {k: getattr(mod, k).copy() for k in DRIFTED} for mod in (JS, TS)}
    try:
        for mod in (JS, TS):
            for k, v in DRIFTED.items():
                getattr(mod, k)[:] = v
        bots = [("yellow", 11, -2800.0, 500.0, 1.2), ("blue", 3, -1600.0, -700.0, -0.8)]
        jscene = JS.Scene(bots=[JS.SceneBot(i, team, x, y, w) for team, i, x, y, w in bots],
                          balls=[], noise_sigma=1.0)
        tscene = TS.Scene(bots=[TS.SceneBot(i, team, x, y, w) for team, i, x, y, w in bots],
                          balls=[], noise_sigma=1.0)
        jraw = JS.render_raw(jp.perspective.model, geometry.field, jscene, "RGGB")
        traw = TS.render_raw(tp.perspective.model, geometry.field, tscene, "RGGB")
        np.testing.assert_array_equal(traw, jraw)
        pink_before = tp.colors.pink.copy()
        for _ in range(4):
            jw, _, _ = jp.process_frame(JRawFrame(jraw, "RGGB", 960, 720, 0.0),
                                        tracked_by_cam={}, now=1.0)
            tw, _, _ = tp.process_frame(RawFrame(traw, "RGGB", 960, 720, 0.0),
                                        tracked_by_cam={}, now=1.0)
            np.testing.assert_allclose(tp.colors.packed(), jp.colors.packed(),
                                       rtol=COLOR_RTOL)
            assert _ids(tw) == _ids(jw)
        assert _ids(tw) == [("blue", 3), ("yellow", 11)]
        assert not np.array_equal(tp.colors.pink, pink_before)
    finally:
        for mod, cols in saved.items():
            for k, v in cols.items():
                getattr(mod, k)[:] = v
    assert np.array_equal(TS.YELLOW, [235, 200, 30]) and np.array_equal(JS.PINK, [235, 70, 160])


@pytest.mark.parametrize("drift_vec,noise", [
    ((0.0, 0.0, 0.0), 2.0),          # clean
    ((25.0, -20.0, 15.0), 4.0),      # uniform illumination drift
    ((-35.0, 30.0, 0.0), 8.0),       # heavy drift + noise
])
def test_ids_match_jax_under_drift(drift_vec, noise):
    """tests/test_id_parity.py:35's 32 bots of random ids under a global
    drift and per-blob noise (the same generator and seed)."""
    import jax.numpy as jnp

    from vision_processor_tpu.models.colors import ColorState as JColorState
    from vision_processor_tpu.models.detector import estimate_bot_ids as jestimate
    from vision_processor_tpu.models.host_detect import calc_bot_id as jcalc
    from vision_processor_tpu_torch.models.colors import ColorState
    from vision_processor_tpu_torch.models.detector import estimate_bot_ids
    from vision_processor_tpu_torch.models.host_detect import calc_bot_id
    from vision_processor_tpu_torch.models.pattern import PATTERNS

    rng = np.random.default_rng(11)
    jcolors, colors = JColorState(), ColorState()
    np.testing.assert_array_equal(colors.packed(), jcolors.packed())
    packed = colors.packed().astype(np.float64)
    yellow, blue, green, pink = packed[2], packed[3], packed[4], packed[5]
    drift = np.asarray(drift_vec)
    n_bots = 32
    blob_colors, per_bot = [], []
    blob_idx = np.zeros((n_bots, 5), dtype=np.int32)
    for b in range(n_bots):  # tests/test_id_parity.py make_bot_colors
        bot_id = int(rng.integers(0, 32))
        pat = int(PATTERNS[bot_id % 16])
        cols = [(blue if bot_id >= 16 else yellow) + drift + rng.normal(0, noise, 3)]
        for slot in range(1, 5):
            base = green if (pat >> (4 - slot)) & 1 else pink
            cols.append(base + drift + rng.normal(0, noise, 3))
        per_bot.append(cols)
        for s in range(5):
            blob_idx[b, s] = len(blob_colors)
            blob_colors.append(cols[s])
    blob_color = np.asarray(blob_colors, dtype=np.float32)
    table = colors.packed().astype(np.float32)

    want = np.asarray(jestimate({"bot_blob_idx": jnp.asarray(blob_idx),
                                 "bot_tracked_id": jnp.full(n_bots, -1, jnp.int32)},
                                jnp.asarray(blob_color), jnp.asarray(table)))
    got = estimate_bot_ids({"bot_blob_idx": torch.from_numpy(blob_idx),
                            "bot_tracked_id": torch.full((n_bots,), -1, dtype=torch.int32)},
                           torch.from_numpy(blob_color), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    host = [jcalc(jcolors, cols) for cols in per_bot]
    assert [calc_bot_id(colors, cols) for cols in per_bot] == host
    np.testing.assert_array_equal(want, host)


def test_clutter_on_lines_teaches_the_line_colour_as_jax(divb_field):
    """A frame of ball-coloured clutter on the field lines (the halfway line
    and the centre circle) teaches the adaptive field-line colour the
    ball's orange, and the ball colour score then drops the real ball in
    every clean frame after it: the JAX package does the same, with the
    same colour tables after every frame (exactly) and the same
    detections (ids and counts equal, positions within 0.5 mm). This is
    the chip soak's dense-frame finding (ROADMAP section 3), on the CPU."""
    from vision_processor_tpu.models.camera import CameraModel as JCameraModel
    from vision_processor_tpu_torch.models.camera import CameraModel

    width, height = 480, 270
    pose = dict(focal_length=900.0, principal_point=np.array([width / 2, height / 2]),
                distortion_k2=0.02, pos=np.array([0.0, 0.0, 4500.0]),
                size=np.array([width, height]))
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(JCameraModel(**pose).to_proto(0))
    procs = []
    for cfg_cls, proc_cls, kw in ((JVisionConfig, JProcessor, {}),
                                  (VisionConfig, Processor, {"device": "cpu"})):
        cfg = cfg_cls()
        cfg.max_blobs, cfg.resampling_factor, cfg.resample_mode = 2000, 1.25, "gather"
        procs.append(proc_cls(cfg, **kw))
    for p in procs:
        p.geometry_check(width, height, geometry=geometry, version=1)
    jp, tp = procs

    bot = TS.SceneBot(9, "blue", -200.0, -300.0, -1.0)
    ball = TS.SceneBall(-700.0, -300.0)
    lines = [(0.0, y) for y in np.linspace(-500.0, 500.0, 12)]
    lines += [(500.0 * np.cos(a), 500.0 * np.sin(a))
              for a in np.linspace(0.0, 2 * np.pi, 24, endpoint=False)]
    clutter = [TS.SceneBall(x, y) for x, y in lines
               if np.hypot(x - bot.x, y - bot.y) > 250.0 and np.hypot(x - ball.x, y - ball.y) > 150.0]
    model = CameraModel(**pose)

    def render(balls, seed):
        return TS.render_raw(model, geometry.field, TS.Scene(bots=[bot], balls=balls,
                                                             noise_sigma=1.5, seed=seed), "RGGB")

    # two clean frames, the clutter, then clean frames of other sensor noise
    raws = [render([ball], 1), render([ball], 1), render([ball, *clutter], 2)]
    raws += [render([ball], seed) for seed in range(10, 18)]
    balls = []
    for i, raw in enumerate(raws):
        jw, _, _ = jp.process_frame(JRawFrame(raw, "RGGB", width, height, 0.0),
                                    tracked_by_cam={}, now=0.1 * i)
        tw, _, _ = tp.process_frame(RawFrame(raw, "RGGB", width, height, 0.0),
                                    tracked_by_cam={}, now=0.1 * i)
        np.testing.assert_array_equal(tp.colors.packed(), jp.colors.packed())
        assert _ids(tw) == _ids(jw) == [("blue", 9)]
        for jr, tr in zip(jw.detection.robots_blue, tw.detection.robots_blue):
            assert abs(tr.x - jr.x) < 0.5 and abs(tr.y - jr.y) < 0.5
        got = [min((np.hypot(b.x - ball.x, b.y - ball.y) for b in w.detection.balls),
                   default=np.inf) for w in (jw, tw)]
        assert len(tw.detection.balls) == len(jw.detection.balls)
        assert got[0] == pytest.approx(got[1], abs=0.5)
        balls.append(got[1])
    line, orange = tp.colors.packed()[6], tp.colors.packed()[0]
    assert np.abs(line - orange).max() < 10.0  # the field-line colour is the ball's orange
    assert balls[0] < 40.0 and balls[1] < 40.0
    # both packages drop the real ball in clean frames after the clutter
    assert sum(b == np.inf for b in balls[3:]) >= 1
