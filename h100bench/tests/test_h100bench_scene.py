"""The traffic generator: robots at the mix's speeds, over the whole field
and across the camera seams (``match``) or each in its home quadrant
(``calm``), some passing the ball where the mix asks, with no cover over
another or over the ball; the same counts and loop for every seed; the
control's lag a fixed time."""
import numpy as np
import pytest

import rig as R
import scene as S
from reference.truth import CONTROL_LAG_S, Truth, control_frames, judge

SEEDS = [3, 2**31 + 11, 987654321987, 3000000001]


def _cell(seed, traffic="calm"):
    cfg = R.load_json("configs", "divB_4cam")
    mix = R.load_json("traffic", traffic)
    r = R.build_rig(cfg)
    return r, mix, S.make_scene(r, mix, seed)


@pytest.mark.parametrize("traffic", ["calm", "match"])
@pytest.mark.parametrize("seed", SEEDS)
def test_speeds_seams_and_the_ball(seed, traffic):
    r, mix, sc = _cell(seed, traffic)
    pos = sc.robots[..., :2]  # (L, R, 2)
    step = np.hypot(*np.diff(np.concatenate([pos, pos[:1]]), axis=0).transpose(2, 0, 1))
    top = step.max(0) * r.fps  # each robot's top speed over the loop, mm/s
    lo, hi = mix["robot_top_speed_mm_s"]
    assert (top > 0.95 * lo).all() and (top <= hi * 1.001).all()
    ball = np.hypot(*np.diff(np.concatenate([sc.ball, sc.ball[:1]]), axis=0).T) * r.fps
    assert ball.max() <= mix["ball_max_speed_mm_s"] * 1.001
    quadrant = (pos[..., 0] > 0) * 2 + (pos[..., 1] > 0)
    crossing = sum(len(set(quadrant[:, k])) > 1 for k in range(pos.shape[1]))
    near = np.hypot(*(pos - sc.ball[:, None]).transpose(2, 0, 1))  # (L, R)
    if mix.get("home_margin_mm") is None:
        assert crossing >= pos.shape[1] // 3
        assert (near.min(0) <= mix["ball_reach_mm"][1]).sum() >= mix["robots_reaching_ball"]
    else:
        assert crossing == 0
        assert (np.bincount(quadrant[0], minlength=r.n_cams) == pos.shape[1] // r.n_cams).all()
    assert near.min() >= S.COVER_RADIUS + sc.ball_radius + mix["ball_clearance_mm"] - 1e-6
    a, b = np.triu_indices(pos.shape[1], 1)
    apart = np.hypot(*(pos[:, a] - pos[:, b]).transpose(2, 0, 1))
    assert apart.min() >= 2 * S.COVER_RADIUS + mix["robot_clearance_mm"] - 1e-6
    half = np.array([r.field["field_length"], r.field["field_width"]]) / 2
    assert (np.abs(pos) <= half - mix["field_margin_mm"] + 1e-6).all()


def test_every_seed_has_the_same_counts_and_loop():
    shapes = {(_cell(s)[2].robots.shape, tuple(np.bincount(_cell(s)[2].teams))) for s in SEEDS}
    assert len(shapes) == 1


def test_a_hidden_ball_is_not_due():
    r, mix, sc = _cell(5)
    calibs = [c.calibration() for c in r.cameras]
    robots = sc.robots.copy()
    robots[:, 0, :2] = sc.ball  # robot 0's cover right over the ball
    t = Truth(calibs, sc.teams, sc.ids, robots, sc.ball, sc.robot_height, sc.ball_radius,
              mix["expect_robot_margin_px"], mix["expect_ball_margin_px"])
    assert not t.must_ball.any()


def test_the_control_lags_a_fixed_time():
    r, mix, sc = _cell(7)
    t = Truth([c.calibration() for c in r.cameras], sc.teams, sc.ids, sc.robots, sc.ball,
              sc.robot_height, sc.ball_radius, mix["expect_robot_margin_px"],
              mix["expect_ball_margin_px"])
    delivered = [(c, k) for k in range(20, 320, 3) for c in range(r.n_cams)]
    for fps, lag in ((60.0, 1), (30.0, 1), (120.0, 2)):
        frames = control_frames(t, delivered, fps, 0.0)
        assert len(frames) == len(delivered)
        c, k = delivered[40]
        f = next(x for x in frames if x["camera_id"] == c and
                 round(x["t_capture_camera"] * fps) == k)
        j = (k - lag) % t.loop
        want = [tuple(t.robots[j, q][:2]) for q in np.flatnonzero(t.must_robot[c, j])]
        got = [(x, y) for rid, x, y, h, _ in f["yellow"] + f["blue"]]
        assert sorted(got) == sorted(want)
        assert lag == max(1, round(CONTROL_LAG_S * fps))
    got = judge(t, control_frames(t, delivered, r.fps, 0.0), r.fps, 0.0)
    assert got["robot_gap_mm"] > mix["robot_top_speed_mm_s"][0] / r.fps * 0.9
    assert got["ball_gap_mm"] > 0.5 * mix["ball_max_speed_mm_s"] / r.fps
