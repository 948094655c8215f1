"""The plain reference and its control at a size a test run holds: the
scene's own objects read zero on every number, and the control (the
reference in the program's place, each frame carrying the state a fixed
time before the capture it is stamped with) fails the cell's limits."""
import numpy as np
import pytest

import rig as R
import run
import scene as S
from reference.truth import NUMBERS, Truth, control_frames, judge


def _truth(config, mix, seed):
    r = R.build_rig(R.load_json("configs", config))
    m = R.load_json("traffic", mix)
    sc = S.make_scene(r, m, seed)
    truth = Truth([c.calibration() for c in r.cameras], sc.teams, sc.ids, sc.robots, sc.ball,
                  sc.robot_height, sc.ball_radius, m["expect_robot_margin_px"],
                  m["expect_ball_margin_px"])
    return r, truth


def _exact_frames(truth, delivered, fps, t0):
    frames = []
    for c, k in delivered:
        j = k % truth.loop
        robots = {0: [], 1: []}
        for r in np.flatnonzero(truth.must_robot[c, j]):
            team, rid = truth.key[r]
            robots[team].append((rid, *truth.robots[j, r], 1.0))
        balls = [(*truth.ball[j], 1.0)] if truth.must_ball[c, j] else []
        frames.append({"camera_id": c, "t_capture_camera": t0 + k / fps, "balls": balls,
                       "yellow": robots[0], "blue": robots[1]})
    return frames


CELLS = [("divB_4cam", "calm", "divB_4cam.calm")]


@pytest.mark.parametrize("config,mix,cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11, 987654321987, 3000000001, 3000000002,
                                  3000000003])
def test_the_scene_itself_reads_zero_and_the_control_fails(config, mix, cell, seed):
    r, truth = _truth(config, mix, seed)
    fps, t0 = r.fps, 1000.0
    # every 4th capture of each camera, as a loop at a quarter of the rate takes them
    delivered = [(c, k) for k in range(7, 7 + 600, 4) for c in range(r.n_cams)]
    exact = judge(truth, _exact_frames(truth, delivered, fps, t0), fps, t0)
    assert all(exact[k] == 0 for k in NUMBERS)
    limits = R.load_json("limits", cell)
    assert run.is_correct(run.checks(exact, 0, limits))
    ctl = judge(truth, control_frames(truth, delivered, fps, t0), fps, t0)
    assert not run.is_correct(run.checks(ctl, 0, limits)), ctl


@pytest.mark.parametrize("mix,share", [("calm", 1.0), ("match", 0.85)])
def test_every_robot_is_some_cameras_duty(mix, share):
    """Every robot is due in some camera in part of the loop; where robots
    hold their quadrants, always; where they roam, in nine frames of ten or
    so: a robot within the margin of every image that sees it (at a seam)
    is no camera's duty there."""
    _, truth = _truth("divB_4cam", mix, 5)
    due = truth.must_robot.any(axis=0)
    assert due.any(axis=0).all() and due.mean() >= share


def test_a_frame_off_the_capture_clock_is_unstamped():
    r, truth = _truth("divB_4cam", "calm", 5)
    f = _exact_frames(truth, [(0, 10)], r.fps, 50.0)[0]
    f["t_capture_camera"] += 0.003
    assert judge(truth, [f], r.fps, 50.0)["unstamped_frames"] == 1


def test_a_wrong_id_and_a_missed_robot_count():
    r, truth = _truth("divB_4cam", "calm", 5)
    f = _exact_frames(truth, [(1, 10)], r.fps, 50.0)[0]
    team = "yellow" if f["yellow"] else "blue"
    rid, *rest = f[team][0]
    used = {k[1] for k in truth.key if k[0] == (0 if team == "yellow" else 1)}
    free = next(i for i in range(16) if i not in used)
    f[team][0] = (free, *rest)
    got = judge(truth, [f], r.fps, 50.0)
    assert got["unknown_robots"] == 1 and got["missed_robots"] == 1
    assert got["unknown_robot_share"] > 0 and got["missed_robot_share"] > 0
