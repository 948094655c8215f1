"""A whole run on the CPU, past the harness's look for a card, at a size a
test run holds (two cameras, two robots a team, the Division B optics, a
4 fps camera): sound, it is correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (the exchange between cards is not one: the cell runs on one card).
Each run takes some ten seconds of CPU."""
import pytest

torch = pytest.importorskip("torch")

import rig as R  # noqa: E402
import run  # noqa: E402


def small_cell():
    cfg = R.load_json("configs", "divB_4cam")
    mix = R.load_json("traffic", "calm")
    cfg.update(cameras=2, robots_per_team=2, camera_fps=4)
    mix.update(loop_frames=8, warmup_frame_sets=2)
    return cfg, mix, R.load_json("limits", "divB_4cam.calm")


def unchanged(app):
    """The step hands back its first output on every frame-set."""
    inner, first = app.dispatch_frames, []

    def dispatch(*args, **kwargs):
        out = inner(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    app.dispatch_frames = dispatch


def half_batch(app):
    """The second half of the camera batch is left out: its frames go on
    the bus with nothing in them."""
    for proc in app.processors[len(app.processors) // 2:]:
        inner = proc.finish_frame

        def finish(*args, _inner=inner, **kwargs):
            wrapper, blobs, det = _inner(*args, **kwargs)
            d = wrapper.detection
            for field in (d.robots_yellow, d.robots_blue, d.balls):
                del field[:]
            return wrapper, blobs, det
        proc.finish_frame = finish


def altered(app):
    """Answers altered where they are produced: every camera names each
    robot with the next id."""
    for proc in app.processors:
        inner = proc.finish_frame

        def finish(*args, _inner=inner, **kwargs):
            wrapper, blobs, det = _inner(*args, **kwargs)
            d = wrapper.detection
            for team in (d.robots_yellow, d.robots_blue):
                for robot in team:
                    robot.robot_id = (robot.robot_id + 1) % 16
            return wrapper, blobs, det
        proc.finish_frame = finish


@pytest.mark.parametrize("fault", [None, unchanged, half_batch, altered],
                         ids=["sound", "unchanged", "half_batch", "altered"])
def test_a_planted_fault_makes_the_run_incorrect(fault):
    cfg, mix, limits = small_cell()
    out = run.run_cell(cfg, mix, 2**31 + 77, 4.0, False, torch.device("cpu"), torch,
                       app_hook=fault)
    compared = run.checks(out["numbers"], out["failed"], limits)
    assert out["attempted"] > 0 and not out["forbidden"]
    assert run.is_correct(compared) == (fault is None), compared
