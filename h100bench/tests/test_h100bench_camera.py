"""The benchmark's camera: newest frame only, overwritten and not queued, a
sleep until the next capture when nothing is new, no thread of its own,
and one window for every camera."""
import threading
from dataclasses import dataclass

import numpy as np

from camera import ClockCamera, FrameClock


@dataclass
class Frame:
    data: np.ndarray
    fmt: str
    width: int
    height: int
    timestamp: float


class FakeTime:
    def __init__(self):
        self.now = 100.0
        self.slept = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s


def rig(n_cams=2, warmup=2, seconds=1.0, fps=10.0, loop=5):
    t = FakeTime()
    clock = FrameClock(fps, n_cams, warmup, seconds, clock=t.clock, sleep=t.sleep)
    frames = [np.arange(loop * 4, dtype=np.uint8).reshape(loop, 2, 2) + 10 * c
              for c in range(n_cams)]
    cams = [ClockCamera(clock, c, frames[c], Frame, "RGGB", 1, 1) for c in range(n_cams)]
    clock.start()
    return t, clock, cams


def test_newest_frame_only_older_ones_overwritten():
    t, clock, cams = rig()
    t.now += 0.35  # frames 0-3 captured
    f = cams[0].read_image()
    assert f.timestamp == clock.capture_time(3)
    t.now += 0.52  # frames 4-8 captured since: only the newest comes
    f = cams[0].read_image()
    assert f.timestamp == clock.capture_time(8)
    assert f.data is cams[0].frames[8 % 5] or np.shares_memory(f.data, cams[0].frames)
    assert list(clock.delivered[0, :2]) == [3, 8]


def test_sleeps_until_the_next_capture():
    t, clock, cams = rig()
    t.now += 0.35
    cams[0].read_image()
    t.now += 0.01  # nothing new
    f = cams[0].read_image()
    assert f.timestamp == clock.capture_time(4)
    assert abs(t.slept[-1] - (clock.capture_time(4) - (clock.t0 + 0.36))) < 1e-9


def test_reads_start_no_thread():
    t, clock, cams = rig(seconds=100.0)
    before = set(threading.enumerate())
    for _ in range(50):
        t.now += 0.13
        for cam in cams:
            cam.read_image()
    assert set(threading.enumerate()) == before


def test_one_window_for_every_camera():
    t, clock, cams = rig(warmup=2, seconds=1.0)
    opened = []
    clock.on_open = lambda: opened.append(clock.t_open)
    for _ in range(2):  # the warm-up frame-sets
        t.now += 0.25
        assert all(cam.read_image() is not None for cam in cams)
    assert clock.t_open is None
    t.now += 0.25
    got = [cam.read_image() for cam in cams]
    assert clock.t_open == got[0].timestamp and opened == [clock.t_open]
    while True:
        t.now += 0.3
        first = cams[0].read_image()
        t.now += 0.01  # the other camera reads a moment later, past the close
        second = cams[1].read_image()
        assert (first is None) == (second is None)
        if first is None:
            break
    assert t.now >= clock.t_close
    assert cams[0].read_image() is None and cams[1].read_image() is None


def test_a_read_number_is_decided_once_for_all_cameras():
    t, clock, cams = rig(warmup=1, seconds=0.5)
    for _ in range(2):
        t.now += 0.2
        for cam in cams:
            cam.read_image()
    close = clock.t_close
    t.now = close - 0.001  # camera 0 reads just before the close ...
    assert cams[0].read_image() is not None
    t.now = close + 0.05  # ... camera 1 just after: the frame-set stays whole
    assert cams[1].read_image() is not None
    assert cams[0].read_image() is None and cams[1].read_image() is None
