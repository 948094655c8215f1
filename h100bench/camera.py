"""The benchmark's camera: a capture clock kept by arithmetic, and a
newest-only buffer, as an industrial camera delivers frames.

Camera ``c`` captures frame ``k`` at ``t0 + k / fps`` on the host's
monotonic clock. A read returns the newest frame captured and not yet
delivered; older ones are overwritten, never queued; a read that finds
nothing new sleeps until the next capture. The frames are rendered before
the window (``scene.render``): a read hands out a view of the loop's frame
``k mod L`` and copies nothing, and no thread of the camera's own runs.

Every camera of a rig shares one ``FrameClock``, which also marks the
window: read number ``warmup`` of the first camera to get there opens it
(at that read's capture time), and the first read at or after the close
ends every camera's stream. Each read number is decided once for all
cameras, so a frame-set is in the window for every camera or for none.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np


class FrameClock:
    """The rig's capture clock, the window, and the record of reads."""

    def __init__(self, fps: float, n_cams: int, warmup: int, seconds: float,
                 clock=time.monotonic, sleep=time.sleep):
        self.fps, self.n_cams = float(fps), n_cams
        self.warmup, self.seconds = warmup, float(seconds)
        self.clock, self.sleep = clock, sleep
        self.t0 = None  # capture time of frame 0, set by start()
        self.t_open = None  # capture time of the window's first frame
        self.t_close = None
        self._lock = threading.Lock()
        self._decided = []  # whether read number n delivers, for every camera
        self.on_open = None  # called once, as the window opens
        # capture number delivered by each camera's n-th read, -1 for none
        cap = int(math.ceil((seconds + 60.0) * fps)) + warmup + 16
        self.delivered = np.full((n_cams, cap), -1, dtype=np.int64)

    def start(self) -> None:
        self.t0 = self.clock()

    def newest(self, now: float) -> int:
        """The number of the newest frame captured by ``now``."""
        return int(math.floor((now - self.t0) * self.fps))

    def capture_time(self, k: int) -> float:
        return self.t0 + k / self.fps

    def decide(self, n: int, now: float) -> bool:
        """Whether read number ``n`` (of any camera) delivers a frame; the
        first camera to make read ``n`` decides it for all."""
        with self._lock:
            if n < len(self._decided):
                return self._decided[n]
            ok = True
            if n == self.warmup and self.t_open is None:
                self.t_open = self.capture_time(self.newest(now))
                self.t_close = self.t_open + self.seconds
                if self.on_open is not None:
                    self.on_open()
            elif self.t_close is not None and n > self.warmup and (
                    now >= self.t_close or not self._decided[-1]):
                ok = False
            self._decided.append(ok)
            return ok


class ClockCamera:
    """One camera of the rig: the port's driver surface (``read_image``,
    ``fmt``, ``expected_frametime``) over the loop's frames."""

    def __init__(self, clock: FrameClock, cam: int, frames: np.ndarray, raw_frame, fmt: str,
                 width: int, height: int):
        self.clock, self.cam = clock, cam
        self.frames = frames  # (L, rows, columns) uint8
        self._raw_frame = raw_frame  # the port's RawFrame
        self._fmt, self.width, self.height = fmt, width, height
        self.reads = 0
        self.last = -1  # the capture number last delivered

    @property
    def fmt(self) -> str:
        return self._fmt

    def expected_frametime(self) -> float:
        return 1.0 / self.clock.fps

    def read_image(self):
        clock = self.clock
        now = clock.clock()
        n = self.reads
        if not clock.decide(n, now):
            return None
        k = clock.newest(now)
        if k <= self.last:  # nothing new: wait for the next capture
            k = self.last + 1
            wait = clock.capture_time(k) - now
            if wait > 0:
                clock.sleep(wait)
        self.last = k
        self.reads = n + 1
        if n < clock.delivered.shape[1]:
            clock.delivered[self.cam, n] = k
        return self._raw_frame(data=self.frames[k % len(self.frames)], fmt=self._fmt,
                               width=self.width, height=self.height,
                               timestamp=clock.capture_time(k))

    def close(self) -> None:
        pass
