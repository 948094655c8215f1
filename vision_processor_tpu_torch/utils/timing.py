"""Stage timing and frame statistics (PyTorch port).

Counterpart of vision_processor_tpu/utils/timing.py (reference
src/opencl.cpp:94-101, src/main.cpp:363-366):

* ``StageTimer`` — per-stage host wall time; on a CUDA device each stage
  also records a pair of CUDA events on the current stream, so the device
  time of the work the stage enqueued is read without a fence per stage.
* ``FrameStats`` — rolling frame-time statistics + overrun counting.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from .log import get_logger

log = get_logger(__name__)


class StageTimer:
    """Accumulates host wall time per named stage and, on a CUDA device,
    device time from CUDA events."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._events: dict[str, list] = defaultdict(list)

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        if self._cuda():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events[name].append((start, end))
        else:
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def device_ms(self, name: str) -> list[float]:
        """Device milliseconds of each recorded run of ``name`` (waits for
        the recorded events)."""
        out = []
        for start, end in self._events.get(name, []):
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def print_runtimes(self) -> None:
        for name in self.totals:
            n = self.counts[name]
            dev = self.device_ms(name)
            extra = f", device {sum(dev) / len(dev):8.3f} ms" if dev else ""
            log.info(
                "%-24s %8.3f ms avg over %d runs%s",
                name, 1e3 * self.totals[name] / max(n, 1), n, extra,
            )

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._events.clear()


class FrameStats:
    """Rolling frame statistics + budget overrun counter."""

    def __init__(self, window: int = 256):
        self.window = window
        self.samples: list[float] = []
        self.overruns = 0
        self.frames = 0

    def add(self, frame_time: float, budget: float) -> bool:
        """Record one frame; returns True when the budget was overrun."""
        self.frames += 1
        self.samples.append(frame_time)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        over = frame_time > budget
        if over:
            self.overruns += 1
        return over

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        idx = min(int(len(ordered) * q / 100.0), len(ordered) - 1)
        return ordered[idx]

    def summary(self) -> str:
        return (
            f"frames={self.frames} p50={self.percentile(50) * 1e3:.2f}ms "
            f"p90={self.percentile(90) * 1e3:.2f}ms "
            f"p99={self.percentile(99) * 1e3:.2f}ms overruns={self.overruns}"
        )
