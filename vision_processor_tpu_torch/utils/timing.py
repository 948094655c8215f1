"""Stage timing, the span and counter recorder, and frame statistics
(PyTorch port).

Counterpart of vision_processor_tpu/utils/timing.py (reference
src/opencl.cpp:94-101, src/main.cpp:363-366):

* ``Recorder`` / ``RECORDER`` — the port's one span and counter recorder,
  off by default (``enable()``, ``disable()``; the apps turn it on under
  ``VPTPU_BENCHMARK=1``). A span records its name, the frame-set id that
  every span of one frame-set shares, the camera (-1 for none), its
  parent's index (the span open on the same thread, or one given), its
  start and end, and its thread. A counter is a name and an integer of a
  frame-set. Times are ``time.monotonic_ns()``: the host's monotonic
  clock, which ``time.monotonic()`` reads too and onto which a profiler's
  device events can be mapped, so each idle gap of a device trace falls
  in the span the host was in. Records go to a bounded buffer (the oldest
  dropped and counted) until ``drain()``. Off, ``span`` returns one shared
  no-op object: nothing is allocated, no CUDA event recorded, nothing
  launched or synchronised. On, a span is host time only. Device counting
  (``enable(device_counting=True)``) keeps a reference to each static
  loop round's ``active`` tensor (``rounds``), reduces them once a
  frame-set (``reduce_rounds``, a few launches, no sync) and reads them
  with one copy after the frame-set's own device-to-host copy
  (``read_rounds``). A loop captured in a CUDA graph logs its rounds once
  (``collect_rounds``), and each replay records them (``replay_rounds``).
* ``StageTimer`` — ``stage`` is a span of the recorder; ``measure`` times
  one call up to a device fence, on a CUDA device with a pair of CUDA
  events read by ``device_ms``.
* ``trace``      — context manager around ``torch.profiler`` writing a
  Chrome trace (chrome://tracing, Perfetto).
* ``FrameStats`` — rolling frame-time statistics + overrun counting.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict, deque, namedtuple

import torch

from .log import get_logger

log = get_logger(__name__)

Span = namedtuple("Span", "index name frame_set camera parent start_ns end_ns thread")
Count = namedtuple("Count", "frame_set name value")


class _NoSpan:
    """The span of a recorder that is off: one shared object, nothing
    recorded."""

    __slots__ = ()
    index = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("_rec", "index", "name", "frame_set", "camera", "parent", "start_ns")

    def __init__(self, rec, index, name, frame_set, camera, parent):
        self._rec, self.index, self.name = rec, index, name
        self.frame_set, self.camera, self.parent = frame_set, camera, parent

    def __enter__(self):
        self._rec._stack().append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        self._rec._stack().pop()
        self._rec._add(Span(self.index, self.name, self.frame_set, self.camera, self.parent,
                            self.start_ns, end, threading.get_ident()))
        return False


class Recorder:
    """Spans and counters in a bounded buffer (see the module docstring)."""

    def __init__(self, capacity: int = 1 << 16):
        self.on = False
        self.device_counting = False
        self.frame_set = 0  # the frame-set begun last
        self.dropped = 0
        self._records = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._index = itertools.count()
        self._rounds = []  # (frame_set, name, [active tensors]) not yet reduced
        self._device = []  # (frame_set, name, device scalar) not yet read

    def enable(self, device_counting: bool = False) -> None:
        self.on = True
        self.device_counting = device_counting

    def disable(self) -> None:
        self.on = False
        self.device_counting = False
        self._rounds, self._device = [], []

    def begin_frame_set(self) -> int:
        """A new frame-set id for the spans that follow (-1 when off)."""
        if not self.on:
            return -1
        self.frame_set += 1
        return self.frame_set

    def span(self, name: str, camera: int | None = None, frame_set: int | None = None,
             parent: int | None = None):
        """A context manager timing its block. Unset, ``parent``, ``camera``
        and ``frame_set`` are the open span's of this thread (the frame-set
        begun last and camera -1 where none is open)."""
        if not self.on:
            return NO_SPAN
        stack = self._stack()
        top = stack[-1] if stack else None
        if parent is None:
            parent = top.index if top is not None else -1
        if camera is None:
            camera = top.camera if top is not None else -1
        if frame_set is None:
            frame_set = top.frame_set if top is not None else self.frame_set
        return _OpenSpan(self, next(self._index), name, frame_set, camera, parent)

    def mark(self) -> int:
        """``time.monotonic_ns()`` when on, else 0: the start of a span
        ``record`` closes later."""
        return time.monotonic_ns() if self.on else 0

    def record(self, name: str, start_ns: int, end_ns: int, frame_set: int,
               camera: int = -1, parent: int = -1) -> None:
        """A span whose ends were taken apart from one block."""
        if self.on:
            self._add(Span(next(self._index), name, frame_set, camera, parent, start_ns,
                           end_ns, threading.get_ident()))

    def count(self, name: str, value: int, frame_set: int | None = None) -> None:
        if self.on:
            self._add(Count(self.frame_set if frame_set is None else frame_set, name,
                            int(value)))

    def rounds(self, name: str, iters: int) -> list | None:
        """A loop of ``iters`` static rounds: counts ``<name>.rounds``. With
        device counting on, returns the list into which the loop puts each
        round's ``active`` tensor (rows still running) as the round starts;
        ``reduce_rounds`` turns them into ``<name>.live_rounds``, the rounds
        at whose start some row was active."""
        if not self.on:
            return None
        collected = getattr(self._local, "collected", None)
        if collected is not None:
            kept = [] if self.device_counting else None
            collected.append((name, iters, kept))
            return kept
        self.count(name + ".rounds", iters)
        if not self.device_counting:
            return None
        kept = []
        self._rounds.append((self.frame_set, name + ".live_rounds", kept))
        return kept

    @contextlib.contextmanager
    def collect_rounds(self):
        """Within the block, on this thread, ``rounds`` records nothing: it
        logs each loop as (name, iters, kept) in the list the block gets,
        ``kept`` being the list it returns. ``replay_rounds`` records such a
        log later, as ``rounds`` would have: for loops captured in a CUDA
        graph, whose every replay refreshes the kept tensors."""
        prev = getattr(self._local, "collected", None)
        self._local.collected = collected = []
        try:
            yield collected
        finally:
            self._local.collected = prev

    def replay_rounds(self, collected: list) -> None:
        """Record the loops of a ``collect_rounds`` log in this frame-set."""
        for name, iters, kept in collected:
            out = self.rounds(name, iters)
            if out is not None and kept is not None:
                out.extend(kept)

    def reduce_rounds(self) -> None:
        """Enqueue the reduction of the kept ``active`` tensors: one stack,
        ``any`` and sum a tensor shape, no sync."""
        if not self._rounds:
            return
        by_shape = defaultdict(list)
        for fs, name, kept in self._rounds:
            for active in kept:
                by_shape[(fs, name, tuple(active.shape))].append(active)
        self._rounds = []
        totals = {}
        for (fs, name, _), acts in by_shape.items():
            live = torch.stack(acts).reshape(len(acts), -1).any(dim=1).sum()
            totals[(fs, name)] = totals[(fs, name)] + live if (fs, name) in totals else live
        self._device += [(fs, name, t) for (fs, name), t in totals.items()]

    def read_rounds(self, upto: int) -> None:
        """The reduced counts of frame-sets up to ``upto`` to the host, in
        one copy; call it once the card has finished those frame-sets."""
        ready = [d for d in self._device if d[0] <= upto]
        if not ready:
            return
        self._device = [d for d in self._device if d[0] > upto]
        values = torch.stack([t for _, _, t in ready]).tolist()
        for (fs, name, _), v in zip(ready, values):
            self.count(name, v, fs)

    def drain(self) -> dict:
        """Every record, handed over and removed: ``spans`` (``Span``),
        ``counts`` (``Count``) and ``dropped``, the records the full buffer
        let go since the last drain."""
        with self._lock:
            records = list(self._records)
            self._records.clear()
            dropped, self.dropped = self.dropped, 0
        return {"spans": [r for r in records if isinstance(r, Span)],
                "counts": [r for r in records if isinstance(r, Count)],
                "dropped": dropped}

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, record) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(record)


RECORDER = Recorder()


def log_means(drained: dict) -> None:
    """Log each span's mean host ms and each counter's mean a frame-set of
    a ``drain()`` (the ``VPTPU_BENCHMARK=1`` log)."""
    spans = defaultdict(list)
    for s in drained["spans"]:
        spans[s.name].append(s.end_ns - s.start_ns)
    for name, ns in spans.items():
        log.info("%-24s %8.3f ms avg over %d runs", name, 1e-6 * sum(ns) / len(ns), len(ns))
    counts = defaultdict(lambda: defaultdict(int))
    for c in drained["counts"]:
        counts[c.name][c.frame_set] += c.value
    for name, by_fs in counts.items():
        log.info("%-24s %8.1f a frame-set over %d", name, sum(by_fs.values()) / len(by_fs),
                 len(by_fs))
    if drained["dropped"]:
        log.info("%d records dropped by the full buffer", drained["dropped"])


class StageTimer:
    """Host wall time per named ``measure`` call and, on a CUDA device,
    device time from CUDA events; ``stage`` is a span of ``RECORDER``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._events: dict[str, list] = defaultdict(list)

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def stage(self, name: str):
        """A span of ``RECORDER`` (nothing when it is off)."""
        return RECORDER.span(name)

    def measure(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` timed up to a fence of the timer's device
        (``torch.cuda.synchronize``, the counterpart of
        ``jax.block_until_ready``; the CPU needs none); on a CUDA device its
        CUDA events are kept for ``device_ms(name)``. Returns fn's output."""
        t0 = time.perf_counter()
        if self._cuda():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize(self.device)
            self._events[name].append((start, end))
        else:
            out = fn(*args, **kwargs)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

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


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace of a block (CPU activity, and CUDA activity
    when CUDA is available), written as a Chrome trace into ``log_dir``
    (default ``vptpu-torch-trace`` in the temporary directory); yields
    ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "vptpu-torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


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
