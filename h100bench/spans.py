"""The benchmark's spans around the port's layers, and the profiled part of
a traced run.

Spans are taken from the benchmark's own files: the ``MultiCamApp``
instance's bound methods ``_read_all`` (the camera reads),
``dispatch_frames`` (the camera batch and the step's dispatch) and
``finish_frames`` (the device-to-host copy, host finishing and the send)
are wrapped, each call recording its start and end on the host's monotonic
clock. A traced run also profiles the second half of its window with
``torch.profiler`` (device activity only) and records the shapes of each
call of the kernel wrappers there; the host spans of the first half give
the host times. The wrappers' recorders are put in place at set-up, so
that what a call's yardstick needs from the card (the distinct rows of a
gather's index) is read during the warm-up, outside the profiled part.
"""
from __future__ import annotations

import importlib
import time

from roofline import WRAPPERS, work

SPAN_KINDS = ("read", "dispatch", "finish")


class Spans:
    """Host spans of the three layers, with the window's bounds and the
    profiler's part."""

    def __init__(self):
        self.spans = {k: [] for k in SPAN_KINDS}
        self.profile = None  # the Profiled part of a traced run

    def wrap(self, app, on_end, profiled: "Profiled | None" = None) -> None:
        """Wrap the app instance's three methods; ``on_end()`` runs once, at
        the read that finds the streams ended."""
        record = self.spans

        def timed(kind, fn):
            out_list = record[kind]

            def span(*args, **kwargs):
                t0 = time.monotonic()
                try:
                    return fn(*args, **kwargs)
                finally:
                    out_list.append((t0, time.monotonic()))
            return span

        read, dispatch = timed("read", app._read_all), timed("dispatch", app.dispatch_frames)
        ended = []

        def read_then_mark():
            frames, pending = read()
            if not ended and not any(f is not None for f in frames):
                ended.append(True)
                if profiled is not None:
                    profiled.stop()
                on_end()
            return frames, pending

        app._read_all = read_then_mark
        if profiled is not None:
            self.profile = profiled

            def start_then_dispatch(*args, **kwargs):
                profiled.maybe_start()
                return dispatch(*args, **kwargs)

            app.dispatch_frames = start_then_dispatch
        else:
            app.dispatch_frames = dispatch
        app.finish_frames = timed("finish", app.finish_frames)

    def host_part(self, t_open: float, t_end: float) -> dict:
        """The spans that start in [t_open, t_end), by kind."""
        return {k: [(a, b) for a, b in v if t_open <= a < t_end]
                for k, v in self.spans.items()}


class Profiled:
    """``torch.profiler`` over the part of the window from ``t_start`` on
    (the first dispatch after it starts the profiler) to the end of the
    streams (the read that finds no frame stops it), and the kernel
    wrappers' calls in between."""

    def __init__(self, torch, t_start: float, on_start):
        self.torch = torch
        self.t_start = t_start
        self.on_start = on_start  # runs once, as the profiler starts
        self.prof = None
        self.window = None  # (start, stop), monotonic s
        self.calls = []  # (wrapper, bytes, operations)
        self._saved = []
        self._offset_ns = 0
        self._distinct = {}  # (data_ptr, shape) of a gather index -> distinct rows
        self.active = False  # the recorders record only while profiling
        self.costs = {"distinct_rows_read_in_profile": 0}  # and start_s, stop_s

    def maybe_start(self) -> None:
        if self.prof is not None or self.window is not None:
            return
        if time.monotonic() < self.t_start:
            return
        from torch.profiler import ProfilerActivity, profile

        self.on_start()
        t0 = time.monotonic()
        self.prof = profile(activities=[ProfilerActivity.CUDA
                                        if self.torch.cuda.is_available()
                                        else ProfilerActivity.CPU])
        self.prof.start()
        self.active = True
        self._offset_ns = time.time_ns() - time.monotonic_ns()
        self.window = [time.monotonic(), None]
        self.costs["start_s"] = self.window[0] - t0

    def stop(self) -> None:
        if self.prof is None or self.window[1] is not None:
            return
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.window[1] = time.monotonic()
        self.active = False
        self.uninstall()
        t0 = time.monotonic()
        self.prof.stop()
        self.costs["stop_s"] = time.monotonic() - t0

    def install(self) -> None:
        """Put a recorder around each kernel wrapper of the port; call it at
        set-up, before the warm-up."""
        for name, (mod_name, attr) in WRAPPERS.items():
            mod = importlib.import_module(f"vision_processor_tpu_torch.{mod_name}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def rec(*args, _name=name, _fn=fn, **kwargs):
                kw = {k: v for k, v in kwargs.items() if not hasattr(v, "shape")}
                if _name == "gather_corners":
                    kw["distinct_rows"] = self.distinct_rows(args[1])
                if self.active:
                    shapes = tuple(tuple(a.shape) if hasattr(a, "shape") else a for a in args)
                    self.calls.append((_name, *work(_name, shapes, kw)))
                return _fn(*args, **kwargs)
            setattr(mod, attr, rec)

    def distinct_rows(self, idx) -> int:
        """The distinct rows a gather's index names, read once an index
        tensor (the indices are static grids, first seen in the warm-up)."""
        key = (idx.data_ptr(), tuple(idx.shape), str(idx.device))
        if key not in self._distinct:
            if self.active:
                self.costs["distinct_rows_read_in_profile"] += 1
            self._distinct[key] = int(self.torch.unique(idx).numel())
        return self._distinct[key]

    def uninstall(self) -> None:
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []

    def device_events(self) -> list:
        """(start, end, name) of every operation the card ran in the
        profiled part (kernels, copies, fills), monotonic s."""
        if self.prof is None or self.window is None or self.window[1] is None:
            return []
        out = []
        off = self._offset_ns
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            t0 = (e.start_ns() - off) * 1e-9
            out.append((t0, t0 + e.duration_ns() * 1e-9, e.name()))
        return out


def reduce(spans: Spans, t_open: float, t_close: float, cpu_s: float) -> dict:
    """The run's record for the per-layer readers: the host part's spans and
    frame-sets, its CPU seconds, and the profiled part's device operations,
    kernel calls, frame-sets and spans."""
    prof = spans.profile
    host_end = prof.window[0] if prof is not None and prof.window else t_close
    host = spans.host_part(t_open, host_end)
    rec = {"host": {"spans": host, "frame_sets": len(host["dispatch"]),
                    "seconds": host_end - t_open, "cpu_s": cpu_s},
           "profiled": None}
    if prof is not None and prof.window and prof.window[1] is not None:
        a, b = prof.window
        inside = spans.host_part(a, b)
        rec["profiled"] = {"window": (a, b), "frame_sets": len(inside["dispatch"]),
                           "spans": inside, "device": prof.device_events(),
                           "calls": list(prof.calls)}
    return rec


def busy_intervals(device: list, window: tuple) -> list:
    """The union of the device operations' intervals, clipped to the
    window: sorted, disjoint (start, end) pairs."""
    a, b = window
    out = []
    for s, e, _ in sorted(device):
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def idle_gaps(profiled: dict) -> list:
    """(label, seconds) of each stretch of the profiled part in which the
    card ran nothing, labelled by the host span its middle falls in
    (``host_in_read``, ``host_in_dispatch``, ``host_in_finish``, else
    ``host_in_loop``)."""
    a, b = profiled["window"]
    busy = busy_intervals(profiled["device"], (a, b))
    edges = [a] + [t for iv in busy for t in iv] + [b]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        label = "host_in_loop"
        for kind in ("finish", "dispatch", "read"):
            if any(x <= mid < y for x, y in profiled["spans"][kind]):
                label = f"host_in_{kind}"
                break
        gaps.append((label, e - s))
    return gaps


def top_device_ops(profiled: dict, n: int = 10) -> list:
    """[name, seconds] of the n device operations that took the most time
    in the profiled part, summed by name (its first 96 characters)."""
    by = {}
    for s, e, name in profiled["device"]:
        by[name[:96]] = by.get(name[:96], 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

