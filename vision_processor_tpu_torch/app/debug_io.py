"""Debug side channels shared by the single- and multi-camera apps (PyTorch
port).

Counterpart of vision_processor_tpu/app/debug_io.py. The reference's
per-process loop streams one of four cycling debug views over RTP and dumps
periodic JPEG snapshots for the wrapper UI (reference src/main.cpp:377-403;
wrapper_backend/service.py serves ``img/<cam>.{raw,flat,gradient,blob}.jpg``).
The views are rendered on the processor's device (``Processor.debug_views``)
and only the ones a call needs are brought to the host.
"""
from __future__ import annotations

import numpy as np

DEBUG_VIEWS = ["raw_rgb", "flat_rgb", "grad_rgb", "circ_rgb"]


def snapshot_due(cfg, real_start: float, last_snapshot: float) -> bool:
    return (
        cfg.debug_stream_interval_ms > 0
        and (real_start - last_snapshot) * 1e3 >= cfg.debug_stream_interval_ms
    )


def emit_debug_views(processor, streamer, snapshots, cfg, frame,
                     view_time: float, real_start: float,
                     last_snapshot: float) -> float:
    """Render the debug views for one camera and feed the stream (raw
    feed, or the 20 s view cycle) and/or the snapshot writer.
    Returns the updated last-snapshot timestamp."""
    want_stream = streamer.active
    want_snapshot = snapshot_due(cfg, real_start, last_snapshot)
    if not (want_stream or want_snapshot):
        return last_snapshot

    if cfg.raw_feed:
        view = "raw_rgb"
    else:
        # cycle the 4 debug views every 20 s like the reference
        view = DEBUG_VIEWS[int(view_time / 20.0) % 4]
    out = processor.debug_views(frame.data, frame.fmt,
                                DEBUG_VIEWS if want_snapshot else (view,))
    if want_stream:
        streamer.send_frame(out[view])
    if want_snapshot:
        prefix = f"img/{cfg.cam_id}."
        snapshots.offer(out["raw_rgb"], prefix + "raw.jpg")
        snapshots.offer(out["flat_rgb"], prefix + "flat.jpg")
        snapshots.offer(out["grad_rgb"], prefix + "gradient.jpg")
        snapshots.offer(out["circ_rgb"], prefix + "blob.jpg")
        return real_start
    return last_snapshot


def emit_idle_raw(streamer, snapshots, cfg, frame, real_start: float,
                  last_snapshot: float, device, force_snapshot: bool = False) -> float:
    """Pre-calibration view: demosaic the raw frame on ``device``, stream it
    so the operator can aim the camera, snapshot on interval (or forced).
    A frame that is neither streamed nor saved is not demosaiced.
    Returns the updated last-snapshot timestamp."""
    from .main import demosaic

    due = force_snapshot or snapshot_due(cfg, real_start, last_snapshot)
    if not (streamer.active or due):
        return last_snapshot
    rgb = demosaic(frame, device)
    streamer.send_frame(rgb.astype(np.uint8))
    if due:
        snapshots.offer(rgb, f"img/{cfg.cam_id}.raw.jpg")
        return real_start
    return last_snapshot
