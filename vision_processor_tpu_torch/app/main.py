"""vision_processor entry point, detection path (PyTorch port).

Usage: python -m vision_processor_tpu_torch.app.main [config.yml ...] [--device cpu]

One config runs ``App``; more than one run ``MultiCamApp``
(app/multicam_app.py), every camera on one device.

Counterpart of vision_processor_tpu/app/main.py (reference
src/main.cpp:251-427): read frame -> adopt geometry -> detection path ->
multicast the detection frame, with the one-frame device/host overlap, then
the debug side channels: the RTP stream of one debug view (``io/rtp.py``)
and the interval snapshots ``img/<cam_id>.{raw,flat,gradient,blob}.jpg``
(``app/debug_io.py``, views rendered on the App's device), and with
``debug_images`` the ``.flat.1.png``, ``.gradDot.1.png`` and
``.blob.1.png`` of the first detection frame (all relative to the working
directory). Before any geometry arrives the idle path streams the
demosaiced frame, snapshots it on the interval and saves frame 100 as
``img/<cam_id>.raw.jpg``. With field geometry but no calibration for this
camera the calibration path runs: the frame is demosaiced on the App's
device, calibrated from its field lines on the host (``calib/``, which
imports scipy and cv2 when first used), the model broadcast and the frame
snapshotted on the interval; the model is adopted when it comes back over
the bus.
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from ..io.camera import open_camera
from ..io.rtp import RTPStreamer
from ..io.snapshot import SnapshotWriter
from ..net.udp import GCSocket, VisionSocket, get_real_time
from ..ops.cuda import DEVICE_ERRORS, require_device
from ..ops.frame import quad2rgba, raw2quad
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from ..utils.timing import RECORDER, FrameStats, StageTimer, log_means
from .debug_io import emit_debug_views, emit_idle_raw, snapshot_due
from .processor import Processor, TrackedArrays

log = get_logger(__name__)


def demosaic(frame, device) -> np.ndarray:
    """The raw frame demosaiced on ``device`` (``raw2quad`` then
    ``quad2rgba``), brought to the host: (H, W, 3) float32 RGB."""
    raw = torch.from_numpy(frame.data).to(device)
    return quad2rgba(raw2quad(raw, frame.fmt), frame.fmt).cpu().numpy()


def calibration_packet(geometry, model, cam_id: int):
    """The SSL_WrapperPacket that broadcasts ``model`` as camera ``cam_id``'s
    calibration: the received geometry with that calibration alone."""
    from ..proto import SSL_SOURCE_VISION_PROCESSOR, SSL_WrapperPacket

    wrapper = SSL_WrapperPacket()
    wrapper.source = SSL_SOURCE_VISION_PROCESSOR
    wrapper.geometry.CopyFrom(geometry)
    wrapper.geometry.ClearField("calib")
    wrapper.geometry.calib.append(model.to_proto(cam_id))
    return wrapper


class App:
    def __init__(self, config_path: str | None, device="cuda"):
        require_device(device)
        self.config = VisionConfig.load(config_path)
        cfg = self.config

        heights_path = Path(cfg.bot_heights_file)
        if heights_path.exists():
            bot_heights = yaml.safe_load(heights_path.read_text()) or {}
        else:
            bot_heights = {}
        self.gc_socket = GCSocket(cfg.gc_ip, cfg.gc_port, bot_heights)
        self.socket = VisionSocket(
            cfg.vision_ip, cfg.vision_port, cfg.cam_id,
            self.gc_socket.default_bot_height,
        )
        self.camera = open_camera(cfg.camera)
        self.device = torch.device(device)
        self.processor = Processor(cfg, self.socket, self.gc_socket, device=self.device)
        self.streamer = RTPStreamer(cfg.stream_active, cfg.stream_url(), qp=cfg.stream_qp,
                                    bitrate_kbps=cfg.stream_bitrate_kbps, gop=cfg.stream_gop)
        self.snapshots = SnapshotWriter()
        self.running = True
        self._last_snapshot = 0.0

        self.frame_stats = FrameStats()
        self.frame_stats_timer = StageTimer(self.device)
        self.benchmark = os.environ.get("VPTPU_BENCHMARK", "") == "1"
        # one-frame device/host overlap: enqueue frame n+1 before finishing
        # frame n on the host; VPTPU_PIPELINE=0 restores the frame-serial loop
        self.pipeline = os.environ.get("VPTPU_PIPELINE", "1") != "0"
        self._pending = None

        if cfg.wait_for_geometry:
            log.info("Waiting for geometry...")
            while self.socket.geometry_version == 0:
                self.socket.geometry_check()
                time.sleep(0.001)

    def stop(self, *_):
        self.running = False

    def run(self):
        frame_id = 0
        if self.benchmark:
            RECORDER.enable()
        while self.running:
            if self.config.reload_if_changed():
                self.processor.apply_tunables()
            frame = self.camera.read_image()
            if frame is None:
                break
            frame_id += 1
            start = self.camera.get_time()
            real_start = get_real_time()

            self.processor.geometry_check(frame.width, frame.height)

            if not self.processor.perspective.geometry_version and self.socket.geometry_version:
                # outside the per-frame guard: a failure of the demosaic on
                # the card or of the calibration code ends run()
                self._calibration_path(frame, real_start)
                continue
            try:
                if self.processor.perspective.geometry_version:
                    self._detection_path(frame, start, real_start)
                else:
                    self._idle_path(frame, frame_id, real_start)
            except (NotImplementedError, *DEVICE_ERRORS):
                raise
            except Exception:  # keep the camera loop alive on transient
                log.exception("frame %d failed, continuing", frame_id)
                self._pending = None

        if self._pending is not None:
            device_out, start, ts = self._pending
            self._pending = None
            wrapper, _, _ = self.processor.finish_frame(device_out, start, ts)
            wrapper.detection.t_sent = self.camera.get_time()
            self.socket.send(wrapper)

        log.info("Stopping vision_processor")
        self.close()

    def _detection_path(self, frame, start, real_start):
        tracked = TrackedArrays.build(
            self.socket.get_tracked_objects(), start,
            self.processor.det_cfg.max_tracked,
        )
        with self.frame_stats_timer.stage("device_step"):
            device_out = self.processor.device_step(frame.data, frame.fmt, tracked)
        if self.pipeline:
            pending, self._pending = self._pending, (device_out, start, frame.timestamp)
            if pending is None:
                return
            device_out, start, ts = pending
        else:
            ts = frame.timestamp
        with self.frame_stats_timer.stage("host_finish"):
            wrapper, blobs, det = self.processor.finish_frame(device_out, start, ts)
        wrapper.detection.t_sent = self.camera.get_time()
        self.socket.send(wrapper)
        self.socket.update_time()

        if self.config.debug_images and self.processor.frame_id == 1:
            import cv2

            views = self.processor.debug_views(frame.data, frame.fmt,
                                               ("flat_rgb", "grad_rgb", "circ_rgb"))
            for name, key in (("flat", "flat_rgb"), ("gradDot", "grad_rgb"),
                              ("blob", "circ_rgb")):
                cv2.imwrite(f".{name}.1.png", views[key][..., ::-1])

        processing = get_real_time() - real_start
        overrun = self.frame_stats.add(processing, self.camera.expected_frametime())
        if overrun:
            log.info(
                "frame time overrun: %.1f ms, %d blobs, %d balls, %d bots",
                processing * 1e3,
                int(blobs["count"]),
                len(wrapper.detection.balls),
                len(wrapper.detection.robots_yellow)
                + len(wrapper.detection.robots_blue),
            )
        if self.benchmark and self.processor.frame_id % 100 == 0:
            log.info("frame stats: %s", self.frame_stats.summary())
            log_means(RECORDER.drain())

        self._stream_and_snapshot(frame, real_start)

    def _calibration_path(self, frame, real_start):
        """Field geometry without this camera's calibration: calibrate from
        the frame's field lines and broadcast the model on the App's socket
        (JAX app/main.py _calibration_path); the next ``geometry_check``
        adopts it once it comes back over the bus. A calibration that
        finds no model is logged and tried again on the next frame. The
        demosaiced frame is snapshotted on the interval either way."""
        from ..calib.geometry import geometry_calibration

        rgb = demosaic(frame, self.device)
        model = geometry_calibration(self.config, self.socket.geometry.field, rgb)
        if model is None:
            log.warning("camera %d: no calibration found, trying the next frame",
                        self.config.cam_id)
        else:
            self.socket.send(calibration_packet(self.socket.geometry, model,
                                                self.config.cam_id))
        self._maybe_snapshot_raw(rgb, real_start)

    def _idle_path(self, frame, frame_id, real_start):
        """No geometry yet: stream the demosaiced frame so the operator can
        aim the camera, snapshot it on the interval, and save frame 100 as
        the sample image (JAX app/main.py _idle_path)."""
        self._last_snapshot = emit_idle_raw(
            self.streamer, self.snapshots, self.config, frame, real_start,
            self._last_snapshot, self.device, force_snapshot=frame_id == 100,
        )
        if frame_id == 100:
            log.info("Saved sample image")

    # -- debug output -------------------------------------------------------

    def _stream_and_snapshot(self, frame, real_start):
        self._last_snapshot = emit_debug_views(
            self.processor, self.streamer, self.snapshots, self.config,
            frame, self.camera.get_time(), real_start, self._last_snapshot,
        )

    def _maybe_snapshot_raw(self, rgb, real_start):
        if snapshot_due(self.config, real_start, self._last_snapshot):
            self.snapshots.offer(rgb, f"img/{self.config.cam_id}.raw.jpg")
            self._last_snapshot = real_start

    def close(self):
        if self.benchmark:
            RECORDER.disable()
        self.streamer.close()
        self.snapshots.close()
        self.socket.close()
        self.gc_socket.close()
        self.camera.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", nargs="*", default=["config.yml"],
                        help="one config per camera (default config.yml)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; pass cpu to run on the CPU)")
    args = parser.parse_args(argv)
    if len(args.config) > 1:
        from .multicam_app import MultiCamApp  # it imports this module

        app = MultiCamApp(args.config, device=args.device)
    else:
        app = App(args.config[0], device=args.device)
    signal.signal(signal.SIGTERM, app.stop)
    signal.signal(signal.SIGINT, app.stop)
    app.run()


if __name__ == "__main__":
    main()
