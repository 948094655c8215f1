"""vision_processor entry point, detection path (PyTorch port).

Usage: python -m vision_processor_tpu_torch.app.main [config.yml ...] [--device cpu]

One config runs ``App``; more than one run ``MultiCamApp``
(app/multicam_app.py), every camera on one device.

Counterpart of vision_processor_tpu/app/main.py (reference
src/main.cpp:251-427): read frame -> adopt geometry -> detection path ->
multicast the detection frame, with the one-frame device/host overlap.
Before any geometry arrives the idle path runs: it saves the demosaiced
frame 100 as ``img/<cam_id>.raw.jpg``. With field geometry but no
calibration for this camera the calibration path runs: the frame is
demosaiced on the App's device, calibrated from its field lines on the host
(``calib/``, which imports scipy and cv2 when first used) and the model
broadcast; it is adopted when it comes back over the bus. The debug
outputs (H.264/JPEG stream, debug images, interval snapshots) are not
ported yet; reaching one raises NotImplementedError naming the ROADMAP.md
item that ports it.
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
from ..io.snapshot import SnapshotWriter
from ..net.udp import GCSocket, VisionSocket, get_real_time
from ..ops.cuda import KernelError
from ..ops.frame import quad2rgba, raw2quad
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from ..utils.timing import FrameStats, StageTimer
from .processor import Processor, TrackedArrays

log = get_logger(__name__)

_ROADMAP_DEBUG = "ROADMAP.md, 'Port: debug views, quad2rgba/nv12 and the debug stream (A8)'"


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


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
        self.config = VisionConfig.load(config_path)
        cfg = self.config
        if cfg.stream_active:
            raise _unported("the debug stream (stream.active)", _ROADMAP_DEBUG)
        if cfg.debug_images or cfg.debug_stream_interval_ms > 0:
            raise _unported("debug images and snapshots", _ROADMAP_DEBUG)

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
        self.snapshots = SnapshotWriter()
        self.running = True

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
                self._calibration_path(frame)
                continue
            try:
                if self.processor.perspective.geometry_version:
                    self._detection_path(frame, start, real_start)
                else:
                    self._idle_path(frame, frame_id)
            except (NotImplementedError, KernelError):
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
            self.frame_stats_timer.print_runtimes()
            self.frame_stats_timer.clear()

    def _calibration_path(self, frame):
        """Field geometry without this camera's calibration: calibrate from
        the frame's field lines and broadcast the model on the App's socket
        (JAX app/main.py _calibration_path); the next ``geometry_check``
        adopts it once it comes back over the bus. A calibration that
        finds no model is logged and tried again on the next frame."""
        from ..calib.geometry import geometry_calibration

        rgb = demosaic(frame, self.device)
        model = geometry_calibration(self.config, self.socket.geometry.field, rgb)
        if model is None:
            log.warning("camera %d: no calibration found, trying the next frame",
                        self.config.cam_id)
            return
        self.socket.send(calibration_packet(self.socket.geometry, model,
                                            self.config.cam_id))

    def _idle_path(self, frame, frame_id):
        """No geometry yet: save the demosaiced frame 100 as the sample
        image (JAX app/main.py _idle_path). The stream and the interval
        snapshots, which would demosaic every frame, are refused at
        construction."""
        if frame_id != 100:
            return
        self.snapshots.offer(demosaic(frame, self.device),
                             f"img/{self.config.cam_id}.raw.jpg")
        log.info("Saved sample image")

    def close(self):
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
