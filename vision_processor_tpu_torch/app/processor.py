"""Per-camera frame processor: device step + host finishing (PyTorch port).

Counterpart of vision_processor_tpu/app/processor.py (reference
Resources + main loop, src/Resources.cpp:70-136, src/main.cpp:262-423).
``device_step`` uploads the raw frame and the per-frame state to the
processor's device and enqueues the whole compute path — blob machine,
hypothesis search and, with ``device_finish``, the on-device finisher —
returning tensors that stay on the device. ``finish_frame`` brings the
small result tensors to the host and assembles the protobuf detection
frame (fused path), or runs the host finisher ``HostDetector`` on them.
Everything up to the packet imports without the protobuf bindings: the
packet and ``HostDetector`` import them where they are first used.

Device->host reads inside ``device_step`` (the tier choices of the JAX
package's ``lax.cond``/``lax.switch``): the compaction tier (densest-row
count) and the anchor-window tier (valid-blob count), two per frame.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..models.colors import ColorState
from ..models.detector import DetectorConfig, detect, estimate_bot_ids
from ..models.device_finish import finish_on_device, pack_field_marks
from ..models.perspective import Perspective
from ..ops import blob as B
from ..ops import frame as F
from ..ops.blob_fused import build_kernels
from ..ops.pipeline import BlobMachineConfig, blob_machine, extraction_kernel_shape
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from ..utils.state import to_numpy, to_torch
from .debug_io import DEBUG_VIEWS

log = get_logger(__name__)

BLOB_KEYS = ("pos", "field_pos", "color", "center", "circ", "score", "valid", "count")


def full_step(bm_cfg: BlobMachineConfig, det_cfg: DetectorConfig, raw, packed_cam,
              colors7, tracked, params, rs_grid=None, colors7_ref=None, marks=None):
    """Blob machine + hypothesis search (+ on-device finishing when
    ``marks`` is given): (blobs, det) or (blobs, det, fin), all tensors on
    the input's device. Without ``rs_grid`` the frame is resampled in line
    (the camera projection per flat pixel, kernel E2/E3)."""
    blobs = blob_machine(bm_cfg, raw, packed_cam, params["max_bot_height"],
                         params["min_circularity"], rs_grid=rs_grid)
    det = detect(det_cfg, blobs, tracked, colors7[:6], packed_cam, params)
    det["bot_id_est"] = estimate_bot_ids(det, blobs["color"], colors7)
    out_blobs = {k: blobs[k] for k in BLOB_KEYS}
    if marks is None:
        return out_blobs, det
    fin = finish_on_device(blobs, det, colors7, colors7_ref, packed_cam, marks, params)
    return out_blobs, det, fin


@dataclass
class TrackedArrays:
    """Fixed-shape tracked-bot arrays (numpy) for the device step."""

    id: np.ndarray
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    w: np.ndarray
    vx: np.ndarray
    vy: np.ndarray
    vw: np.ndarray
    time_delta: np.ndarray
    valid: np.ndarray

    @classmethod
    def build(cls, tracked_by_cam: dict, now: float, slots: int) -> "TrackedArrays":
        # one row per robot id, the freshest estimate across cameras
        best: dict[int, object] = {}
        for _cam, entries in sorted(tracked_by_cam.items()):
            for t in entries:
                if t.id == -1:
                    continue  # balls are not searched as constellations
                prev = best.get(t.id)
                if prev is None or t.timestamp > prev.timestamp:
                    best[t.id] = t
        rows = list(best.values())[:slots]
        arr = cls(
            id=np.full(slots, -1, dtype=np.int32),
            x=np.zeros(slots, dtype=np.float32),
            y=np.zeros(slots, dtype=np.float32),
            z=np.zeros(slots, dtype=np.float32),
            w=np.zeros(slots, dtype=np.float32),
            vx=np.zeros(slots, dtype=np.float32),
            vy=np.zeros(slots, dtype=np.float32),
            vw=np.zeros(slots, dtype=np.float32),
            time_delta=np.zeros(slots, dtype=np.float32),
            valid=np.zeros(slots, dtype=bool),
        )
        for i, t in enumerate(rows):
            arr.id[i] = t.id
            arr.x[i] = t.x
            arr.y[i] = t.y
            arr.z[i] = t.z
            arr.w[i] = t.w
            arr.vx[i] = t.vx
            arr.vy[i] = t.vy
            arr.vw[i] = t.vw
            arr.time_delta[i] = now - t.timestamp
            arr.valid[i] = True
        return arr

    def as_dict(self) -> dict:
        return {
            "id": self.id, "x": self.x, "y": self.y, "z": self.z, "w": self.w,
            "vx": self.vx, "vy": self.vy, "vw": self.vw,
            "time_delta": self.time_delta, "valid": self.valid,
        }


class Processor:
    """One camera's full detection stack on an explicit torch device."""

    def __init__(self, config: VisionConfig, socket=None, gc_socket=None,
                 max_tracked: int = 32, device="cuda"):
        self.config = config
        self.socket = socket
        self.gc_socket = gc_socket
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the combo-scoring matmuls need full float32 (the JAX
            # package's Precision.HIGHEST); keep TF32 off explicitly
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.perspective = Perspective(
            cam_id=config.cam_id, geometry_tolerance=config.geometry_tolerance
        )
        self.colors = ColorState(
            orange_ref=np.asarray(config.orange_reference, dtype=np.int64),
            field_ref=np.asarray(config.field_reference, dtype=np.int64),
            yellow_ref=np.asarray(config.yellow_reference, dtype=np.int64),
            blue_ref=np.asarray(config.blue_reference, dtype=np.int64),
            green_ref=np.asarray(config.green_reference, dtype=np.int64),
            pink_ref=np.asarray(config.pink_reference, dtype=np.int64),
            reference_force=config.reference_force,
            history_force=config.history_force,
        )
        self.det_cfg = DetectorConfig(max_blobs=config.max_blobs,
                                      max_tracked=max_tracked)
        self._bm_cfg = None
        self._geom_key = None
        self._grid = None
        self._grid_key = None
        self._marks = None
        self._marks_key = None
        # device-carried color table: each step consumes the previous
        # step's on-device color update directly (serial color semantics
        # even when the App dispatches ahead of host finishing)
        self._colors_dev = None
        self.frame_id = 0

    @functools.cached_property
    def host(self):
        """The host finisher (models/host_detect.py), for ``device_finish`` off."""
        from ..models.host_detect import HostDetector

        return HostDetector(self.config, self.colors, self.perspective)

    def apply_tunables(self) -> None:
        """Propagate hot-reloaded tunables into live state (reference
        src/Resources.cpp:188-214)."""
        cfg = self.config
        self.colors.orange_ref = np.asarray(cfg.orange_reference, dtype=np.int64)
        self.colors.field_ref = np.asarray(cfg.field_reference, dtype=np.int64)
        self.colors.yellow_ref = np.asarray(cfg.yellow_reference, dtype=np.int64)
        self.colors.blue_ref = np.asarray(cfg.blue_reference, dtype=np.int64)
        self.colors.green_ref = np.asarray(cfg.green_reference, dtype=np.int64)
        self.colors.pink_ref = np.asarray(cfg.pink_reference, dtype=np.int64)
        self.colors.reference_force = cfg.reference_force
        self.colors.history_force = cfg.history_force

    # -- geometry -----------------------------------------------------------

    @property
    def max_bot_height(self) -> float:
        return self.gc_socket.max_bot_height if self.gc_socket else 150.0

    def geometry_check(self, width: int, height: int, geometry=None, version=None):
        """Adopt geometry from the socket (or explicit args in offline use)."""
        if geometry is None:
            if self.socket is None:
                return
            self.socket.geometry_check()
            geometry = self.socket.geometry
            version = self.socket.geometry_version
        had_calib = self.perspective.geometry_version
        changed = self.perspective.update_geometry(
            geometry, version, width, height, self.max_bot_height,
            self.config.resampling_factor,
        )
        if changed:
            self._geom_key = None
            if self.device.type == "cuda":
                self._build_extraction_kernel()
            # re-broadcast calib with derived world position when missing
            if self.socket is not None and not had_calib:
                from ..proto import (
                    SSL_SOURCE_VISION_PROCESSOR,
                    SSL_WrapperPacket,
                )

                for calib in geometry.calib:
                    if calib.camera_id == self.config.cam_id and not calib.HasField(
                        "derived_camera_world_tx"
                    ):
                        wrapper = SSL_WrapperPacket()
                        wrapper.source = SSL_SOURCE_VISION_PROCESSOR
                        wrapper.geometry.CopyFrom(geometry)
                        wrapper.geometry.ClearField("calib")
                        wrapper.geometry.calib.append(
                            self.perspective.model.to_proto(self.config.cam_id)
                        )
                        self.socket.send(wrapper)

    def _build_extraction_kernel(self) -> None:
        """Build the blob kernel (B2 or B5) at this geometry's radii now, as
        the geometry is adopted: the radii follow ``field_scale``, and a new
        shape would otherwise run nvcc inside the first detection frame."""
        p = self.perspective
        shape = extraction_kernel_shape(B.gradient_offset(p.max_blob_radius, p.field_scale),
                                        B.sat_radius(p.min_blob_radius, p.field_scale),
                                        B.disc_radius(p.min_blob_radius, p.field_scale))
        if shape is not None:
            build_kernels([shape])

    @property
    def resample_mode(self) -> str | None:
        return None if self._bm_cfg is None else self._bm_cfg.resample_mode

    def _ensure_config(self, fmt: str, raw_shape: tuple):
        key = (fmt, raw_shape, tuple(self.perspective.reprojected_field_size))
        if self._geom_key == key:
            return
        self._bm_cfg = BlobMachineConfig.from_perspective(
            self.perspective, fmt, raw_shape, max_blobs=self.config.max_blobs
        )
        # two-pass warp where the geometry admits it ("auto" on a CUDA
        # device); warp_fits rejects non-separable maps -> gather
        from ..ops.warp import resolve_resample_mode

        mode = resolve_resample_mode(
            self.config.resample_mode,
            [(self.perspective.model, self._bm_cfg.field_scale,
              self._bm_cfg.field_offset, self.max_bot_height)],
            self._bm_cfg.flat_shape, self._bm_cfg.plane_shape, self.device,
        )
        if mode != self._bm_cfg.resample_mode:
            self._bm_cfg = replace(self._bm_cfg, resample_mode=mode)
        self._geom_key = key
        log.info("Configured pipeline for %s raw=%s flat=%s mode=%s", fmt,
                 raw_shape, self._bm_cfg.flat_shape, mode)

    # -- per-frame ----------------------------------------------------------

    def params(self) -> dict:
        """Per-frame scalar parameters (numpy float32), the JAX package's keys."""
        field = self.perspective.field
        f32 = np.float32
        return {
            "max_bot_height": f32(self.max_bot_height),
            "min_circularity": f32(self.config.min_circularity),
            "max_robot_radius": f32(field.max_robot_radius or 90.0),
            "min_tracking_radius": f32(self.config.min_tracking_radius),
            "max_bot_acceleration": f32(self.config.max_bot_acceleration),
            "min_confidence": f32(self.config.min_confidence),
            "clipping_tolerance": f32(self.config.clipping_tolerance),
            "color_plausibility_veto": f32(
                1.0 if self.config.color_plausibility_veto else 0.0),
            "ball_radius": f32(field.ball_radius or 21.5),
            "min_score": f32(self.config.min_score),
            "min_cam_edge_distance": f32(self.config.min_cam_edge_distance),
            "reference_force": f32(self.colors.reference_force),
            "history_force": f32(self.colors.history_force),
            "bot_heights_yb": np.asarray(
                [
                    self.gc_socket.yellow_bot_height if self.gc_socket else 145.0,
                    self.gc_socket.blue_bot_height if self.gc_socket else 145.0,
                ],
                dtype=np.float32,
            ),
        }

    def _resample_grid(self, packed_cam: torch.Tensor) -> dict:
        """Frame-invariant sampling geometry, recomputed on calibration /
        geometry / bot-height change only."""
        packed = self.perspective.model.packed()
        key = (self._bm_cfg, packed.tobytes(), float(self.max_bot_height))
        if self._grid_key != key:
            self._grid = self._bm_cfg.make_resample_grid(
                packed_cam, float(self.max_bot_height))
            self._grid_key = key
        return self._grid

    def _field_marks(self) -> dict:
        """Packed field-marking tensors, cached per geometry version."""
        key = (self.perspective.geometry_version,
               float(self.config.geometry_tolerance))
        if self._marks_key != key:
            self._marks = to_torch(
                pack_field_marks(self.perspective.field,
                                 self.config.geometry_tolerance),
                self.device,
            )
            self._marks_key = key
        return self._marks

    def device_step(self, raw: np.ndarray, fmt: str, tracked: TrackedArrays):
        """Enqueue the step on the device; returns device tensors."""
        self._ensure_config(fmt, tuple(raw.shape))
        state = to_torch(
            {
                "packed": self.perspective.model.packed(),
                "colors": self.colors.packed(),
                "refs": self.colors.packed_refs(),
                "tracked": tracked.as_dict(),
                "params": self.params(),
            },
            self.device,
        )
        raw_t = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        grid = self._resample_grid(state["packed"])
        if not self.config.device_finish:
            return full_step(self._bm_cfg, self.det_cfg, raw_t, state["packed"],
                             state["colors"], state["tracked"], state["params"], grid)
        colors_in = self._colors_dev if self._colors_dev is not None else state["colors"]
        out = full_step(self._bm_cfg, self.det_cfg, raw_t, state["packed"], colors_in,
                        state["tracked"], state["params"], grid, state["refs"],
                        self._field_marks())
        self._colors_dev = out[2]["colors7"]
        return out

    def _frame_shell(self, t_capture: float, t_capture_camera: float):
        from ..proto import (
            SSL_SOURCE_VISION_PROCESSOR,
            SSL_WrapperPacket,
        )

        self.frame_id += 1
        wrapper = SSL_WrapperPacket()
        wrapper.source = SSL_SOURCE_VISION_PROCESSOR
        frame = wrapper.detection
        frame.frame_number = self.frame_id
        frame.t_capture = t_capture
        if t_capture_camera:
            frame.t_capture_camera = t_capture_camera
        frame.camera_id = self.config.cam_id
        return wrapper, frame

    def finish_frame_fused(self, device_out, t_capture: float,
                           t_capture_camera: float = 0.0):
        """Protobuf-only host finishing for the on-device finisher."""
        blobs, det, fin = to_numpy(tuple(device_out))
        self.colors.adopt_packed(fin["colors7"])

        wrapper, frame = self._frame_shell(t_capture, t_capture_camera)
        ids = fin["bot_id"]
        world = fin["bot_world"]
        pix = fin["bot_pixel"]
        orient = fin["bot_orientation"]
        score = fin["bot_score"]
        for i in np.flatnonzero(fin["bot_valid"]):
            bid = int(ids[i])
            entry = frame.robots_yellow.add() if bid < 16 else frame.robots_blue.add()
            entry.confidence = float(score[i])
            entry.robot_id = bid % 16
            entry.x = float(world[i, 0])
            entry.y = float(world[i, 1])
            entry.height = float(world[i, 2])
            entry.orientation = float(orient[i])
            entry.pixel_x = float(pix[i, 0])
            entry.pixel_y = float(pix[i, 1])
        bworld = fin["ball_world"]
        bpix = fin["ball_pixel"]
        bscore = fin["ball_score"]
        for j in np.flatnonzero(fin["ball_valid"]):
            entry = frame.balls.add()
            entry.confidence = float(bscore[j])
            entry.x = float(bworld[j, 0])
            entry.y = float(bworld[j, 1])
            entry.pixel_x = float(bpix[j, 0])
            entry.pixel_y = float(bpix[j, 1])

        if self.socket is not None:
            for off in self.socket.get_received_offsets():
                frame.t_offsets.append(off)
        return wrapper, blobs, det

    def finish_frame(self, device_out, t_capture: float, t_capture_camera: float = 0.0):
        """Host finishing: colors, ids, filters, protobuf."""
        if len(device_out) == 3:
            return self.finish_frame_fused(device_out, t_capture, t_capture_camera)
        blobs, det = to_numpy(tuple(device_out))

        max_bot_height = self.max_bot_height
        bots = self.host.build_bots(det, blobs)
        balls = self.host.build_balls(det, blobs)
        self.host.update_colors(bots, balls, max_bot_height)
        self.host.recalc_post_color(bots, balls)
        balls = self.host.filter_balls(balls, max_bot_height)

        wrapper, frame = self._frame_shell(t_capture, t_capture_camera)
        heights = {
            "yellow": self.gc_socket.yellow_bot_height if self.gc_socket else 145.0,
            "blue": self.gc_socket.blue_bot_height if self.gc_socket else 145.0,
        }
        self.host.emit(frame, bots, balls, heights, max_bot_height)
        if self.socket is not None:
            for off in self.socket.get_received_offsets():
                frame.t_offsets.append(off)
        return wrapper, blobs, det

    def debug_views(self, raw: np.ndarray, fmt: str, keys=DEBUG_VIEWS) -> dict:
        """Render the debug views (raw demosaic, flat dRGB, gradient,
        circularity) as (H, W, 3) uint8 RGB numpy images for streaming and
        snapshots (reference src/main.cpp:377-403; JAX
        app/processor.py debug_views), from the current camera model and
        bot height, in plain PyTorch on the processor's device. Only the
        views in ``keys`` are computed and brought to the host."""
        cfg = self._bm_cfg
        if cfg is None:
            raise RuntimeError("debug_views requires a configured pipeline")

        def u8(x):
            return x.clamp(0, 255).to(torch.uint8)

        def gray(x):
            return torch.stack([u8(x)] * 3, dim=-1)

        raw_t = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        planes = F.raw2quad(raw_t, cfg.fmt)
        out = {}
        if "raw_rgb" in keys:
            out["raw_rgb"] = u8(F.quad2rgba(planes, cfg.fmt))
        if any(k in keys for k in ("flat_rgb", "grad_rgb", "circ_rgb")):
            packed = torch.from_numpy(self.perspective.model.packed()).to(
                self.device, torch.float32)
            maxh = torch.tensor(self.max_bot_height, dtype=torch.float32,
                                device=self.device)
            flat = F.resample_flat(planes, packed, maxh, cfg.field_scale,
                                   cfg.field_offset, cfg.flat_shape, cfg.fmt)
            if "flat_rgb" in keys:
                out["flat_rgb"] = u8(flat)
            grad = B.gradient_dot(flat, cfg.grad_offset)
            if "grad_rgb" in keys:
                out["grad_rgb"] = gray(grad * 0.25 + 128.0)
            if "circ_rgb" in keys:
                circ = B.circularity(B.summed_area_table(grad), cfg.sat_radius)
                out["circ_rgb"] = gray(circ + 127.0)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def process_frame(self, frame, tracked_by_cam=None, now=None):
        """Full synchronous frame: device step + host finishing. Returns
        (wrapper, blobs, det), as ``finish_frame`` does."""
        if now is None:
            now = frame.timestamp
        if tracked_by_cam is None:
            tracked_by_cam = self.socket.get_tracked_objects() if self.socket else {}
        tracked = TrackedArrays.build(tracked_by_cam, now, self.det_cfg.max_tracked)
        out = self.device_step(frame.data, frame.fmt, tracked)
        return self.finish_frame(out, now, frame.timestamp)
