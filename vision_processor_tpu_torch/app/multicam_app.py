"""Production multi-camera mode: N cameras on one card (PyTorch port).

Counterpart of vision_processor_tpu/app/multicam_app.py.
``python -m vision_processor_tpu_torch.app.main cfg0.yml cfg1.yml ...``
(more than one config) drives every camera through ``parallel.multicam``
instead of one process per camera, the reference's architecture (reference
README architecture diagram). Each camera keeps its own multicast socket,
geometry, colour state and host finishing, so the wire sees N reference
processes.

Tracking input comes from the UDP tracker (full fleet state, finite-
difference velocities), not from the device summary loop: host-side id
assignment stays authoritative (reference src/udpsocket.cpp:204-256).

Until every camera is calibrated the fleet waits: a camera without
geometry idles, and a camera with field geometry and no calibration is
calibrated from its frame (``App``'s calibration path, camera by camera)
and its model broadcast. An explicit ``camera_height: 0.0`` in some config
of a fleet of two or more asks for the rig-height solve from camera pairs
(``calib/pair.py``): robot detections seen by two cameras are gathered
until there are ``_height_obs_target`` of them, and the solved height is
broadcast once. Both import scipy (``calib/``) only when they run. Not
ported yet, and refused where they would run: the debug stream, debug
images and snapshots, and with them the idle views (ROADMAP A2).
The staggered plan enqueues every camera's core on the current stream; one
stream per camera is ROADMAP D1.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import yaml

from ..io.camera import open_camera
from ..models.detector import DetectorConfig
from ..models.device_finish import pack_field_marks
from ..net.udp import GCSocket, VisionSocket, get_real_time
from ..ops import blob as B
from ..ops.cuda import KernelError
from ..ops.pipeline import BlobMachineConfig
from ..ops.warp import resolve_resample_mode
from ..parallel.multicam import (
    _PER_CAMERA_PARAM_KEYS, MultiCamConfig, _cam, _stack, batched_step_host_tracked,
    make_resample_grids, params_for_cam, percam_core_step, staggered_tail_step,
)
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from ..utils.state import to_numpy, to_torch
from .main import _ROADMAP_DEBUG, _unported, calibration_packet, demosaic
from .processor import Processor, TrackedArrays

log = get_logger(__name__)


def free_height_cameras(configs) -> set:
    """Camera indices whose height the pair solver may move: every camera
    but those with an operator-measured nonzero camera_height. A camera
    whose geometry section omits camera_height carries an arbitrary height
    from the ill-conditioned single-camera fit; anchoring on it would pin
    the rig solve to a wrong value, so it is free too."""
    return {i for i, c in enumerate(configs)
            if not (c.camera_height_set and c.camera_height != 0.0)}


class MultiCamApp:
    """N-camera production loop on one card."""

    def __init__(self, config_paths: list[str], device="cuda"):
        configs = [VisionConfig.load(p) for p in config_paths]
        cfg0 = configs[0]
        heights_path = Path(cfg0.bot_heights_file)
        bot_heights = (yaml.safe_load(heights_path.read_text()) or {}
                       if heights_path.exists() else {})
        self._setup(configs, device)
        self.gc_socket = GCSocket(cfg0.gc_ip, cfg0.gc_port, bot_heights)
        # one socket per camera, matching the reference's per-process buses
        self.sockets = [
            VisionSocket(c.vision_ip, c.vision_port, c.cam_id,
                         self.gc_socket.default_bot_height)
            for c in configs
        ]
        self.processors = [Processor(c, s, self.gc_socket, device=self.device)
                           for c, s in zip(configs, self.sockets)]
        self.cameras = [open_camera(c.camera) for c in configs]
        if cfg0.wait_for_geometry:
            log.info("Waiting for geometry on %d sockets...", self.n_cams)
            while any(s.geometry_version == 0 for s in self.sockets):
                for s in self.sockets:
                    s.geometry_check()
                time.sleep(0.001)

    @classmethod
    def offline(cls, configs: list[VisionConfig], device="cuda") -> "MultiCamApp":
        """The fleet without sockets or cameras, for a caller that brings its
        own frames: it adopts geometry through
        ``processors[c].geometry_check(width, height, geometry, version)``,
        passes the tracked prior to ``dispatch_frames``, and gets the
        wrappers back from ``finish_frames`` unsent."""
        app = cls.__new__(cls)
        app._setup(configs, device)
        app.gc_socket = None
        app.sockets = []
        app.processors = [Processor(c, device=app.device) for c in configs]
        app.cameras = []
        return app

    def _setup(self, configs: list[VisionConfig], device) -> None:
        """State shared by the wired and the offline fleet."""
        for c in configs:
            if c.stream_active:
                raise _unported("the debug stream (stream.active)", _ROADMAP_DEBUG)
            if c.debug_images or c.debug_stream_interval_ms > 0:
                raise _unported("debug images and snapshots", _ROADMAP_DEBUG)
        # rig-height calibration (reference config.yml: `camera_height: 0.0`
        # calibrates the height; one camera's fit cannot separate height
        # from focal length for a near-nadir view): from two or more
        # cameras, the pair solver of calib/pair.py fits it to robots seen
        # in the overlaps, once, and the refined calibrations are broadcast
        # like any other. Only an explicit `camera_height: 0.0` asks for it:
        # a missing geometry section also reads 0.0, and forcing one height
        # on a rig whose cameras hang at different heights would spoil good
        # calibrations.
        self._pair_height_active = len(configs) >= 2 and any(
            c.camera_height == 0.0 and c.camera_height_set for c in configs)
        self._height_obs: list = []
        self._height_obs_target = 32
        self.configs = configs
        self.n_cams = len(configs)
        self.device = torch.device(device)
        self.running = True
        self._geom_key = None
        self._grid_key = None
        self._grids = None
        self._marks_key = None
        self._marks = None
        # +1 worker: a stale camera's in-flight blocking read must not
        # take a slot from the healthy cameras' reads and finishing
        self._pool = ThreadPoolExecutor(self.n_cams + 1)
        # one-frame device/host overlap, as in the single-camera App:
        # dispatch frame-set n+1 before finishing n on the host; with the
        # on-device finisher the colour chain is carried on the card, so
        # colour evolution keeps serial semantics. VPTPU_PIPELINE=0 is the
        # reference's frame-serial loop.
        self.pipeline = os.environ.get("VPTPU_PIPELINE", "1") != "0"
        # staggered dispatch: camera c's core (blob machine + hypothesis
        # search) is enqueued as soon as its frame is uploaded, then one
        # batched tail (NMS, ids, finisher). Default: on in the
        # frame-serial mode, off when pipelining already hides the upload.
        stag = os.environ.get("VPTPU_STAGGERED")
        self.staggered = (stag != "0") if stag is not None else not self.pipeline
        self._pending = None
        self._colors_dev = None
        # outage state: last good frame per camera (keeps the batch's shape
        # through an outage), the previous iteration's stale flags, and the
        # in-flight reads of stale cameras
        self._last_frames = None
        self._stale_prev = [False] * self.n_cams
        self._read_pending: dict = {}

    def stop(self, *_):
        self.running = False

    # -- configuration ------------------------------------------------------

    def _ensure_step(self, fmt: str, raw_shape: tuple) -> bool:
        persp = [p.perspective for p in self.processors]
        # geometry_version is in the key, so a recalibration that keeps the
        # reprojected sizes still re-resolves the resample mode
        key = (fmt, tuple(raw_shape), tuple(pp.geometry_version for pp in persp),
               tuple(tuple(pp.reprojected_field_size) for pp in persp))
        if self._geom_key == key:
            return True
        if any(pp.geometry_version == 0 for pp in persp):
            return False  # every camera must be calibrated first
        ref = persp[0]
        bm = BlobMachineConfig(
            fmt=fmt,
            raw_shape=tuple(raw_shape),
            flat_shape=(max(int(pp.reprojected_field_size[1]) for pp in persp),
                        max(int(pp.reprojected_field_size[0]) for pp in persp)),
            field_scale=float(ref.field_scale),
            field_offset=(0.0, 0.0),
            grad_offset=B.gradient_offset(ref.max_blob_radius, ref.field_scale),
            sat_radius=B.sat_radius(ref.min_blob_radius, ref.field_scale),
            disc_radius=B.disc_radius(ref.min_blob_radius, ref.field_scale),
            max_blobs=self.configs[0].max_blobs,
        )
        # the batch shares one resample mode: "auto" takes the warp only
        # when every camera's geometry admits it
        mode = resolve_resample_mode(
            self.configs[0].resample_mode,
            [(pp.model, pp.field_scale,
              (pp.visible_field_extent[0], pp.visible_field_extent[2]),
              float(proc.max_bot_height))
             for pp, proc in zip(persp, self.processors)],
            bm.flat_shape, bm.plane_shape, self.device,
        )
        bm = replace(bm, resample_mode=mode)
        det = DetectorConfig(max_blobs=bm.max_blobs,
                             max_tracked=self.processors[0].det_cfg.max_tracked)
        self.mc_cfg = MultiCamConfig(bm=bm, det=det, n_cams=self.n_cams)
        self._step = batched_step_host_tracked(self.mc_cfg)
        self._core_step = percam_core_step(self.mc_cfg)
        self._tail_step = staggered_tail_step(self.mc_cfg)
        self._geom_key = key
        log.info("Configured %d-camera pipeline: raw=%s flat=%s max_blobs=%d mode=%s",
                 self.n_cams, raw_shape, bm.flat_shape, bm.max_blobs, mode)
        return True

    # -- per frame-set ------------------------------------------------------

    def _read_all(self):
        """Read the next frame from every camera concurrently.

        A camera already in outage (stale) is read without blocking: its
        read stays in flight and is polled next frame-set, so a dead
        camera's driver timeout slows the fleet for at most the one
        frame-set in which it first fails. A healthy camera's read is
        bounded too (2x its frame time, at least 5 s) once the fleet has
        delivered a complete frame-set; before that, reads block.

        Returns ``(frames, pending)``: ``frames[c]`` is None when camera c
        delivered nothing this set; ``pending[c]`` is True when that None is
        an in-flight read, False when the read completed with None (end of
        stream)."""
        futs = {}
        for c, cam in enumerate(self.cameras):
            pending = self._read_pending.get(c)
            futs[c] = pending if pending is not None else self._pool.submit(cam.read_image)
        frames, pending = [], []
        for c in range(self.n_cams):
            f = futs[c]
            if self._stale_prev[c] and not f.done():
                self._read_pending[c] = f  # poll again next frame-set
                frames.append(None)
                pending.append(True)
                continue
            if not self._stale_prev[c] and self._last_frames is not None:
                budget = self.cameras[c].expected_frametime() or (1.0 / 30.0)
                try:
                    frame = f.result(timeout=max(2.0 * budget, 5.0))
                except FutTimeout:
                    # first failing read: outage, the read left in flight
                    self._read_pending[c] = f
                    frames.append(None)
                    pending.append(True)
                    continue
            else:
                frame = f.result()
            self._read_pending.pop(c, None)
            frames.append(frame)
            pending.append(False)
        return frames, pending

    def _fleet_params(self) -> dict:
        """Merged per-frame params (numpy): per-camera tunables become (N,)
        arrays, so every camera keeps its own thresholds (reference
        src/Resources.cpp:188-214); field- and GC-derived values stay
        shared scalars (one field, one game controller)."""
        per = [p.params() for p in self.processors]
        out = dict(per[0])
        for k in _PER_CAMERA_PARAM_KEYS:
            out[k] = np.array([float(p[k]) for p in per], dtype=np.float32)
        return out

    def _device_inputs(self, tracked: TrackedArrays):
        """The frame-set's inputs on the card: (state, grids). ``state``
        holds the stacked packed cameras, scales, offsets, colour tables
        and reference colours, the tracked prior and the fleet params, in
        one host->device copy per dtype. The sampling grids and field
        markings are cached and rebuilt when a projection input changes."""
        procs = self.processors
        packed = np.stack([p.perspective.model.packed() for p in procs]).astype(np.float32)
        scales = np.array([p.perspective.field_scale for p in procs], dtype=np.float32)
        offsets = np.array([[p.perspective.visible_field_extent[0],
                             p.perspective.visible_field_extent[2]] for p in procs],
                           dtype=np.float32)
        # the grid key covers every projection input: per-camera scales and
        # offsets too, since an extent shift can keep the flat shape
        maxh = float(procs[0].max_bot_height)
        grid_key = (self.mc_cfg.bm, packed.tobytes(), scales.tobytes(),
                    offsets.tobytes(), maxh)
        if self._grid_key != grid_key:
            self._grids = make_resample_grids(self.mc_cfg, packed, maxh, scales, offsets,
                                              self.device)
            self._grid_key = grid_key
        if self.configs[0].device_finish:
            marks_key = (self.mc_cfg.bm,
                         tuple(p.perspective.geometry_version for p in procs),
                         tuple(c.geometry_tolerance for c in self.configs))
            if self._marks_key != marks_key:
                per_cam = [pack_field_marks(p.perspective.field, c.geometry_tolerance)
                           for p, c in zip(procs, self.configs)]
                self._marks = to_torch({k: np.stack([m[k] for m in per_cam])
                                        for k in per_cam[0]}, self.device)
                self._marks_key = marks_key
        else:
            self._marks = None
        state = to_torch({
            "packed": packed, "scales": scales, "offsets": offsets,
            "colors": np.stack([p.colors.packed() for p in procs]),
            "refs": np.stack([p.colors.packed_refs() for p in procs]),
            "tracked": tracked.as_dict(),
            "params": self._fleet_params(),
        }, self.device)
        return state, self._grids

    def dispatch_frames(self, frames, now: float, tracked: TrackedArrays | None = None):
        """Enqueue one frame-set on the card. Returns the device outputs
        (blobs, det, fin) with a leading camera axis (``fin`` None without
        on-device finishing), or None while a camera is uncalibrated.
        ``tracked``: the fleet's tracked prior; by default built from the
        wire (the first socket's tracker)."""
        fmt = frames[0].fmt
        if not self._ensure_step(fmt, frames[0].data.shape):
            return None
        if tracked is None:
            tracked = TrackedArrays.build(self.sockets[0].get_tracked_objects(), now,
                                          self.processors[0].det_cfg.max_tracked)
        state, grids = self._device_inputs(tracked)
        colors, refs = state["colors"], None
        if self._marks is not None:
            # the colour chain carried on the card (Processor._colors_dev's
            # batched counterpart)
            if self._colors_dev is not None:
                colors = self._colors_dev
            refs = state["refs"]
        if self.staggered:
            blobs, det, fin = self._dispatch_staggered(frames, state, colors, grids, refs)
        else:
            raws = torch.from_numpy(np.stack([f.data for f in frames])).to(self.device)
            out = self._step(raws, state["packed"], state["scales"], state["offsets"],
                             colors, state["tracked"], state["params"], grids, refs,
                             self._marks)
            blobs, det, fin = out if self._marks is not None else (*out, None)
        if fin is not None:
            self._colors_dev = fin["colors7"]
        return blobs, det, fin

    def _dispatch_staggered(self, frames, state, colors, grids, refs):
        """Per-camera cores, each enqueued once its own frame is uploaded,
        then one batched tail: equal to the batched step."""
        outs = []
        for c in range(self.n_cams):
            raw = torch.from_numpy(np.ascontiguousarray(frames[c].data)).to(self.device)
            outs.append(self._core_step(
                raw, state["packed"][c], state["scales"][c], state["offsets"][c],
                colors[c], state["tracked"], params_for_cam(state["params"], c),
                _cam(grids, c)))
        blobs = _stack([o[0] for o in outs])
        det = _stack([o[1] for o in outs])
        det, fin = self._tail_step(blobs, det, colors, state["packed"], state["params"],
                                   refs, self._marks)
        return blobs, det, fin

    def finish_frames(self, out, now: float, frames, stale=None):
        """Per-camera host finishing of one dispatched frame-set, fanned out
        on the pool after one device->host copy per dtype. ``stale[c]``
        marks a camera whose frame is a reused last-good one (outage): its
        state still advances, but nothing is sent for it and its entry in
        the returned list is None."""
        blobs, det, fin = to_numpy(tuple(out))

        def finish_one(c):
            per_cam = ({k: v[c] for k, v in blobs.items()},
                       {k: v[c] for k, v in det.items()})
            if fin is not None:
                per_cam += ({k: v[c] for k, v in fin.items()},)
            wrapper, _, _ = self.processors[c].finish_frame(per_cam, now,
                                                            frames[c].timestamp)
            if stale is not None and stale[c]:
                return None  # detections of a reused frame stay off the wire
            if self.sockets:
                wrapper.detection.t_sent = self.cameras[c].get_time()
                self.sockets[c].send(wrapper)
                self.sockets[c].update_time()
            return wrapper

        return list(self._pool.map(finish_one, range(self.n_cams)))

    def step_frames(self, frames, now: float, tracked: TrackedArrays | None = None):
        """One frame-serial step (dispatch + finish)."""
        out = self.dispatch_frames(frames, now, tracked)
        if out is None:
            return None
        return self.finish_frames(out, now, frames)

    def _calibrate_uncalibrated(self, frames) -> None:
        """Calibrate every camera that has field geometry on its socket and
        no calibration yet from its frame (JAX multicam_app.py
        _calibrate_uncalibrated, ``App._calibration_path`` camera by
        camera): demosaiced on the card, fitted on the host, the model
        broadcast on the camera's own socket and adopted by its next
        geometry_check. A camera already calibrated, or without geometry,
        is skipped; one whose calibration finds no model is tried again on
        the next frame-set."""
        from ..calib.geometry import geometry_calibration

        for cfg, proc, sock, frame in zip(self.configs, self.processors, self.sockets,
                                          frames):
            if proc.perspective.geometry_version or not sock.geometry_version:
                continue
            log.info("Calibrating camera %d ...", cfg.cam_id)
            model = geometry_calibration(cfg, sock.geometry.field,
                                         demosaic(frame, self.device))
            if model is None:
                log.warning("camera %d: no calibration found, trying the next "
                            "frame-set", cfg.cam_id)
                continue
            sock.send(calibration_packet(sock.geometry, model, cfg.cam_id))

    def _accumulate_height_obs(self, wrappers) -> None:
        """Dual-view robot observations for the pair height solver. The
        emitted field positions were unprojected at the robot height, so
        field2image at that height gives back the centre pixels."""
        from ..calib.pair import observations_from_detections

        dets = {}
        for c, wrapper in enumerate(wrappers):
            if wrapper is None:  # camera outage: nothing was emitted
                continue
            det = wrapper.detection
            model = self.processors[c].perspective.model
            entries = []
            for team_off, robots in ((0, det.robots_yellow), (16, det.robots_blue)):
                for r in robots:
                    # a vetoed robot is emitted with confidence 0; sharing an
                    # id with a real robot of the paired camera it would spoil
                    # the observation, so only trusted detections feed the fit
                    if r.confidence <= 0.0:
                        continue
                    px = model.field2image(np.array([r.x, r.y, r.height], dtype=float))
                    entries.append((int(r.robot_id) + team_off, px, float(r.height)))
            dets[c] = entries
        models = [p.perspective.model for p in self.processors]
        self._height_obs += observations_from_detections(dets, models)

    def _refine_rig_height(self) -> None:
        """Once: solve the rig height, move every free camera along its
        plane-consistent manifold and broadcast the refined calibrations
        (the geometry publisher absorbs them, as after self-calibration).
        Without a solution the observations are dropped and gathered
        afresh."""
        from copy import deepcopy

        from ..calib.pair import apply_height, height_from_shared_objects

        models = [p.perspective.model for p in self.processors]
        # a camera with an operator-measured nonzero height stays fixed in
        # the cost and is never rewritten
        free = free_height_cameras(self.configs)
        h = height_from_shared_objects(models, self._height_obs, free=free)
        self._height_obs.clear()
        if h is None:
            log.warning("pair height calibration found no solution; keeping the "
                        "calibrations and gathering fresh observations")
            return
        self._pair_height_active = False
        refined = [deepcopy(models[i]) for i in sorted(free)]
        apply_height(refined, h)
        for i, model in zip(sorted(free), refined):
            sock = self.sockets[i]
            sock.send(calibration_packet(sock.geometry, model, self.configs[i].cam_id))
        log.info("pair height calibration applied: rig height %.0f mm broadcast for "
                 "%d of %d cameras", h, len(free), self.n_cams)

    def _idle_views(self, frame_id: int) -> None:
        """Before its geometry arrives, a camera would stream its raw
        demosaic for aiming, one camera per frame-set (JAX multicam_app.py
        _idle_views). With the stream off and no snapshot interval, the
        only settings the fleet accepts (ROADMAP A2), there is nothing to
        emit."""
        c = frame_id % self.n_cams
        if self.sockets[c].geometry_version:
            return
        cfg = self.configs[c]
        if not (cfg.stream_active or cfg.debug_stream_interval_ms > 0):
            return
        raise _unported("the idle views", _ROADMAP_DEBUG)

    def _finish_pending(self):
        """Finish the in-flight frame-set, if any; returns its wrappers."""
        if self._pending is None:
            return None
        out, fnow, fframes, fstale = self._pending
        self._pending = None
        return self.finish_frames(out, fnow, fframes, fstale)

    def run(self):
        frame_id = 0
        while self.running:
            for cfg, proc in zip(self.configs, self.processors):
                if cfg.reload_if_changed():
                    proc.apply_tunables()
            frames, read_pending = self._read_all()
            alive = [f is not None for f in frames]
            if not any(alive):
                if any(read_pending):
                    # every camera momentarily stale, reads still in flight:
                    # not the end of the streams, wait a frame time
                    self._stale_prev = list(read_pending)
                    time.sleep(min(self.cameras[0].expected_frametime() or 0.05, 0.05))
                    continue
                break  # every camera's read completed with None
            if not all(alive):
                # one dead camera must not stop the fleet: reuse its last
                # frame to keep the batch's shape and keep its detections
                # off the wire; a camera failing before the first complete
                # frame-set ends the run (no batch shape exists yet)
                if self._last_frames is None:
                    break
                frames = [f if a else self._last_frames[c]
                          for c, (f, a) in enumerate(zip(frames, alive))]
            stale = [not a for a in alive]
            for c, s in enumerate(stale):
                if s and not self._stale_prev[c]:
                    log.warning("camera %d delivered no frame; reusing its last frame "
                                "and suppressing its detections", c)
                elif not s and self._stale_prev[c]:
                    log.info("camera %d recovered", c)
            self._stale_prev = stale
            self._last_frames = frames
            frame_id += 1
            now = self.cameras[0].get_time()
            real_start = get_real_time()
            for proc, frame in zip(self.processors, frames):
                proc.geometry_check(frame.width, frame.height)
            try:
                out = self.dispatch_frames(frames, now)
                if out is None:
                    # some camera is uncalibrated: finish any in-flight set
                    wrappers = self._finish_pending()
                elif self.pipeline:
                    wrappers = self._finish_pending()
                    self._pending = (out, now, frames, stale)
                else:
                    wrappers = self.finish_frames(out, now, frames, stale)
            except (NotImplementedError, KernelError):
                raise
            except Exception:  # keep the fleet alive on a transient failure
                log.exception("frame set %d failed, continuing", frame_id)
                self._pending = None
                continue
            if out is None:
                # outside the per-frame guard, as below: a failure of the
                # demosaic on the card or of the calibration code ends run().
                # Calibrate what can be, and wait for the rest
                self._calibrate_uncalibrated(frames)
                self._idle_views(frame_id)
                continue
            # a failure of the pair solve ends run() too
            if wrappers is not None and self._pair_height_active:
                self._accumulate_height_obs(wrappers)
                if len(self._height_obs) >= self._height_obs_target:
                    self._refine_rig_height()
            processing = get_real_time() - real_start
            budget = self.cameras[0].expected_frametime()
            if budget and processing > budget:
                log.info("frame time overrun: %.1f ms for %d cameras",
                         processing * 1e3, self.n_cams)
        try:
            self._finish_pending()
        except KernelError:
            raise
        except Exception:
            log.exception("final pending frame set failed")
        log.info("Stopping multi-camera vision_processor")
        self.close()

    def close(self):
        self._pool.shutdown(wait=False)
        for s in self.sockets:
            s.close()
        if self.gc_socket is not None:
            self.gc_socket.close()
        for c in self.cameras:
            c.close()
