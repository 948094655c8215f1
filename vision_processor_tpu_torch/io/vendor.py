"""Vendor camera SDK drivers (FLIR Spinnaker, Balluff/MATRIX VISION mvIMPACT).

PyTorch port: a copy of vision_processor_tpu/io/vendor.py (it imports no
JAX). Frames stay host numpy arrays; the processor uploads them.

The reference ships native drivers for both SDKs (reference
src/driver/spinnakerdriver.cpp:39-180, src/driver/mvimpactdriver.cpp:29-116).
These SDKs are proprietary and not present in every deployment, so this
module binds them lazily through their official Python bindings (PySpin /
mvIMPACT.acquire) when installed, applying the same acquisition policy:

* BayerRG8 / Mono8-GRBG pixel formats feeding the raw pipeline at half
  (true-color) model resolution
* newest-frame-only buffer handling (stale frames dropped)
* exposure / gain / gamma / white-balance setup from the camera config
  (0 = automatic, OUTDOOR/INDOOR auto white-balance profiles)
* camera hardware timestamps surfaced on every frame

Without the SDK the constructor raises a clear error; `open_camera` keeps
working for OPENCV/V4L2/SYNTHETIC sources.
"""
from __future__ import annotations

import numpy as np

from ..utils.config import CameraSection
from ..utils.log import get_logger
from .camera import CameraDriver, RawFrame, register_driver

log = get_logger(__name__)

# consecutive read failures before the driver tries to re-arm the
# acquisition stream (the reference retries camera bring-up in a loop,
# reference spinnakerdriver.cpp:41-52; mid-run we re-arm rather than
# rebuild so a transient bus hiccup costs frames, not the process)
_REARM_AFTER = 8


class _TimestampGuard:
    """Monotonic guard for camera hardware timestamps.

    Industrial cameras re-arm their timestamp clock on reconnect / power
    events, so a mid-run discontinuity shows up as a BACKWARDS jump that
    would corrupt tracking time deltas (velocities divide by dt). The
    guard passes normal timestamps through untouched and replaces a
    non-monotonic one with last + expected frame period, logging once per
    discontinuity episode.
    """

    def __init__(self, frametime: float):
        self._last = None
        self._frametime = frametime
        self._in_episode = False

    def __call__(self, ts: float) -> float:
        if ts <= 0.0:
            return ts  # timestamps unsupported: pass the 0 convention
        if self._last is not None and ts <= self._last:
            if not self._in_episode:
                log.warning(
                    "camera timestamp discontinuity: %.6f after %.6f; "
                    "substituting monotonic estimates", ts, self._last,
                )
                self._in_episode = True
            ts = self._last + self._frametime
        else:
            self._in_episode = False
        self._last = ts
        return ts


class SpinnakerDriver(CameraDriver):
    """FLIR cameras via PySpin (GenICam)."""

    def __init__(self, cfg: CameraSection):
        try:
            import PySpin  # type: ignore
        except ImportError as exc:
            raise RuntimeError(
                "SPINNAKER driver requires the FLIR Spinnaker SDK "
                "(PySpin python bindings)"
            ) from exc
        self._spin = PySpin
        self._system = PySpin.System.GetInstance()
        cams = self._system.GetCameras()
        if cams.GetSize() <= cfg.id:
            cams.Clear()
            raise RuntimeError(f"Spinnaker camera {cfg.id} not found")
        self._cam = cams.GetByIndex(cfg.id)
        cams.Clear()
        self._cam.Init()
        self._configure(cfg)
        self._cam.BeginAcquisition()
        self._fps = float(self._cam.AcquisitionFrameRate.GetValue())
        self._ts_guard = _TimestampGuard(self.expected_frametime())
        self._fail_streak = 0

    def _configure(self, cfg: CameraSection) -> None:
        spin = self._spin
        cam = self._cam
        # raw Bayer feeding the demosaic-free pipeline
        cam.PixelFormat.SetValue(spin.PixelFormat_BayerRG8)
        # newest-only buffer handling
        s_node = cam.TLStream
        s_node.StreamBufferHandlingMode.SetValue(
            spin.StreamBufferHandlingMode_NewestOnly
        )
        if cfg.width:
            cam.Width.SetValue(cfg.width)
        if cfg.height:
            cam.Height.SetValue(cfg.height)
        if cfg.exposure > 0:
            cam.ExposureAuto.SetValue(spin.ExposureAuto_Off)
            cam.ExposureTime.SetValue(cfg.exposure * 1000.0)
        else:
            cam.ExposureAuto.SetValue(spin.ExposureAuto_Continuous)
        if cfg.gain > 0:
            cam.GainAuto.SetValue(spin.GainAuto_Off)
            cam.Gain.SetValue(cfg.gain)
        else:
            cam.GainAuto.SetValue(spin.GainAuto_Continuous)
        if cfg.gamma != 1.0:
            cam.GammaEnable.SetValue(True)
            cam.Gamma.SetValue(cfg.gamma)
        wb = cfg.white_balance
        if isinstance(wb, dict):
            cam.BalanceWhiteAuto.SetValue(spin.BalanceWhiteAuto_Off)
            cam.BalanceRatioSelector.SetValue(spin.BalanceRatioSelector_Red)
            cam.BalanceRatio.SetValue(float(wb.get("red", 1.0)))
            cam.BalanceRatioSelector.SetValue(spin.BalanceRatioSelector_Blue)
            cam.BalanceRatio.SetValue(float(wb.get("blue", 1.0)))
        else:
            cam.BalanceWhiteAuto.SetValue(spin.BalanceWhiteAuto_Continuous)
            profile = getattr(
                spin,
                "BalanceWhiteAutoProfile_"
                + ("Outdoor" if str(wb).upper() == "OUTDOOR" else "Indoor"),
                None,
            )
            if profile is not None:
                cam.BalanceWhiteAutoProfile.SetValue(profile)

    @property
    def fmt(self) -> str:
        return "RGGB"

    def expected_frametime(self) -> float:
        return 1.0 / max(self._fps, 1.0)

    def read_image(self) -> RawFrame | None:
        # any SDK error (timeout, mid-acquisition disconnect, bus reset)
        # becomes a None frame — OUTAGE semantics the apps degrade on —
        # never an exception that would take down the camera loop; after
        # _REARM_AFTER consecutive failures the acquisition stream is
        # re-armed (End/BeginAcquisition), the mid-run analogue of the
        # reference's bring-up retry loop (spinnakerdriver.cpp:41-52)
        try:
            img = self._cam.GetNextImage(1000)
        except Exception as exc:
            self._fail_streak += 1
            log.warning("Spinnaker read failed (%d consecutive): %s",
                        self._fail_streak, exc)
            if self._fail_streak >= _REARM_AFTER:
                self._rearm()
            return None
        try:
            if img.IsIncomplete():
                # partial frame delivery: drop it, keep the ring moving
                self._fail_streak += 1
                return None
            data = np.array(img.GetNDArray(), dtype=np.uint8, copy=True)
            ts = self._ts_guard(img.GetTimeStamp() / 1e9)
        finally:
            img.Release()
        self._fail_streak = 0
        h, w = data.shape
        return RawFrame(data, "RGGB", w // 2, h // 2, ts)

    def _rearm(self) -> None:
        log.warning("re-arming Spinnaker acquisition after %d failures",
                    self._fail_streak)
        self._fail_streak = 0
        try:
            self._cam.EndAcquisition()
            self._cam.BeginAcquisition()
        except Exception as exc:  # camera still gone: stay in outage
            log.warning("Spinnaker re-arm failed: %s", exc)

    def close(self) -> None:
        try:
            self._cam.EndAcquisition()
            self._cam.DeInit()
            del self._cam
            self._system.ReleaseInstance()
        except Exception:  # pragma: no cover - SDK teardown
            pass


class MVImpactDriver(CameraDriver):
    """Balluff/MATRIX VISION (Bluefox3) cameras via mvIMPACT.acquire."""

    def __init__(self, cfg: CameraSection):
        try:
            from mvIMPACT import acquire  # type: ignore
        except ImportError as exc:
            raise RuntimeError(
                "MVIMPACT driver requires the mvIMPACT Acquire SDK"
            ) from exc
        self._acquire = acquire
        mgr = acquire.DeviceManager()
        if mgr.deviceCount() <= cfg.id:
            raise RuntimeError(f"mvIMPACT camera {cfg.id} not found")
        self._dev = mgr.getDevice(cfg.id)
        self._dev.open()
        self._fi = acquire.FunctionInterface(self._dev)
        settings = acquire.SettingsBlueDevice(self._dev)
        # raw Mono8 carrying the GRBG mosaic, like the reference driver
        settings.imageDestination.pixelFormat.writeS("Mono8")
        if cfg.exposure > 0:
            settings.cameraSettings.exposeUsec.write(int(cfg.exposure * 1000))
        if cfg.gain > 0:
            settings.cameraSettings.gain_dB.write(cfg.gain)
        for _ in range(4):
            self._fi.imageRequestSingle()
        self._fps = 50.0
        self._ts_guard = _TimestampGuard(1.0 / self._fps)
        self._fail_streak = 0

    @property
    def fmt(self) -> str:
        return "GRBG"

    def expected_frametime(self) -> float:
        return 1.0 / self._fps

    @staticmethod
    def _request_ok(req) -> bool:
        """Partial/failed transfer check: mvIMPACT reports the request
        result as a string node ('OK' on success; 'Error', 'Incomplete'
        etc. on partial frames — reference mvimpactdriver.cpp handles the
        same via the request result). Missing node (older SDK) = OK."""
        res = getattr(req, "requestResult", None)
        if res is None:
            return True
        try:
            return str(res.readS()) == "OK"
        except Exception:
            return True

    def read_image(self) -> RawFrame | None:
        fi = self._fi
        # SDK errors become None frames (outage semantics), like the
        # Spinnaker driver; a long failure streak re-primes the request
        # queue in case the device dropped the outstanding requests
        try:
            req_nr = fi.imageRequestWaitFor(1000)
            if not fi.isRequestNrValid(req_nr):
                self._fail_streak += 1
                if self._fail_streak >= _REARM_AFTER:
                    self._rearm()
                return None
            req = fi.getRequest(req_nr)
            # skip to the newest completed request
            while True:
                nxt = fi.imageRequestWaitFor(0)
                if not fi.isRequestNrValid(nxt):
                    break
                req.unlock()
                fi.imageRequestSingle()
                req = fi.getRequest(nxt)
        except Exception as exc:
            self._fail_streak += 1
            log.warning("mvIMPACT read failed (%d consecutive): %s",
                        self._fail_streak, exc)
            if self._fail_streak >= _REARM_AFTER:
                self._rearm()
            return None
        try:
            if not self._request_ok(req):
                # partial frame: requeue the buffer, deliver nothing
                self._fail_streak += 1
                return None
            buf = req.getImageBufferDesc().getBuffer()
            h = req.imageHeight.read()
            w = req.imageWidth.read()
            data = np.frombuffer(buf, dtype=np.uint8, count=h * w).reshape(h, w).copy()
            ts = self._ts_guard(req.infoTimeStamp_us.read() / 1e6)
        except Exception as exc:
            self._fail_streak += 1
            log.warning("mvIMPACT frame fetch failed: %s", exc)
            return None
        finally:
            try:
                req.unlock()
                fi.imageRequestSingle()
            except Exception:  # device gone: the re-arm path re-primes
                pass
        self._fail_streak = 0
        return RawFrame(data, "GRBG", w // 2, h // 2, ts)

    def _rearm(self) -> None:
        log.warning("re-priming mvIMPACT request queue after %d failures",
                    self._fail_streak)
        self._fail_streak = 0
        try:
            for _ in range(4):
                self._fi.imageRequestSingle()
        except Exception as exc:
            log.warning("mvIMPACT re-prime failed: %s", exc)

    def close(self) -> None:
        try:
            self._dev.close()
        except Exception:  # pragma: no cover - SDK teardown
            pass


register_driver("SPINNAKER", SpinnakerDriver)
register_driver("MVIMPACT", MVImpactDriver)
