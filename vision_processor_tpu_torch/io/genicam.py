"""GenICam-generic camera driver via Aravis (ctypes, no SDK bindings).

PyTorch port: a copy of vision_processor_tpu/io/genicam.py (it imports no
JAX).

The reference supports exactly two vendor SDKs (reference
src/driver/spinnakerdriver.cpp, src/driver/mvimpactdriver.cpp); Aravis
covers any GigE Vision / USB3 Vision camera through one open library, so
this driver closes the "other vendors" gap without another proprietary
SDK. Bound with ctypes against ``libaravis-0.8`` — no PyGObject needed.

Acquisition policy matches the vendor drivers (io/vendor.py):

* BayerRG8 pixel format feeding the raw pipeline
* newest-frame-only: all completed buffers are drained and only the
  latest is returned; drained buffers are requeued immediately
* exposure / gain / frame-rate from the camera config (0 = automatic)
* camera hardware timestamps surfaced on every frame

Without the library the constructor raises a clear error and
``open_camera`` keeps working for the other sources.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from ..utils.config import CameraSection
from ..utils.log import get_logger
from .camera import CameraDriver, RawFrame, register_driver

log = get_logger(__name__)

ARV_PIXEL_FORMAT_BAYER_RG_8 = 0x01080009
ARV_BUFFER_STATUS_SUCCESS = 0
ARV_AUTO_OFF = 0
ARV_AUTO_CONTINUOUS = 2
_N_BUFFERS = 4


def _load_aravis():
    for name in ("aravis-0.8", "aravis-0.6"):
        path = ctypes.util.find_library(name)
        if path:
            return ctypes.CDLL(path)
    raise RuntimeError(
        "GENICAM driver requires the Aravis library (libaravis-0.8)"
    )


class _GErrorPtr(ctypes.Structure):
    _fields_ = [
        ("domain", ctypes.c_uint32),
        ("code", ctypes.c_int),
        ("message", ctypes.c_char_p),
    ]


class AravisDriver(CameraDriver):
    """Any GenICam camera through Aravis."""

    def __init__(self, cfg: CameraSection):
        lib = _load_aravis()
        self._lib = lib
        self._setup_prototypes(lib)

        # camera.path selects by Aravis device id / address string (e.g.
        # "Allied Vision-XXXX" or an IP); NULL opens the first discovered
        # device. Each camera of a multi-camera rig needs a distinct path.
        name = cfg.path.encode() if cfg.path else None
        err = ctypes.POINTER(_GErrorPtr)()
        self._cam = lib.arv_camera_new(name, ctypes.byref(err))
        self._check(err, "arv_camera_new")
        if not self._cam:
            raise RuntimeError("GENICAM: no camera found")

        self._configure(cfg)

        self._payload = self._call(
            lib.arv_camera_get_payload, self._cam, what="get_payload"
        )
        self._stream = self._call(
            lib.arv_camera_create_stream, self._cam, None, None,
            what="create_stream",
        )
        for _ in range(_N_BUFFERS):
            buf = lib.arv_buffer_new_allocate(self._payload)
            lib.arv_stream_push_buffer(self._stream, buf)
        self._call(
            lib.arv_camera_start_acquisition, self._cam,
            what="start_acquisition",
        )

        fps = self._call(
            lib.arv_camera_get_frame_rate, self._cam, what="get_frame_rate"
        )
        self._fps = float(fps) if fps and fps > 0 else 50.0

    @staticmethod
    def _setup_prototypes(lib) -> None:
        perr = ctypes.POINTER(ctypes.POINTER(_GErrorPtr))
        lib.arv_camera_new.restype = ctypes.c_void_p
        lib.arv_camera_new.argtypes = [ctypes.c_char_p, perr]
        lib.arv_camera_get_payload.restype = ctypes.c_uint
        lib.arv_camera_get_payload.argtypes = [ctypes.c_void_p, perr]
        lib.arv_camera_create_stream.restype = ctypes.c_void_p
        lib.arv_camera_create_stream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, perr,
        ]
        lib.arv_buffer_new_allocate.restype = ctypes.c_void_p
        lib.arv_buffer_new_allocate.argtypes = [ctypes.c_uint]
        lib.arv_stream_push_buffer.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.arv_stream_try_pop_buffer.restype = ctypes.c_void_p
        lib.arv_stream_try_pop_buffer.argtypes = [ctypes.c_void_p]
        lib.arv_stream_timeout_pop_buffer.restype = ctypes.c_void_p
        lib.arv_stream_timeout_pop_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.arv_buffer_get_status.restype = ctypes.c_int
        lib.arv_buffer_get_status.argtypes = [ctypes.c_void_p]
        lib.arv_buffer_get_data.restype = ctypes.c_void_p
        lib.arv_buffer_get_data.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.arv_buffer_get_image_width.restype = ctypes.c_int
        lib.arv_buffer_get_image_width.argtypes = [ctypes.c_void_p]
        lib.arv_buffer_get_image_height.restype = ctypes.c_int
        lib.arv_buffer_get_image_height.argtypes = [ctypes.c_void_p]
        lib.arv_buffer_get_timestamp.restype = ctypes.c_uint64
        lib.arv_buffer_get_timestamp.argtypes = [ctypes.c_void_p]
        lib.arv_camera_set_pixel_format.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, perr,
        ]
        lib.arv_camera_set_exposure_time.argtypes = [
            ctypes.c_void_p, ctypes.c_double, perr,
        ]
        lib.arv_camera_set_exposure_time_auto.argtypes = [
            ctypes.c_void_p, ctypes.c_int, perr,
        ]
        lib.arv_camera_set_gain.argtypes = [
            ctypes.c_void_p, ctypes.c_double, perr,
        ]
        lib.arv_camera_set_gain_auto.argtypes = [
            ctypes.c_void_p, ctypes.c_int, perr,
        ]
        lib.arv_camera_set_frame_rate.argtypes = [
            ctypes.c_void_p, ctypes.c_double, perr,
        ]
        lib.arv_camera_get_frame_rate.restype = ctypes.c_double
        lib.arv_camera_get_frame_rate.argtypes = [ctypes.c_void_p, perr]
        lib.arv_camera_start_acquisition.argtypes = [ctypes.c_void_p, perr]
        lib.arv_camera_stop_acquisition.argtypes = [ctypes.c_void_p, perr]

    def _check(self, err, what: str) -> None:
        if err:
            msg = (err.contents.message or b"").decode(errors="replace")
            self._free_gerror(err)
            raise RuntimeError(f"GENICAM {what}: {msg}")

    def _free_gerror(self, err) -> None:
        """g_error_free the raised GError (callee-allocated; leaking one per
        failed call adds up on a flaky link). dlsym through the aravis
        handle reaches its glib dependency on Linux."""
        try:
            free = getattr(self._lib, "g_error_free", None)
            if free is None:  # pragma: no cover - unusual linkage
                path = ctypes.util.find_library("glib-2.0")
                if not path:
                    return
                free = ctypes.CDLL(path).g_error_free
            free.argtypes = [ctypes.c_void_p]
            free(ctypes.cast(err, ctypes.c_void_p))
        except Exception:  # pragma: no cover - never mask the real error
            pass

    def _call(self, fn, *args, what: str):
        """Call an Aravis function with a FRESH GError** (GLib forbids
        passing a still-set error into the next call) and check it."""
        err = ctypes.POINTER(_GErrorPtr)()
        out = fn(*args, ctypes.byref(err))
        self._check(err, what)
        return out

    def _configure(self, cfg: CameraSection) -> None:
        lib = self._lib
        self._call(
            lib.arv_camera_set_pixel_format, self._cam,
            ARV_PIXEL_FORMAT_BAYER_RG_8, what="set_pixel_format(BayerRG8)",
        )
        if cfg.exposure > 0:
            self._call(
                lib.arv_camera_set_exposure_time_auto, self._cam,
                ARV_AUTO_OFF, what="set_exposure_time_auto(off)",
            )
            self._call(
                lib.arv_camera_set_exposure_time, self._cam,
                cfg.exposure * 1000.0, what="set_exposure_time",
            )
        else:
            self._call(
                lib.arv_camera_set_exposure_time_auto, self._cam,
                ARV_AUTO_CONTINUOUS, what="set_exposure_time_auto(cont)",
            )
        if cfg.gain > 0:
            self._call(
                lib.arv_camera_set_gain_auto, self._cam, ARV_AUTO_OFF,
                what="set_gain_auto(off)",
            )
            self._call(
                lib.arv_camera_set_gain, self._cam, cfg.gain, what="set_gain"
            )
        else:
            self._call(
                lib.arv_camera_set_gain_auto, self._cam,
                ARV_AUTO_CONTINUOUS, what="set_gain_auto(cont)",
            )

    @property
    def fmt(self) -> str:
        return "RGGB"

    def expected_frametime(self) -> float:
        return 1.0 / self._fps

    def read_image(self) -> RawFrame | None:
        lib = self._lib
        buf = lib.arv_stream_timeout_pop_buffer(self._stream, 1_000_000)
        if not buf:
            return None
        # newest-only drain: keep the newest SUCCESS buffer, requeue the
        # rest. Skipping failed buffers here (instead of blindly taking the
        # newest) keeps an older successfully-captured frame when the most
        # recent transfer was incomplete.
        while True:
            nxt = lib.arv_stream_try_pop_buffer(self._stream)
            if not nxt:
                break
            if lib.arv_buffer_get_status(nxt) != ARV_BUFFER_STATUS_SUCCESS:
                lib.arv_stream_push_buffer(self._stream, nxt)
                continue
            lib.arv_stream_push_buffer(self._stream, buf)
            buf = nxt
        try:
            if lib.arv_buffer_get_status(buf) != ARV_BUFFER_STATUS_SUCCESS:
                return None
            size = ctypes.c_size_t()
            data = lib.arv_buffer_get_data(buf, ctypes.byref(size))
            w = lib.arv_buffer_get_image_width(buf)
            h = lib.arv_buffer_get_image_height(buf)
            if not data or size.value < w * h:
                return None
            raw = np.ctypeslib.as_array(
                ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8)), (h, w)
            ).copy()
            ts = lib.arv_buffer_get_timestamp(buf) / 1e9
        finally:
            lib.arv_stream_push_buffer(self._stream, buf)
        return RawFrame(raw, "RGGB", w // 2, h // 2, ts)

    def close(self) -> None:
        """Stop acquisition and drop the GObject references — leaving the
        ArvCamera alive keeps the GigE control-channel heartbeat owning
        the device, which blocks re-opening it from the same process."""
        try:
            err = ctypes.POINTER(_GErrorPtr)()
            self._lib.arv_camera_stop_acquisition(self._cam, ctypes.byref(err))
        except Exception:  # pragma: no cover - teardown
            pass
        try:
            path = ctypes.util.find_library("gobject-2.0")
            if path:
                gobject = ctypes.CDLL(path)
                gobject.g_object_unref.argtypes = [ctypes.c_void_p]
                if self._stream:
                    gobject.g_object_unref(self._stream)
                if self._cam:
                    gobject.g_object_unref(self._cam)
                self._stream = None
                self._cam = None
        except Exception:  # pragma: no cover - teardown
            pass


register_driver("GENICAM", AravisDriver)
register_driver("ARAVIS", AravisDriver)
