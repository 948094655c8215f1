"""ctypes bindings for the native host library (PyTorch port).

Counterpart of vision_processor_tpu/io/native.py: the V4L2 camera driver
(registered as driver "V4L2"), a native multicast socket and the H.264
encoder. The library is the repository's ``native/vptpu_native.cpp`` and
``native/h264_cavlc.cpp``, compiled with ``native/Makefile``'s flags on
first use into ``build/vptpu_native/<hash of the sources>/`` (a directory
that ``.gitignore`` lists; ``native/`` itself is never written). Without a
C++ compiler ``load_native`` returns None: ``RTPStreamer`` falls back to
its other codecs, and ``V4L2Driver`` and ``NativeMulticast`` raise
RuntimeError, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.log import get_logger
from .camera import CameraDriver, RawFrame, register_driver

log = get_logger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
SOURCES = ("vptpu_native.cpp", "h264_cavlc.cpp")
HEADERS = ("h264_common.h",)
BUILD_DIR = _ROOT / "build" / "vptpu_native"
# native/Makefile: CXXFLAGS ?= -O3 -fPIC -Wall -Wextra -std=c++17 -pthread
CXXFLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / "libvptpu_native.so"


def _build(target: Path) -> None:
    """Compile the sources into ``target``: into a file of this process's
    own, then renamed, so that processes building at once never load a
    half-written library."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cxx = shlex.split(os.environ.get("CXX", "g++"))
    cmd = [*cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in SOURCES), "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def load_native(build: bool = True):
    """Load (building if needed) the native library; None when unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists() and build:
            try:
                _build(path)
            except (subprocess.CalledProcessError, FileNotFoundError) as exc:
                log.warning("native build failed: %s %s", exc,
                            getattr(exc, "stderr", "") or "")
                return None
        if not path.exists():
            return None
        _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _bind(lib):
    lib.vptpu_v4l2_open.restype = ctypes.c_void_p
    lib.vptpu_v4l2_open.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32,
    ]
    for fn in ("width", "height", "pixelformat", "bytesperline"):
        getattr(lib, f"vptpu_v4l2_{fn}").restype = ctypes.c_uint32
        getattr(lib, f"vptpu_v4l2_{fn}").argtypes = [ctypes.c_void_p]
    lib.vptpu_v4l2_read.restype = ctypes.c_int64
    lib.vptpu_v4l2_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.vptpu_v4l2_close.argtypes = [ctypes.c_void_p]

    lib.vptpu_mc_open.restype = ctypes.c_void_p
    lib.vptpu_mc_open.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.vptpu_mc_send.restype = ctypes.c_int64
    lib.vptpu_mc_send.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    ]
    lib.vptpu_mc_recv.restype = ctypes.c_int64
    lib.vptpu_mc_recv.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.vptpu_mc_close.argtypes = [ctypes.c_void_p]
    lib.vptpu_monotonic_us.restype = ctypes.c_int64

    lib.vptpu_h264_ipcm_encode.restype = ctypes.c_long
    lib.vptpu_h264_ipcm_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.vptpu_h264_cavlc_encode.restype = ctypes.c_long
    lib.vptpu_h264_cavlc_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    # slice-parallel form
    lib.vptpu_h264_cavlc_encode_mt.restype = ctypes.c_long
    lib.vptpu_h264_cavlc_encode_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    # inter (P) pictures
    lib.vptpu_h264_cavlc_encode_p.restype = ctypes.c_long
    lib.vptpu_h264_cavlc_encode_p.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


class H264Encoder:
    """In-process H.264 encoder (native, two tiers; JAX io/native.py
    ``H264Encoder``, whose docstring details each tier).

    * ``qp=None``: all-I_PCM baseline, lossless, about 12 bits/px;
    * ``qp=<10..29>``: CAVLC all-intra, the compressed LAN debug tier;
      ``gop=N`` adds the inter tier (an IDR every N frames, P pictures
      between), ``target_kbps`` frame-level rate control (the QP walks
      inside [10, 29] on a one-second virtual buffer).

    Every tier emits standard annex-B baseline bitstreams. Frames are
    padded to multiples of 16.
    """

    def __init__(self, qp: int | None = None, n_slices: int | None = None,
                 gop: int | None = None, target_kbps: float | None = None,
                 framerate: float = 30.0):
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._scratch = None
        self._out = None
        self._idr = 0
        self.qp = qp
        self.gop = int(gop) if gop and qp is not None and int(gop) > 1 else None
        self._gop_idx = 0       # frame index within the current GOP
        self._frame_num = 0     # 4-bit H.264 reference frame counter
        self._ref = None        # previous frame's reconstruction planes
        self._new = None        # scratch recon planes for the current frame
        # frame-level rate control state (virtual buffer, 1 s capacity);
        # a negative target would pin the controller at QP 29: reject it
        self.target_kbps = (float(target_kbps)
                            if target_kbps and float(target_kbps) > 0
                            and qp is not None else None)
        self.framerate = float(framerate) if framerate > 0 else 30.0
        self._rc_debt = 0.0     # bits spent above budget so far
        # slice-parallel CAVLC: one thread per horizontal slice band, leaving
        # headroom for the per-camera host finishing threads
        if n_slices is None:
            n_slices = max(1, min(8, (os.cpu_count() or 2) // 2))
        self.n_slices = int(n_slices)

    def _rc_update(self, frame_bits: float) -> None:
        """Walk the QP toward the bitrate target: a leaky virtual buffer
        (capacity one second of target bits) absorbs the IDR spikes of the
        GOP structure; persistent over- or undershoot steps the QP."""
        if self.target_kbps is None:
            return
        budget = self.target_kbps * 1000.0 / self.framerate
        cap = self.target_kbps * 1000.0
        self._rc_debt = max(-cap, min(cap, self._rc_debt + frame_bits - budget))
        if self._rc_debt > 0.6 * cap:
            self.qp = min(29, self.qp + 2)
            self._rc_debt -= 0.15 * cap   # don't re-step on the same spike
        elif self._rc_debt > 0.25 * cap:
            self.qp = min(29, self.qp + 1)
            self._rc_debt -= 0.05 * cap
        elif self._rc_debt < -0.25 * cap:
            self.qp = max(10, self.qp - 1)
            self._rc_debt += 0.05 * cap

    def _cavlc(self, y, u, v, w, h, ry=None, ru=None, rv=None):
        args = (y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h,
                int(self.qp), self._idr)
        tail = (
            self._scratch.ctypes.data, self._scratch.size,
            self._out.ctypes.data, self._out.size,
            None if ry is None else ry.ctypes.data,
            None if ru is None else ru.ctypes.data,
            None if rv is None else rv.ctypes.data,
        )
        if self.n_slices > 1:
            return self._lib.vptpu_h264_cavlc_encode_mt(*args, self.n_slices, *tail)
        return self._lib.vptpu_h264_cavlc_encode(*args, *tail)

    def _buffers(self, w: int, h: int) -> None:
        need = w * h * 2 + 131072
        if self._scratch is None or self._scratch.size < need:
            self._scratch = np.zeros(need, np.uint8)
            self._out = np.zeros(need + need // 64, np.uint8)

    def encode_i420(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> bytes:
        h, w = y.shape
        if w % 16 or h % 16:
            raise ValueError("pad the planes to multiples of 16 first")
        self._buffers(w, h)
        y = np.ascontiguousarray(y)
        u = np.ascontiguousarray(u)
        v = np.ascontiguousarray(v)
        if self.qp is None:
            n = self._lib.vptpu_h264_ipcm_encode(
                y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, self._idr,
                self._scratch.ctypes.data, self._scratch.size,
                self._out.ctypes.data, self._out.size,
            )
        elif self.gop:
            return self._encode_gop(y, u, v, w, h)
        else:
            n = self._cavlc(y, u, v, w, h)
            if n > 0:
                self._rc_update(n * 8.0)
        if n <= 0:
            raise RuntimeError(f"h264 encode failed ({n})")
        self._idr ^= 1
        return self._out[:n].tobytes()

    def _encode_gop(self, y, u, v, w, h) -> bytes:
        """IDR/P sequencing for the inter tier: the previous frame's
        spec-exact reconstruction (double-buffered: the native P encoder
        requires ref and recon to be distinct) is the L0 reference."""
        if self._ref is None or self._ref[0].shape != y.shape:
            def make():
                return np.zeros_like(y), np.zeros_like(u), np.zeros_like(v)
            self._ref, self._new = make(), make()
            self._gop_idx = 0
        ny, nu, nv = self._new
        if self._gop_idx == 0:
            n = self._cavlc(y, u, v, w, h, ny, nu, nv)
            self._idr ^= 1
            self._frame_num = 0
        else:
            ry, ru, rv = self._ref
            self._frame_num = (self._frame_num + 1) & 15
            n = self._lib.vptpu_h264_cavlc_encode_p(
                y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h,
                int(self.qp), self._frame_num, self.n_slices,
                ry.ctypes.data, ru.ctypes.data, rv.ctypes.data,
                self._out.ctypes.data, self._out.size,
                ny.ctypes.data, nu.ctypes.data, nv.ctypes.data,
            )
        if n <= 0:
            raise RuntimeError(f"h264 encode failed ({n})")
        self._rc_update(n * 8.0)
        self._ref, self._new = self._new, self._ref
        self._gop_idx = (self._gop_idx + 1) % self.gop
        return self._out[:n].tobytes()

    def encode_rgb(self, rgb: np.ndarray) -> bytes:
        """(H, W, 3) uint8 RGB -> one annex-B access unit (SPS + PPS + IDR,
        or a P picture inside a GOP)."""
        import cv2

        h, w = rgb.shape[:2]
        wp, hp = -(-w // 16) * 16, -(-h // 16) * 16
        if (wp, hp) != (w, h):
            rgb = np.pad(rgb, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
        i420 = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2YUV_I420)
        y = i420[:hp]
        u = i420[hp:hp + hp // 4].reshape(hp // 2, wp // 2)
        v = i420[hp + hp // 4:].reshape(hp // 2, wp // 2)
        return self.encode_i420(y, u, v)


def fourcc(code: str) -> int:
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


_FOURCC_TO_FMT = {
    fourcc("RGGB"): ("RGGB", 1),
    fourcc("GRBG"): ("GRBG", 1),
    fourcc("YUYV"): ("YUYV", 2),
    fourcc("MJPG"): ("MJPG", 0),
    fourcc("BGR3"): ("BGR", 3),
}


class V4L2Driver(CameraDriver):
    """Native mmap-ring V4L2 capture with newest-frame-only delivery."""

    def __init__(self, cfg):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable for V4L2 driver")
        self._lib = lib
        device = cfg.path or f"/dev/video{cfg.id}"
        self._cam = lib.vptpu_v4l2_open(
            device.encode(), cfg.width or 0, cfg.height or 0, 0, 4
        )
        if not self._cam:
            raise RuntimeError(f"cannot open V4L2 device {device}")
        self._width = lib.vptpu_v4l2_width(self._cam)
        self._height = lib.vptpu_v4l2_height(self._cam)
        pix = lib.vptpu_v4l2_pixelformat(self._cam)
        self._fmt, bpp = _FOURCC_TO_FMT.get(pix, ("YUYV", 2))
        cap = self._width * self._height * max(bpp, 3)
        self._buf = np.empty(cap, dtype=np.uint8)
        self._fps = 30.0

    @property
    def fmt(self) -> str:
        # the pipeline receives BGR after host conversion for packed formats
        return "BGR" if self._fmt in ("YUYV", "MJPG", "BGR") else self._fmt

    def expected_frametime(self) -> float:
        return 1.0 / self._fps

    def read_image(self) -> RawFrame | None:
        ts = ctypes.c_int64(0)
        n = self._lib.vptpu_v4l2_read(
            self._cam,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._buf.size,
            1000,
            ctypes.byref(ts),
        )
        if n <= 0:
            return None
        data = self._buf[: int(n)]
        w, h = self._width, self._height
        if self._fmt == "YUYV":
            import cv2

            yuyv = data.reshape(h, w, 2)
            bgr = cv2.cvtColor(yuyv, cv2.COLOR_YUV2BGR_YUY2)
            return RawFrame(bgr, "BGR", w, h, ts.value / 1e6)
        if self._fmt == "MJPG":
            import cv2

            bgr = cv2.imdecode(data, cv2.IMREAD_COLOR)
            if bgr is None:
                return None
            return RawFrame(bgr, "BGR", w, h, ts.value / 1e6)
        if self._fmt == "BGR":
            return RawFrame(data.reshape(h, w, 3).copy(), "BGR", w, h, ts.value / 1e6)
        # raw bayer: model resolution is half-res
        return RawFrame(data.reshape(h, w).copy(), self._fmt, w // 2, h // 2,
                        ts.value / 1e6)

    def close(self) -> None:
        if self._cam:
            self._lib.vptpu_v4l2_close(self._cam)
            self._cam = None


class NativeMulticast:
    """Native multicast socket (send + timeout recv)."""

    def __init__(self, group: str, port: int):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._sock = lib.vptpu_mc_open(group.encode(), port)
        if not self._sock:
            raise RuntimeError(f"cannot open multicast {group}:{port}")
        self._buf = np.empty(65536, dtype=np.uint8)

    def send(self, data: bytes) -> int:
        arr = np.frombuffer(data, dtype=np.uint8)
        return int(self._lib.vptpu_mc_send(
            self._sock, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size))

    def recv(self, timeout_ms: int = 100) -> bytes | None:
        n = self._lib.vptpu_mc_recv(
            self._sock, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._buf.size, timeout_ms)
        if n <= 0:
            return None
        return bytes(self._buf[: int(n)])

    def close(self) -> None:
        if self._sock:
            self._lib.vptpu_mc_close(self._sock)
            self._sock = None


register_driver("V4L2", V4L2Driver)
