"""The port's camera drivers against the JAX package's, on the same fakes.

The Spinnaker / mvIMPACT / Aravis drivers need an SDK and a camera that
neither test machine has, so, as tests/test_vendor_drivers.py does, they
run against fakes of the binding surfaces (PySpin, mvIMPACT.acquire, the
Aravis ctypes calls). Every case builds one fake for the JAX driver and an
identical one for the port's, runs the same calls on both, and holds the
port to the JAX driver: equal frames, formats, sizes and timestamps, equal
SDK calls, the same None frames and the same errors; then it keeps the
original test's own checks. The native library's cases (monotonic clock,
multicast loopback, V4L2 where a device exists) are those of
tests/test_native.py on the port's build. Last, the port's ``App`` runs 3
frames from a fake mvIMPACT camera delivering a GRBG mosaic, against the
JAX ``App`` on the same fake.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import importlib
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
import yaml

PKGS = ("vision_processor_tpu", "vision_processor_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _section(pkg: str, **kw):
    return _mod(pkg, "utils.config").CameraSection(**kw)


def _frame(frame):
    """A RawFrame as comparable values (None stays None)."""
    if frame is None:
        return None
    return (frame.data.tobytes(), frame.data.shape, frame.data.dtype.str, frame.fmt,
            frame.width, frame.height, frame.timestamp)


# ---------------------------------------------------------------------------
# Fake PySpin (tests/test_vendor_drivers.py)
# ---------------------------------------------------------------------------


class _Node:
    """Records SetValue calls; GetValue returns a preset."""

    def __init__(self, value=None):
        self.value = value
        self.set_calls = []

    def SetValue(self, v):
        self.set_calls.append(v)
        self.value = v

    def GetValue(self):
        return self.value


class _FakeSpinImage:
    def __init__(self, arr, ts_ns, incomplete=False):
        self._arr = arr
        self._ts = ts_ns
        self._incomplete = incomplete
        self.released = False

    def IsIncomplete(self):
        return self._incomplete

    def GetNDArray(self):
        return self._arr

    def GetTimeStamp(self):
        return self._ts

    def Release(self):
        self.released = True


_SPIN_NODES = ("PixelFormat", "Width", "Height", "ExposureAuto", "ExposureTime",
               "GainAuto", "Gain", "GammaEnable", "Gamma", "BalanceWhiteAuto",
               "BalanceRatioSelector", "BalanceRatio", "BalanceWhiteAutoProfile")


class _FakeSpinCamera:
    def __init__(self, images):
        self._images = list(images)
        self.inited = False
        self.acquiring = False
        self.deinited = False
        for name in _SPIN_NODES:
            setattr(self, name, _Node())
        self.TLStream = types.SimpleNamespace(StreamBufferHandlingMode=_Node())
        self.AcquisitionFrameRate = _Node(125.0)

    def Init(self):
        self.inited = True

    def BeginAcquisition(self):
        self.acquiring = True

    def EndAcquisition(self):
        self.acquiring = False

    def GetNextImage(self, timeout_ms):
        assert self.acquiring, "GetNextImage before BeginAcquisition"
        return self._images.pop(0)

    def DeInit(self):
        self.deinited = True

    def state(self):
        """Every node's value and SetValue calls, for comparing two fakes."""
        nodes = {n: (getattr(self, n).value, getattr(self, n).set_calls)
                 for n in _SPIN_NODES}
        mode = self.TLStream.StreamBufferHandlingMode
        return nodes, (mode.value, mode.set_calls), self.inited, self.acquiring, \
            self.deinited


class _FakeCamList:
    def __init__(self, cams):
        self._cams = cams
        self.cleared = False

    def GetSize(self):
        return len(self._cams)

    def GetByIndex(self, i):
        return self._cams[i]

    def Clear(self):
        self.cleared = True


class _FakeSpinSystem:
    def __init__(self, cams):
        self._list = _FakeCamList(cams)
        self.released = False

    def GetCameras(self):
        return self._list

    def ReleaseInstance(self):
        self.released = True


def _fake_pyspin(cams):
    mod = types.ModuleType("PySpin")
    system = _FakeSpinSystem(cams)
    mod.System = types.SimpleNamespace(GetInstance=lambda: system)
    # enum constants: distinct sentinels so SetValue calls are checkable
    for name in (
        "PixelFormat_BayerRG8", "StreamBufferHandlingMode_NewestOnly",
        "ExposureAuto_Off", "ExposureAuto_Continuous", "GainAuto_Off",
        "GainAuto_Continuous", "BalanceWhiteAuto_Off", "BalanceWhiteAuto_Continuous",
        "BalanceRatioSelector_Red", "BalanceRatioSelector_Blue",
        "BalanceWhiteAutoProfile_Outdoor", "BalanceWhiteAutoProfile_Indoor",
    ):
        setattr(mod, name, "enum:" + name)
    mod._system = system
    return mod


@pytest.fixture
def spin_pair(monkeypatch):
    """make(images_fn, **cfg) -> {pkg: (driver, camera, module)}: one fake
    camera per package, each with the images ``images_fn()`` returns."""

    def make(images_fn, **cfg):
        out = {}
        for pkg in PKGS:
            cam = _FakeSpinCamera(images_fn())
            mod = _fake_pyspin([cam])
            monkeypatch.setitem(sys.modules, "PySpin", mod)
            drv = _mod(pkg, "io.vendor").SpinnakerDriver(
                _section(pkg, driver="SPINNAKER", **cfg))
            out[pkg] = (drv, cam, mod)
        return out

    return make


def _read_both(pair, n: int = 1):
    """n reads from each package's driver: the port's frames, after checking
    them equal to the JAX driver's."""
    frames = {pkg: [pair[pkg][0].read_image() for _ in range(n)] for pkg in PKGS}
    jax_f, port_f = frames[PKGS[0]], frames[PKGS[1]]
    assert [_frame(f) for f in port_f] == [_frame(f) for f in jax_f]
    return port_f


def test_spinnaker_configures_acquisition_policy(spin_pair):
    pair = spin_pair(lambda: [], id=0, width=1920, height=1080, exposure=6.0, gain=4.0,
                     gamma=1.2, white_balance={"red": 1.3, "blue": 0.8})
    (jdrv, jcam, _), (drv, cam, mod) = pair[PKGS[0]], pair[PKGS[1]]
    assert cam.state() == jcam.state()
    assert (drv.fmt, drv.expected_frametime()) == (jdrv.fmt, jdrv.expected_frametime())
    # raw Bayer into the demosaic-free pipeline; newest-only buffers
    assert cam.PixelFormat.value == mod.PixelFormat_BayerRG8
    assert (cam.TLStream.StreamBufferHandlingMode.value
            == mod.StreamBufferHandlingMode_NewestOnly)
    assert cam.Width.value == 1920 and cam.Height.value == 1080
    # manual exposure is milliseconds in config, microseconds at the SDK
    assert cam.ExposureAuto.value == mod.ExposureAuto_Off
    assert cam.ExposureTime.value == pytest.approx(6000.0)
    assert cam.GainAuto.value == mod.GainAuto_Off
    assert cam.Gain.value == pytest.approx(4.0)
    assert cam.GammaEnable.value is True
    assert cam.Gamma.value == pytest.approx(1.2)
    assert cam.BalanceWhiteAuto.value == mod.BalanceWhiteAuto_Off
    assert cam.BalanceRatioSelector.set_calls == [
        mod.BalanceRatioSelector_Red, mod.BalanceRatioSelector_Blue]
    assert cam.BalanceRatio.set_calls == [pytest.approx(1.3), pytest.approx(0.8)]
    assert cam.inited and cam.acquiring
    assert drv.fmt == "RGGB"
    assert drv.expected_frametime() == pytest.approx(1.0 / 125.0)


def test_spinnaker_auto_modes_and_outdoor_profile(spin_pair):
    pair = spin_pair(lambda: [], exposure=0.0, gain=0.0, white_balance="OUTDOOR")
    (_, jcam, _), (_, cam, mod) = pair[PKGS[0]], pair[PKGS[1]]
    assert cam.state() == jcam.state()
    assert cam.ExposureAuto.value == mod.ExposureAuto_Continuous
    assert cam.GainAuto.value == mod.GainAuto_Continuous
    assert cam.BalanceWhiteAuto.value == mod.BalanceWhiteAuto_Continuous
    assert cam.BalanceWhiteAutoProfile.value == mod.BalanceWhiteAutoProfile_Outdoor
    assert cam.GammaEnable.set_calls == []  # gamma 1.0 leaves the gamma block off


def test_spinnaker_read_image_frame_and_timestamp(spin_pair):
    arr = np.arange(8 * 12, dtype=np.uint8).reshape(8, 12)
    images = {}

    def make():
        images[len(images)] = img = _FakeSpinImage(arr, ts_ns=2_500_000_000)
        return [img]

    pair = spin_pair(make)
    (frame,) = _read_both(pair)
    np.testing.assert_array_equal(frame.data, arr)
    assert frame.data is not arr  # copied out before Release
    assert (frame.width, frame.height, frame.fmt) == (6, 4, "RGGB")
    assert frame.timestamp == pytest.approx(2.5)  # ns -> s
    assert images[0].released and images[1].released


def test_spinnaker_incomplete_frame_returns_none_and_releases(spin_pair):
    images = []

    def make():
        images.append(_FakeSpinImage(np.zeros((4, 4), np.uint8), 0, incomplete=True))
        return images[-1:]

    pair = spin_pair(make)
    assert _read_both(pair) == [None]
    assert all(img.released for img in images)  # leaked images stall the ring
    assert pair[PKGS[1]][0]._fail_streak == pair[PKGS[0]][0]._fail_streak == 1


def test_spinnaker_close_releases_sdk(spin_pair):
    pair = spin_pair(lambda: [])
    for pkg in PKGS:
        pair[pkg][0].close()
    (_, jcam, jmod), (_, cam, mod) = pair[PKGS[0]], pair[PKGS[1]]
    assert cam.state() == jcam.state()
    assert not cam.acquiring and cam.deinited
    assert mod._system.released and jmod._system.released


def test_spinnaker_missing_camera_raises_and_clears(monkeypatch):
    for pkg in PKGS:
        mod = _fake_pyspin([])
        monkeypatch.setitem(sys.modules, "PySpin", mod)
        with pytest.raises(RuntimeError, match="Spinnaker camera 0 not found"):
            _mod(pkg, "io.vendor").SpinnakerDriver(_section(pkg, driver="SPINNAKER"))
        assert mod._system.GetCameras().cleared


def test_spinnaker_disconnect_returns_none_and_rearms(spin_pair):
    pair = spin_pair(lambda: [])
    begins = {}
    for pkg in PKGS:
        _, cam, _ = pair[pkg]

        def raising(timeout_ms):
            raise ConnectionError("device removed")

        cam.GetNextImage = raising
        begins[pkg] = 0
        orig = cam.BeginAcquisition

        def counting(pkg=pkg, orig=orig):
            begins[pkg] += 1
            orig()

        cam.BeginAcquisition = counting
    n = _mod(PKGS[1], "io.vendor")._REARM_AFTER
    assert n == _mod(PKGS[0], "io.vendor")._REARM_AFTER
    # every failing read is a None frame, not an exception; the streak
    # re-armed the acquisition stream exactly once
    assert _read_both(pair, n) == [None] * n
    assert begins == {pkg: 1 for pkg in PKGS}
    assert pair[PKGS[1]][1].acquiring
    for pkg in PKGS:  # recovery: frames flow again and the streak resets
        imgs = [_FakeSpinImage(np.zeros((4, 4), np.uint8), ts_ns=10_000_000_000)]
        pair[pkg][1].GetNextImage = lambda t, imgs=imgs: imgs.pop(0)
    (frame,) = _read_both(pair)
    assert frame is not None and pair[PKGS[1]][0]._fail_streak == 0


def test_spinnaker_timestamp_discontinuity_stays_monotonic(spin_pair):
    arr = np.zeros((4, 4), np.uint8)
    # the hardware clock re-arms mid-run: 5.0 s, 5.008 s, then 0.1 s, 0.108 s
    seq = [5.0, 5.008, 0.1, 0.108]
    pair = spin_pair(lambda: [_FakeSpinImage(arr, ts_ns=int(t * 1e9)) for t in seq])
    period = pair[PKGS[1]][0].expected_frametime()
    t0, t1, t2, t3 = (f.timestamp for f in _read_both(pair, 4))
    assert (t0, t1) == (pytest.approx(5.0), pytest.approx(5.008))
    assert t2 == pytest.approx(5.008 + period)  # the backwards jump replaced
    assert t3 == pytest.approx(t2 + period)  # and the follow-up steps forward
    assert t0 < t1 < t2 < t3


def test_spinnaker_zero_timestamp_passthrough(spin_pair):
    """Cameras without hardware timestamps report 0; the guard must not
    invent a clock for them (0 is the 'unsupported' wire convention)."""
    arr = np.zeros((4, 4), np.uint8)
    pair = spin_pair(lambda: [_FakeSpinImage(arr, ts_ns=0), _FakeSpinImage(arr, ts_ns=0)])
    assert [f.timestamp for f in _read_both(pair, 2)] == [0.0, 0.0]


@pytest.mark.parametrize("seq", [
    [1.0, 2.0, 3.0],
    [5.0, 5.01, 0.5, 0.51, 5.03, 5.04],
    [0.0, 1.0, 0.0, 0.9, 1.2],
    [2.0, 2.0, 2.0, 3.0],
])
def test_timestamp_guard_sequences(seq):
    """``_TimestampGuard`` alone gives the JAX guard's sequence: normal
    timestamps pass, a non-monotonic one becomes last + frame period, 0
    passes as 0."""
    guards = [_mod(pkg, "io.vendor")._TimestampGuard(0.02) for pkg in PKGS]
    outs = [[g(t) for t in seq] for g in guards]
    assert outs[1] == outs[0]
    positive = [t for t in outs[1] if t > 0]
    assert positive == sorted(set(positive))


# ---------------------------------------------------------------------------
# Fake mvIMPACT.acquire (tests/test_vendor_drivers.py)
# ---------------------------------------------------------------------------


class _FakeRequest:
    def __init__(self, arr, ts_us):
        self._arr = arr
        self.unlocked = False
        h, w = arr.shape
        self.imageHeight = types.SimpleNamespace(read=lambda: h)
        self.imageWidth = types.SimpleNamespace(read=lambda: w)
        self.infoTimeStamp_us = types.SimpleNamespace(read=lambda: ts_us)

    def getImageBufferDesc(self):
        return types.SimpleNamespace(getBuffer=lambda: self._arr.tobytes())

    def unlock(self):
        self.unlocked = True


class _FakeFunctionInterface:
    """Completed requests wait FIFO; imageRequestSingle refills capacity."""

    def __init__(self, dev):
        self._completed: list[int] = []
        self._requests: dict[int, _FakeRequest] = {}
        self.queued = 0  # outstanding capture capacity

    def feed(self, req):
        nr = len(self._requests)
        self._requests[nr] = req
        self._completed.append(nr)

    def imageRequestSingle(self):
        self.queued += 1

    def imageRequestWaitFor(self, timeout_ms):
        if self._completed:
            return self._completed.pop(0)
        return -1

    def isRequestNrValid(self, nr):
        return nr >= 0

    def getRequest(self, nr):
        return self._requests[nr]


class _Prop:
    def __init__(self):
        self.written = None

    def writeS(self, v):
        self.written = v

    def write(self, v):
        self.written = v


def _fake_mvimpact(device_count=1, interface=_FakeFunctionInterface):
    pkg = types.ModuleType("mvIMPACT")
    acq = types.ModuleType("mvIMPACT.acquire")
    pkg.acquire = acq

    class _Dev:
        def __init__(self):
            self.opened = False
            self.closed = False

        def open(self):
            self.opened = True

        def close(self):
            self.closed = True

    devices = [_Dev() for _ in range(device_count)]
    acq.DeviceManager = lambda: types.SimpleNamespace(
        deviceCount=lambda: len(devices), getDevice=lambda i: devices[i])
    fis = []

    def _fi(dev):
        fis.append(interface(dev))
        return fis[-1]

    acq.FunctionInterface = _fi
    settings = types.SimpleNamespace(
        imageDestination=types.SimpleNamespace(pixelFormat=_Prop()),
        cameraSettings=types.SimpleNamespace(exposeUsec=_Prop(), gain_dB=_Prop()),
    )
    acq.SettingsBlueDevice = lambda dev: settings
    acq._devices = devices
    acq._fis = fis
    acq._settings = settings
    return pkg, acq


def _install_mvimpact(monkeypatch, pkg_mod, acq):
    monkeypatch.setitem(sys.modules, "mvIMPACT", pkg_mod)
    monkeypatch.setitem(sys.modules, "mvIMPACT.acquire", acq)


@pytest.fixture
def mv_pair(monkeypatch):
    """make(**cfg) -> {pkg: (driver, acquire module)}, one fake per package."""

    def make(**cfg):
        out = {}
        for pkg in PKGS:
            pkg_mod, acq = _fake_mvimpact()
            _install_mvimpact(monkeypatch, pkg_mod, acq)
            drv = _mod(pkg, "io.vendor").MVImpactDriver(
                _section(pkg, driver="MVIMPACT", **cfg))
            out[pkg] = (drv, acq)
        return out

    return make


def _mv_state(acq):
    s = acq._settings
    return (acq._devices[0].opened, acq._devices[0].closed,
            s.imageDestination.pixelFormat.written, s.cameraSettings.exposeUsec.written,
            s.cameraSettings.gain_dB.written, [fi.queued for fi in acq._fis])


def test_mvimpact_setup_and_request_priming(mv_pair):
    pair = mv_pair(exposure=6.0, gain=2.5)
    (jdrv, jacq), (drv, acq) = pair[PKGS[0]], pair[PKGS[1]]
    assert _mv_state(acq) == _mv_state(jacq)
    assert acq._devices[0].opened
    # raw Mono8 carrying the GRBG mosaic
    assert acq._settings.imageDestination.pixelFormat.written == "Mono8"
    assert acq._settings.cameraSettings.exposeUsec.written == 6000
    assert acq._settings.cameraSettings.gain_dB.written == pytest.approx(2.5)
    assert acq._fis[0].queued == 4  # 4 requests primed so capture never starves
    assert drv.fmt == jdrv.fmt == "GRBG"
    assert drv.expected_frametime() == jdrv.expected_frametime()


def test_mvimpact_newest_frame_drain_and_requeue(mv_pair):
    pair = mv_pair()
    reqs = {}
    for pkg in PKGS:
        fi = pair[pkg][1]._fis[0]
        fi.queued = 0  # count only the requeues of this read
        reqs[pkg] = [_FakeRequest(np.full((4, 6), i, np.uint8), ts_us=1_000_000 * (i + 1))
                     for i in range(3)]
        for r in reqs[pkg]:
            fi.feed(r)
    (frame,) = _read_both(pair)
    # the newest of the 3 stale frames wins
    np.testing.assert_array_equal(frame.data, np.full((4, 6), 2, np.uint8))
    assert frame.timestamp == pytest.approx(3.0)  # us -> s
    assert (frame.width, frame.height, frame.fmt) == (3, 2, "GRBG")
    for pkg in PKGS:  # every consumed request unlocked and its slot requeued
        assert all(r.unlocked for r in reqs[pkg])
        assert pair[pkg][1]._fis[0].queued == 3


def test_mvimpact_timeout_returns_none(mv_pair):
    assert _read_both(mv_pair()) == [None]


def test_mvimpact_missing_device_raises(monkeypatch):
    for pkg in PKGS:
        _install_mvimpact(monkeypatch, *_fake_mvimpact(device_count=0))
        with pytest.raises(RuntimeError, match="mvIMPACT camera 0 not found"):
            _mod(pkg, "io.vendor").MVImpactDriver(_section(pkg, driver="MVIMPACT", id=0))


def test_mvimpact_partial_frame_requeued_not_delivered(mv_pair):
    pair = mv_pair()
    bads, goods = [], []
    for pkg in PKGS:
        fi = pair[pkg][1]._fis[0]
        fi.queued = 0
        bad = _FakeRequest(np.zeros((4, 6), np.uint8), ts_us=1_000_000)
        bad.requestResult = types.SimpleNamespace(readS=lambda: "Incomplete")
        good = _FakeRequest(np.full((4, 6), 7, np.uint8), ts_us=2_000_000)
        good.requestResult = types.SimpleNamespace(readS=lambda: "OK")
        fi.feed(bad)
        bads.append(bad)
        goods.append(good)
    assert _read_both(pair) == [None]  # a partial frame is never delivered
    for pkg, bad in zip(PKGS, bads):  # but its buffer was requeued
        assert bad.unlocked and pair[pkg][1]._fis[0].queued == 1
    for pkg, good in zip(PKGS, goods):
        pair[pkg][1]._fis[0].feed(good)
    (frame,) = _read_both(pair)
    np.testing.assert_array_equal(frame.data, np.full((4, 6), 7, np.uint8))
    assert pair[PKGS[1]][0]._fail_streak == 0


def test_mvimpact_disconnect_returns_none_and_reprimes(mv_pair):
    pair = mv_pair()
    for pkg in PKGS:
        fi = pair[pkg][1]._fis[0]

        def raising(timeout_ms):
            raise ConnectionError("bus reset")

        fi.imageRequestWaitFor = raising
        fi.queued = 0
    n = _mod(PKGS[1], "io.vendor")._REARM_AFTER
    assert _read_both(pair, n) == [None] * n
    for pkg in PKGS:  # the streak re-primed the request queue (4 fresh requests)
        assert pair[pkg][1]._fis[0].queued == 4


def test_mvimpact_timestamp_discontinuity_stays_monotonic(mv_pair):
    pair = mv_pair()
    for t_us in (4_000_000, 4_020_000, 500_000):
        for pkg in PKGS:
            pair[pkg][1]._fis[0].feed(_FakeRequest(np.zeros((4, 6), np.uint8), ts_us=t_us))
        (frame,) = _read_both(pair)  # one request a read: no newest-frame skip
        assert frame is not None
    assert frame.timestamp == pytest.approx(4.02 + 1.0 / 50.0)


# ---------------------------------------------------------------------------
# Aravis (GenICam): the newest-SUCCESS drain on a fake ctypes surface
# ---------------------------------------------------------------------------


class _FakeArvStream:
    """Output queue of completed buffers + input queue of requeued ones."""

    def __init__(self):
        self.out: list[int] = []
        self.requeued: list[int] = []


class _FakeAravis:
    def __init__(self, buffers):
        # handle -> (np.ndarray, status, ts_ns)
        self._buffers = buffers

    def arv_stream_timeout_pop_buffer(self, stream, timeout_us):
        return stream.out.pop(0) if stream.out else 0

    def arv_stream_try_pop_buffer(self, stream):
        return stream.out.pop(0) if stream.out else 0

    def arv_stream_push_buffer(self, stream, buf):
        stream.requeued.append(buf)

    def arv_buffer_get_status(self, buf):
        return self._buffers[buf][1]

    def arv_buffer_get_data(self, buf, sizeref):
        arr = self._buffers[buf][0]
        sizeref._obj.value = arr.nbytes
        return arr.ctypes.data_as(ctypes.c_void_p).value

    def arv_buffer_get_image_width(self, buf):
        return self._buffers[buf][0].shape[1]

    def arv_buffer_get_image_height(self, buf):
        return self._buffers[buf][0].shape[0]

    def arv_buffer_get_timestamp(self, buf):
        return self._buffers[buf][2]


def _aravis_pair(buffers, order):
    """{pkg: (AravisDriver with a fake lib, its stream)}, bypassing the
    hardware __init__."""
    out = {}
    for pkg in PKGS:
        cls = _mod(pkg, "io.genicam").AravisDriver
        drv = cls.__new__(cls)
        stream = _FakeArvStream()
        stream.out = list(order)
        drv._lib = _FakeAravis(buffers)
        drv._stream = stream
        drv._fps = 100.0
        out[pkg] = (drv, stream)
    return out


SUCCESS, FAILED = 0, 2


def test_aravis_drain_keeps_newest_success_buffer():
    bufs = {i: (np.full((4, 6), i, np.uint8), SUCCESS, i * 1_000_000_000)
            for i in (1, 2, 3)}
    pair = _aravis_pair(bufs, order=[1, 2, 3])
    (frame,) = _read_both(pair)
    np.testing.assert_array_equal(frame.data, bufs[3][0])
    assert frame.timestamp == pytest.approx(3.0)
    for pkg in PKGS:  # all three back in the capture ring, once each
        assert sorted(pair[pkg][1].requeued) == [1, 2, 3]
    assert pair[PKGS[1]][1].requeued == pair[PKGS[0]][1].requeued


def test_aravis_failed_newest_keeps_older_success():
    """A failed newest transfer must not discard an older good frame."""
    good = np.full((4, 6), 7, np.uint8)
    pair = _aravis_pair({1: (good, SUCCESS, 5_000_000_000),
                         2: (np.zeros((4, 6), np.uint8), FAILED, 6_000_000_000)},
                        order=[1, 2])
    (frame,) = _read_both(pair)
    np.testing.assert_array_equal(frame.data, good)
    for pkg in PKGS:
        assert sorted(pair[pkg][1].requeued) == [1, 2]


def test_aravis_all_failed_returns_none_and_requeues():
    pair = _aravis_pair({1: (np.zeros((4, 6), np.uint8), FAILED, 0)}, order=[1])
    assert _read_both(pair) == [None]
    for pkg in PKGS:
        assert pair[pkg][1].requeued == [1]


def test_aravis_missing_library_raises(monkeypatch):
    """Without libaravis both packages raise the same RuntimeError."""
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    for pkg in PKGS:
        with pytest.raises(RuntimeError, match="requires the Aravis library"):
            _mod(pkg, "io.genicam").AravisDriver(_section(pkg, driver="GENICAM"))


# ---------------------------------------------------------------------------
# the native library (tests/test_native.py) on the port's build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native():
    from vision_processor_tpu_torch.io import native as N

    if N.load_native() is None:
        pytest.skip("native toolchain unavailable")
    return N


def test_monotonic_clock(native):
    lib = native.load_native()
    t0 = lib.vptpu_monotonic_us()
    t1 = lib.vptpu_monotonic_us()
    assert 0 < t0 <= t1


def test_multicast_roundtrip(native):
    a = native.NativeMulticast("224.99.99.71", 17711)
    b = native.NativeMulticast("224.99.99.71", 17711)
    try:
        a.send(b"\x01\x02\x03frame")
        assert b.recv(500) == b"\x01\x02\x03frame"
        assert b.recv(10) is None  # the timeout path
    finally:
        a.close()
        b.close()


def test_fourcc_table_matches_jax(native):
    from vision_processor_tpu.io import native as JN

    assert native._FOURCC_TO_FMT == JN._FOURCC_TO_FMT
    assert native.fourcc("GRBG") == JN.fourcc("GRBG") == 0x47425247


def test_v4l2_driver(native):
    if not os.path.exists("/dev/video0"):
        pytest.skip("no camera device")
    from vision_processor_tpu_torch.utils.config import CameraSection

    drv = native.V4L2Driver(CameraSection(driver="V4L2", path="/dev/video0"))
    try:
        frame = drv.read_image()
        assert frame is None or frame.data.size > 0
    finally:
        drv.close()


def test_v4l2_without_library_raises(monkeypatch):
    """Without a toolchain the driver raises; it does not fall back."""
    from vision_processor_tpu_torch.io import native as N
    from vision_processor_tpu_torch.utils.config import CameraSection

    monkeypatch.setattr(N, "load_native", lambda build=True: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        N.V4L2Driver(CameraSection(driver="V4L2"))
    with pytest.raises(RuntimeError, match="native library unavailable"):
        N.NativeMulticast("224.99.99.71", 17712)


# ---------------------------------------------------------------------------
# the App on a fake mvIMPACT camera: a GRBG mosaic, both packages
# ---------------------------------------------------------------------------

APP_GROUP, APP_PORT = "224.99.99.73", 17731
WIDTH, HEIGHT = 480, 270
APP_FRAMES = 3


class _CameraFeed(_FakeFunctionInterface):
    """A camera that completes one request a wait: frames of the module's
    ``_frames`` list, 100 frames/s of hardware time, then timeouts."""

    def imageRequestWaitFor(self, timeout_ms):
        if timeout_ms > 0 and self.frames:
            self.feed(_FakeRequest(self.frames.pop(0),
                                    ts_us=10_000 * (len(self._requests) + 1)))
        return super().imageRequestWaitFor(timeout_ms)


@pytest.fixture(scope="module")
def grbg_rig(divb_field):
    """A 480x270 camera over the Div B field, a bot and a ball in its view,
    the frame rendered as a GRBG mosaic (540x960), and the geometry packet
    with the camera's calibration."""
    from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
    from vision_processor_tpu.models.camera import CameraModel

    geometry = divb_field.geometry
    model = CameraModel(focal_length=900.0,
                        principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
                        distortion_k2=0.02, pos=np.array([-2250.0, -1500.0, 4500.0]),
                        size=np.array([WIDTH, HEIGHT]))
    scene = Scene(bots=[SceneBot(3, "yellow", -2500.0, -1300.0, 0.7)],
                  balls=[SceneBall(-2100.0, -1650.0)], noise_sigma=1.5, seed=3)
    raw = render_raw(model, geometry.field, scene, "GRBG")
    geometry.ClearField("calib")
    geometry.calib.append(model.to_proto(0))
    return raw, divb_field.SerializeToString(), scene


def _run_grbg_app(pkg, tmp_path, monkeypatch, raw, packet):
    """``pkg``'s App with ``driver: MVIMPACT`` on a fake camera delivering
    APP_FRAMES copies of ``raw``; its clock reads the frames' hardware
    timestamps. Returns the detection frames it sent."""
    pkg_mod, acq = _fake_mvimpact(interface=_CameraFeed)
    _CameraFeed.frames = [raw.copy() for _ in range(APP_FRAMES)]
    _install_mvimpact(monkeypatch, pkg_mod, acq)
    UDPSocket = _mod(pkg, "net.udp").UDPSocket
    proto = _mod(pkg, "proto")
    received = []

    class Recorder(UDPSocket):
        def _parse(self, data):
            wrapper = proto.SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("detection"):
                received.append(wrapper.detection)

    class Sender(UDPSocket):
        def _parse(self, data):
            pass

    sender, stop = Sender(APP_GROUP, APP_PORT), threading.Event()

    def publish():
        while not stop.is_set():
            sender.sock.sendto(packet, (APP_GROUP, APP_PORT))
            time.sleep(0.05)

    thread = threading.Thread(target=publish, daemon=True)
    thread.start()
    recorder = Recorder(APP_GROUP, APP_PORT)
    try:
        App = _mod(pkg, "app.main").App
        app = App(str(tmp_path / "config.yml"), **({"device": "cpu"} if "torch" in pkg
                                                    else {}))
        camera = app.camera
        assert type(camera).__name__ == "MVImpactDriver" and camera.fmt == "GRBG"
        read, clock = camera.read_image, {"t": 0.0}

        def read_image():
            frame = read()
            if frame is not None:
                clock["t"] = frame.timestamp
            return frame

        camera.read_image, camera.get_time = read_image, lambda: clock["t"]
        app.run()
        time.sleep(0.3)
    finally:
        stop.set()
        thread.join()
        recorder.close()
        sender.close()
    return received


def test_app_runs_a_grbg_camera_through_mvimpact(tmp_path, monkeypatch, grbg_rig):
    """The port's App with ``driver: MVIMPACT`` takes 3 GRBG frames from the
    fake camera and sends 3 detection frames with the JAX App's robots (id,
    team: equal; position within 0.5 mm, orientation within 1e-3 rad) and
    balls (within 0.5 mm); the robot and the ball are found within 30 and
    40 mm."""
    raw, packet, scene = grbg_rig
    (tmp_path / "heights.yml").write_text(yaml.dump({"TeamA": 143.0, "TeamB": 147.0}))
    (tmp_path / "config.yml").write_text(yaml.dump({
        "cam_id": 0, "bot_heights_file": str(tmp_path / "heights.yml"),
        "camera": {"driver": "MVIMPACT"},
        "network": {"vision_ip": APP_GROUP, "vision_port": APP_PORT,
                    "gc_ip": APP_GROUP, "gc_port": APP_PORT + 1},
        "stream": {"active": False}, "debug": {"wait_for_geometry": True},
        "thresholds": {"blobs": 128},
    }))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = {pkg: _run_grbg_app(pkg, tmp_path, monkeypatch, raw, packet) for pkg in PKGS}
    finally:
        torch.set_num_threads(n)

    def frames(received):
        out = {}
        for d in received:
            bots = sorted((team, r.robot_id, r.x, r.y, r.orientation)
                          for team, robots in (("y", d.robots_yellow),
                                               ("b", d.robots_blue))
                          for r in robots)
            out[d.frame_number] = (bots, sorted((b.x, b.y) for b in d.balls))
        return out

    jax_f, port_f = frames(got[PKGS[0]]), frames(got[PKGS[1]])
    assert sorted(port_f) == sorted(jax_f) == list(range(1, APP_FRAMES + 1))
    for fn, (bots, balls) in port_f.items():
        jbots, jballs = jax_f[fn]
        assert [b[:2] for b in bots] == [b[:2] for b in jbots] == [("y", 3)]
        np.testing.assert_allclose([b[2:4] for b in bots], [b[2:4] for b in jbots],
                                   atol=0.5)
        np.testing.assert_allclose([b[4] for b in bots], [b[4] for b in jbots],
                                   atol=1e-3)
        assert len(balls) == len(jballs) == 1
        np.testing.assert_allclose(balls, jballs, atol=0.5)
        truth, ball = scene.bots[0], scene.balls[0]
        assert np.hypot(bots[0][2] - truth.x, bots[0][3] - truth.y) < 30.0
        assert np.hypot(balls[0][0] - ball.x, balls[0][1] - ball.y) < 40.0
