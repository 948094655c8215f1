"""The port's debug side channels against the JAX package: the NV12
conversions, ``Processor.debug_views``, the view cycle and snapshot naming
of ``app/debug_io.py``, the RTP/H.264 packetizer and the native H.264
encoder, on the same inputs (made from a seed with numpy).

Tolerances: the NV12 bytes, the RTP packets and the H.264 access units are
equal. The debug views agree within one u8 level in every pixel: the JAX
package renders them in one jitted XLA program, which may contract a
multiply and an add into one rounding, and the port in eager PyTorch.
"""
from __future__ import annotations

import itertools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.app import debug_io as JIO
from vision_processor_tpu.app.processor import Processor as JProcessor
from vision_processor_tpu.io import rtp as JRTP
from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
from vision_processor_tpu.models.camera import CameraModel
from vision_processor_tpu.ops import frame as JF
from vision_processor_tpu.ops import nv12 as JN
from vision_processor_tpu.utils.config import VisionConfig
from vision_processor_tpu_torch.app import debug_io as IO
from vision_processor_tpu_torch.app.processor import Processor
from vision_processor_tpu_torch.io import rtp as RTP
from vision_processor_tpu_torch.ops import frame as F
from vision_processor_tpu_torch.ops import nv12 as N

WIDTH, HEIGHT = 480, 270


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- NV12 -------------------------------------------------------------------


def _rgb_cases():
    """Odd fractions, values below 0 and above 255, and finite floats of
    every size, as (H, W, 3) float32."""
    rng = np.random.default_rng(11)
    return {
        "fractions": (rng.integers(0, 256, (32, 48, 3)) + rng.choice(
            [0.0, 0.25, 0.5, 0.75, 0.999], (32, 48, 3))).astype(np.float32),
        "out_of_range": rng.uniform(-400.0, 700.0, (16, 24, 3)).astype(np.float32),
        "finite": (rng.standard_normal((8, 10, 3))
                   * 10.0 ** rng.integers(-30, 30, (8, 10, 3))).astype(np.float32),
    }


@pytest.mark.parametrize("case", ["fractions", "out_of_range", "finite"])
def test_nv12_bytes_equal_the_jax_functions(case):
    rgb = _rgb_cases()[case]
    want = np.asarray(JN.rgb_to_nv12(jnp.asarray(rgb)))
    got = N.rgb_to_nv12(torch.from_numpy(rgb))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    gray = rgb[..., 0] - 128.0
    for offset in (127.0, 0.5):
        np.testing.assert_array_equal(
            N.f32_to_nv12(torch.from_numpy(gray), offset).numpy(),
            np.asarray(JN.f32_to_nv12(jnp.asarray(gray), offset)))
    h, w = rgb.shape[:2]
    np.testing.assert_array_equal(N.nv12_to_rgb(got, w, h), JN.nv12_to_rgb(want, w, h))


@pytest.mark.parametrize("fmt", ["RGGB", "GRBG", "BGR"])
def test_quad_to_nv12_bytes_equal(fmt):
    rng = np.random.default_rng(len(fmt))
    shape = (20, 34, 3) if fmt == "BGR" else (40, 68)
    raw = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(JN.quad_to_nv12(JF.raw2quad(jnp.asarray(raw), fmt), fmt))
    got = N.quad_to_nv12(F.raw2quad(torch.from_numpy(raw), fmt), fmt)
    np.testing.assert_array_equal(got.numpy(), want)


# -- Processor.debug_views --------------------------------------------------


@pytest.fixture(scope="module")
def camera(divb_field):
    model = CameraModel(
        focal_length=900.0, principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
        distortion_k2=0.02, pos=np.array([-2250.0, -1500.0, 4500.0]),
        size=np.array([WIDTH, HEIGHT]),
    )
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(model.to_proto(0))
    scene = Scene(bots=[SceneBot(3, "yellow", -2500.0, -1300.0, 0.7),
                        SceneBot(9, "blue", -1700.0, -1650.0, -2.0)],
                  balls=[SceneBall(-2100.0, -1150.0)], noise_sigma=1.5, seed=3)
    return geometry, {fmt: render_raw(model, geometry.field, scene, fmt)
                      for fmt in ("RGGB", "BGR")}


@pytest.mark.parametrize("fmt", ["RGGB", "BGR"])
def test_debug_views_match_the_jax_processor(camera, fmt):
    """Every view within one u8 level of the JAX Processor's, at the same
    shapes, and at most 0.1 % of a view's values differing. Measured on
    these frames (values that differ, raw/flat/grad/circ, of 388,800 each):
    RGGB 0, 3, 3, 21; BGR 0, 10, 15, 18."""
    geometry, raws = camera
    raw = raws[fmt]
    cfg = VisionConfig()
    jp, tp = JProcessor(cfg), Processor(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        tp.debug_views(raw, fmt)  # no pipeline configured yet
    for p in (jp, tp):
        p.geometry_check(WIDTH, HEIGHT, geometry, 1)
    jp._ensure_step(fmt, raw.shape)
    tp._ensure_config(fmt, raw.shape)
    want = jp.debug_views(raw, fmt)
    got = tp.debug_views(raw, fmt)
    assert list(got) == IO.DEBUG_VIEWS
    diffs = {}
    for key in IO.DEBUG_VIEWS:
        assert got[key].dtype == np.uint8 and got[key].shape == want[key].shape, key
        assert got[key].flags.c_contiguous
        diff = np.abs(got[key].astype(np.int16) - want[key].astype(np.int16))
        assert diff.max() <= 1, (key, int(diff.max()))
        diffs[key] = int(np.count_nonzero(diff))
        assert diffs[key] <= 1e-3 * diff.size, (key, diffs[key])
    assert got["raw_rgb"].shape == (HEIGHT, WIDTH, 3)
    assert got["flat_rgb"].shape[:2] == tp._bm_cfg.flat_shape == (HEIGHT, WIDTH)
    # a subset of the views: the same arrays
    part = tp.debug_views(raw, fmt, ("circ_rgb",))
    assert list(part) == ["circ_rgb"]
    np.testing.assert_array_equal(part["circ_rgb"], got["circ_rgb"])


# -- app/debug_io.py --------------------------------------------------------


class _Streamer:
    def __init__(self, active):
        self.active = active
        self.sent = []

    def send_frame(self, rgb):
        if self.active:
            self.sent.append(np.asarray(rgb))


class _Snapshots:
    def __init__(self):
        self.offered = []

    def offer(self, image, path):
        self.offered.append((path, np.asarray(image)))


class _Views:
    """A processor whose views are constant images, one value a view."""

    def debug_views(self, raw, fmt, keys=IO.DEBUG_VIEWS):
        return {k: np.full((4, 6, 3), 10 * i, np.uint8)
                for i, k in enumerate(IO.DEBUG_VIEWS) if k in keys}


def _emit(mod, active, raw_feed, interval, view_time, real_start, last):
    cfg = SimpleNamespace(raw_feed=raw_feed, debug_stream_interval_ms=interval, cam_id=2)
    frame = SimpleNamespace(data=None, fmt="RGGB")
    streamer, snapshots = _Streamer(active), _Snapshots()
    ts = mod.emit_debug_views(_Views(), streamer, snapshots, cfg, frame, view_time,
                              real_start, last)
    return ts, [s.tolist() for s in streamer.sent], [(p, i.tolist())
                                                     for p, i in snapshots.offered]


def test_emit_debug_views_equals_the_jax_function():
    """The 20 s view cycle, raw_feed, the interval snapshots' names and
    the returned timestamps, under the same clock, in every combination."""
    cases = itertools.product([False, True], [False, True], [0, 100],
                              [0.0, 19.9, 25.0, 45.0, 65.0, 85.0], [(10.0, 9.95), (10.0, 9.5)])
    seen = set()
    for active, raw_feed, interval, view_time, (real_start, last) in cases:
        args = (active, raw_feed, interval, view_time, real_start, last)
        got, want = _emit(IO, *args), _emit(JIO, *args)
        assert got == want, args
        seen.add((len(got[1]), len(got[2])))
    assert seen == {(0, 0), (1, 0), (0, 4), (1, 4)}
    assert IO.DEBUG_VIEWS == JIO.DEBUG_VIEWS
    _, _, offered = _emit(IO, False, False, 100, 0.0, 10.0, 9.5)
    assert [p for p, _ in offered] == ["img/2.raw.jpg", "img/2.flat.jpg",
                                       "img/2.gradient.jpg", "img/2.blob.jpg"]


@pytest.mark.parametrize("fmt", ["RGGB", "BGR"])
def test_emit_idle_raw_equals_the_jax_function(fmt):
    """The demosaiced frame streamed as u8 and snapshotted on the interval
    or when forced, with the same timestamps; nothing when neither."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (18, 26, 3) if fmt == "BGR" else (36, 52)).astype(np.uint8)
    frame = SimpleNamespace(data=raw, fmt=fmt)
    for active, interval, force, (real_start, last) in itertools.product(
            [False, True], [0, 100], [False, True], [(10.0, 9.95), (10.0, 9.5)]):
        cfg = SimpleNamespace(debug_stream_interval_ms=interval, cam_id=1)
        out = []
        for mod, extra in ((IO, ("cpu",)), (JIO, ())):
            streamer, snapshots = _Streamer(active), _Snapshots()
            ts = mod.emit_idle_raw(streamer, snapshots, cfg, frame, real_start, last,
                                   *extra, force_snapshot=force)
            out.append((ts, streamer.sent, snapshots.offered))
        (ts, sent, offered), (jts, jsent, joffered) = out
        assert ts == jts
        assert len(sent) == len(jsent) == int(active)
        for a, b in zip(sent, jsent):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
        assert [p for p, _ in offered] == [p for p, _ in joffered]
        for (_, a), (_, b) in zip(offered, joffered):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


# -- RTP and H.264 ------------------------------------------------------------


def _view(seed: int, w: int = 100, h: int = 60) -> np.ndarray:
    """A smooth RGB view with blocks and noise, (h, w, 3) u8 (w and h not
    multiples of 16, so the encoder pads)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], axis=-1).astype(np.int16)
    img[10:30, 20:50] = rng.integers(0, 256, 3)
    img += rng.integers(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _encoders(**kwargs):
    from vision_processor_tpu.io.native import H264Encoder as JEnc
    from vision_processor_tpu_torch.io.native import H264Encoder

    try:
        return H264Encoder(**kwargs), JEnc(**kwargs)
    except RuntimeError:
        pytest.skip("native library unavailable (no C++ compiler)")


@pytest.mark.parametrize("qp,gop", [(None, None), (24, None), (24, 30)],
                         ids=["qp0-ipcm", "qp24", "qp24-gop30"])
def test_h264_access_units_equal_the_jax_encoder(qp, gop):
    """Two frames through each tier (qp 0 of the stream config is the
    lossless I_PCM tier, qp=None here): every access unit equal to the
    JAX package's, the first an IDR behind its SPS and PPS."""
    ours, ref = _encoders(qp=qp, gop=gop)
    for k, seed in enumerate((1, 2)):
        view = _view(seed)
        got, want = ours.encode_rgb(view), ref.encode_rgb(view)
        assert got == want, (qp, gop, k)
        nals = [nal[0] & 0x1F for nal in RTP.split_annexb(got)]
        if k == 0:
            assert nals[:3] == [7, 8, 5]
        elif gop:
            assert 1 in nals  # a P picture inside the GOP


def test_rtp_packets_equal_the_jax_packetizer():
    """Single-NAL and FU-A packets (a NAL above the MTU), marker bits and
    sequence numbers equal; depacketizing gives the access unit back."""
    rng = np.random.default_rng(9)
    nals = [bytes([0x67]) + rng.integers(1, 256, 20, dtype=np.uint8).tobytes(),
            bytes([0x68]) + rng.integers(1, 256, 6, dtype=np.uint8).tobytes(),
            bytes([0x65]) + rng.integers(1, 256, 4000, dtype=np.uint8).tobytes()]
    synthetic = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
    encoded, _ = _encoders(qp=24)
    for au in (synthetic, encoded.encode_rgb(_view(3, 320, 240))):
        got = list(RTP.packetize_h264(au, 65530, 123456, 42))
        want = list(JRTP.packetize_h264(au, 65530, 123456, 42))
        assert got == want
        assert len(got) > 3  # FU-A fragments
        assert RTP.depacketize_h264(got) == JRTP.depacketize_h264(want) == au
        assert list(RTP.split_annexb(au)) == list(JRTP.split_annexb(au))
