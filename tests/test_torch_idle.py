"""The port's idle-path pieces against the JAX package: ``quad2rgba`` (the
demosaic of the sample image saved before geometry arrives) and the
snapshot writer that saves it.

Tolerance: the Bayer demosaic sums the same bilinear terms in float32 in
another order, so it agrees to 1e-4 on the 0-255 scale; BGR is a channel
reorder and agrees exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.ops import frame as JF
from vision_processor_tpu_torch.ops import frame as F


def _raw(fmt: str, seed: int, h: int = 46, w: int = 70) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if fmt == "BGR" else (2 * h, 2 * w)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("fmt", ["RGGB", "GRBG", "BGR"])
def test_quad2rgba_parity(fmt):
    raw = _raw(fmt, seed=len(fmt) + ord(fmt[0]))
    want = np.asarray(JF.quad2rgba(JF.raw2quad(jnp.asarray(raw), fmt), fmt))
    got = F.quad2rgba(F.raw2quad(torch.from_numpy(raw), fmt), fmt)
    assert got.dtype == torch.float32 and got.shape == want.shape == (46, 70, 3)
    if fmt == "BGR":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), raw[..., ::-1].astype(np.float32))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fmt", ["GBRG", "BGGR"])
def test_quad2rgba_refuses_what_the_reference_refuses(fmt):
    """Neither package demosaics the GBRG and BGGR cell orders."""
    planes = np.random.default_rng(3).uniform(0, 255, (4, 8, 10)).astype(np.float32)
    with pytest.raises(ValueError):
        JF.quad2rgba(jnp.asarray(planes), fmt)
    with pytest.raises(ValueError):
        F.quad2rgba(torch.from_numpy(planes), fmt)


def test_snapshot_writer_keeps_the_newest_image(tmp_path):
    """The newest image offered for a path is written as a JPEG, clipped
    to 0-255, RGB in and RGB back; no temporary file is left."""
    import cv2

    from vision_processor_tpu_torch.io.snapshot import SnapshotWriter

    rgb = np.zeros((24, 32, 3), np.float32)
    rgb[..., 0] = 300.0  # red, above the u8 range
    writer = SnapshotWriter()
    writer.offer(np.full((24, 32, 3), 7.0, np.float32), str(tmp_path / "img" / "0.raw.jpg"))
    writer.offer(rgb, str(tmp_path / "img" / "0.raw.jpg"))
    writer.close()
    got = cv2.imread(str(tmp_path / "img" / "0.raw.jpg"))[..., ::-1]
    assert got.shape == (24, 32, 3)
    assert abs(int(got[..., 0].mean()) - 255) <= 2 and int(got[..., 1:].max()) <= 4
    assert sorted(p.name for p in (tmp_path / "img").iterdir()) == ["0.raw.jpg"]
