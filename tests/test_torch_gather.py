"""The PyTorch port's gather resample (kernel B7) against the JAX package.

The corner-stack gather's plain version is held bit for bit against the
JAX package's ``gather_corners_pallas`` in the Pallas interpreter, the
whole gather resample against ``resample_flat_grid_raw`` on a JAX-computed
grid, and the TPU banding helpers (kept for parity) against theirs. The
kernel itself runs only on the card (``-m cuda``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.models import camera as JC
from vision_processor_tpu.models.perspective import Perspective as JPerspective
from vision_processor_tpu.ops import frame as JF
from vision_processor_tpu.ops import pallas_resample as JPR
from vision_processor_tpu_torch.models import camera as C
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import frame as F
from vision_processor_tpu_torch.ops import gather_corners as G
from vision_processor_tpu_torch.ops import warp as W
from vision_processor_tpu_torch.utils.state import to_torch

WIDTH, HEIGHT = 480, 270


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast and leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _model(yaw: float) -> JC.CameraModel:
    """The small camera of the slice tests, turned about its optical axis."""
    model = JC.CameraModel(
        focal_length=900.0, principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
        distortion_k2=0.02, pos=np.array([-2250.0, -1500.0, 4500.0]),
        size=np.array([WIDTH, HEIGHT]),
    )
    if yaw:
        rz = JC.euler_to_matrix(np.array([0.0, 0.0, yaw]))
        model.quat = JC.matrix_to_quat(model.rotation() @ rz)
    return model


def _port_model(model: JC.CameraModel) -> C.CameraModel:
    return C.CameraModel(**{k: getattr(model, k) for k in (
        "focal_length", "principal_point", "distortion_k2", "pos", "quat", "size")})


@pytest.fixture(scope="module", params=[0.0, 0.8], ids=["level", "turned"])
def geom(request, divb_field):
    """(model, field_scale, field_offset, flat shape) at resampling 1.25;
    the turned camera is one that warp_fits rejects."""
    model = _model(request.param)
    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(model.to_proto(0))
    persp = JPerspective(cam_id=0)
    assert persp.update_geometry(geometry, 1, WIDTH, HEIGHT, 150.0, 1.25)
    out_shape = (int(persp.reprojected_field_size[1]), int(persp.reprojected_field_size[0]))
    offset = (float(persp.visible_field_extent[0]), float(persp.visible_field_extent[2]))
    return model, float(persp.field_scale), offset, out_shape


def _near_identity_map(rng, h, w, hf, wf):
    """(y0, x0) i32 corner maps that vary smoothly, as a camera's do (the
    TPU kernel's banding contract, which band_fits checks)."""
    yy, xx = np.meshgrid(np.linspace(2, h - 4, hf), np.linspace(2, w - 4, wf),
                         indexing="ij")
    y0 = np.clip((yy + rng.uniform(-1, 1, yy.shape)).astype(np.int32), 0, h - 2)
    x0 = np.clip((xx + rng.uniform(-1, 1, xx.shape)).astype(np.int32), 0, w - 2)
    return y0, x0


def test_gather_corners_matches_pallas():
    """B7's plain version on the u8 stack and the flat index equals the
    Pallas kernel (interpreter) on the f32 stack and (y0, x0), bit for bit."""
    rng = np.random.default_rng(0)
    h, w, hf, wf = 40, 256, 24, 248
    stacked = rng.integers(0, 256, (h, w, 16), dtype=np.uint8)
    y0, x0 = _near_identity_map(rng, h, w, hf, wf)
    want = np.asarray(JPR.gather_corners_pallas(
        jnp.asarray(stacked, jnp.float32), jnp.asarray(y0), jnp.asarray(x0),
        interpret=True))
    got = G.gather_corners(torch.from_numpy(stacked.reshape(-1, 16)),
                           torch.from_numpy(y0 * w + x0))
    assert got.dtype == torch.float32 and got.shape == (hf, wf, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_starts_and_band_fits_match(geom):
    model, scale, offset, out_shape = geom
    args = (scale, offset, out_shape, model.size, 150.0)
    assert G.band_fits(_port_model(model), *args) == JPR.band_fits(model, *args)

    rng = np.random.default_rng(1)
    h, w = 300, 500
    y0, x0 = _near_identity_map(rng, h, w, 4 * G.TILE_H, 3 * G.TILE_W)
    want = JPR.tile_starts(jnp.asarray(y0), jnp.asarray(x0), h, w)
    got = G.tile_starts(torch.from_numpy(y0), torch.from_numpy(x0), h, w)
    for g, j in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("fmt", ["RGGB", "GRBG", "BGR"])
def test_gather_resample_matches_jax(geom, fmt):
    """The port's gather resample (corner stack, B7's gather, lerp, dRGB)
    on the JAX grid equals the JAX package's ``resample_flat_grid_raw``
    (u32-built corner stack, XLA gather) bit for bit."""
    model, scale, offset, out_shape = geom
    jg = JF.resample_grid(jnp.asarray(model.packed()), jnp.float32(150.0), scale,
                          offset, out_shape, (HEIGHT, WIDTH))
    jg = {k: np.asarray(v) for k, v in jg.items()}
    rng = np.random.default_rng(2)
    shape = (2 * HEIGHT, 2 * WIDTH) if fmt != "BGR" else (HEIGHT, WIDTH, 3)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(JF.resample_flat_grid_raw(jnp.asarray(raw), jg, fmt))
    before = cuda.LAUNCHES["gather_corners"]
    got = F.resample_flat_grid_raw(torch.from_numpy(raw), to_torch(jg, "cpu"), fmt)
    assert cuda.LAUNCHES["gather_corners"] == before  # CPU: the plain version
    assert got.shape == out_shape + (3,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_turned_camera_takes_the_gather(geom):
    """warp_fits rejects the turned camera, so "auto" resolves to the
    gather on the card as well as on the CPU; the level one takes the warp
    on the card."""
    model, scale, offset, out_shape = geom
    entries = [(model, scale, offset, 150.0)]
    fits = W.cameras_fit_warp(entries, out_shape, (HEIGHT, WIDTH))
    assert fits == np.array_equal(model.quat, _model(0.0).quat)
    for dev in ("cpu", "cuda"):
        mode = W.resolve_resample_mode("auto", entries, out_shape, (HEIGHT, WIDTH), dev)
        assert mode == ("warp" if fits and dev == "cuda" else "gather")


@pytest.mark.cuda
def test_gather_corners_kernel_on_card(geom, cuda_device):
    model, scale, offset, out_shape = geom
    packed = torch.from_numpy(model.packed()).to(cuda_device)
    grid = F.resample_grid(packed, 150.0, scale, offset, out_shape, (HEIGHT, WIDTH))
    raw = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2 * HEIGHT, 2 * WIDTH), dtype=np.uint8)).to(cuda_device)
    stacked = F.corner_stack(raw, "RGGB").reshape(-1, 16)
    before = cuda.LAUNCHES["gather_corners"]
    got = G.gather_corners(stacked, grid["idx"])
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["gather_corners"] == before + 1
    assert torch.equal(got, G._gather_corners_plain(stacked, grid["idx"]))
