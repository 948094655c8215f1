"""Parity of the PyTorch port's resample path with the JAX package: camera
projections, the warp grid and fit check, the two-pass band resample
(kernel B1) and the cached-grid gather.

The JAX band pass runs through the Pallas interpreter, as the JAX
package's own tests run it; JAX-computed grids are fed into the port
through ``utils.state.to_torch`` so the kernel is tested apart from the
grid precompute.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.models import camera as JC
from vision_processor_tpu.models.perspective import Perspective as JPerspective
from vision_processor_tpu.ops import frame as JF
from vision_processor_tpu.ops import warp as JW
from vision_processor_tpu_torch.models import camera as C
from vision_processor_tpu_torch.ops import frame as F
from vision_processor_tpu_torch.ops import warp as W
from vision_processor_tpu_torch.utils.state import to_numpy, to_torch

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


def small_model(yaw: float = 0.0) -> JC.CameraModel:
    model = JC.CameraModel(
        focal_length=900.0, principal_point=np.array([WIDTH / 2, HEIGHT / 2]),
        distortion_k2=0.02, pos=np.array([-2250.0, -1500.0, 4500.0]),
        size=np.array([WIDTH, HEIGHT]),
    )
    if yaw:
        rz = JC.euler_to_matrix(np.array([0.0, 0.0, yaw]))
        model.quat = JC.matrix_to_quat(model.rotation() @ rz)
    return model


@pytest.fixture(scope="module")
def geom(divb_field):
    """(perspective, model) of the small camera at resampling factor 1.25."""
    geometry = divb_field.geometry
    model = small_model()
    geometry.ClearField("calib")
    geometry.calib.append(model.to_proto(0))
    persp = JPerspective(cam_id=0)
    assert persp.update_geometry(geometry, 1, WIDTH, HEIGHT, 150.0, 1.25)
    return persp, model


def _grid_args(persp):
    hf, wf = int(persp.reprojected_field_size[1]), int(persp.reprojected_field_size[0])
    offset = (float(persp.visible_field_extent[0]), float(persp.visible_field_extent[2]))
    return float(persp.field_scale), offset, (hf, wf), (HEIGHT, WIDTH)


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (2 * HEIGHT, 2 * WIDTH), dtype=np.uint8)


def test_projection_parity(geom):
    _, model = geom
    packed = model.packed()
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-4500, 0, 500), rng.uniform(-3000, 0, 500),
                    rng.uniform(0, 150, 500)], -1).astype(np.float32)
    img_j = np.asarray(JC.field2image_packed(jnp.asarray(packed), jnp.asarray(pts)))
    img_t = C.field2image_packed(torch.from_numpy(packed), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(img_t, img_j, atol=1e-3)

    pix = np.stack([rng.uniform(-500, 1000, 500), rng.uniform(-500, 800, 500)],
                   -1).astype(np.float32)
    h = rng.uniform(0, 150, 500).astype(np.float32)
    fld_j = np.asarray(JC.image2field_packed(jnp.asarray(packed), jnp.asarray(pix),
                                             jnp.asarray(h)))
    fld_t = C.image2field_packed(torch.from_numpy(packed), torch.from_numpy(pix),
                                 torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(np.isnan(fld_t), np.isnan(fld_j))
    np.testing.assert_allclose(fld_t, fld_j, atol=1e-2)


def test_host_camera_matches(geom):
    _, model = geom
    port = C.CameraModel(
        focal_length=model.focal_length, principal_point=model.principal_point,
        distortion_k2=model.distortion_k2, pos=model.pos, quat=model.quat,
        size=model.size,
    )
    np.testing.assert_array_equal(port.packed(), model.packed())
    pts = np.array([[-2000.0, -1200.0, 150.0], [-3000.0, -800.0, 0.0]])
    np.testing.assert_array_equal(port.field2image(pts), model.field2image(pts))
    proto = port.to_proto(0)
    assert C.CameraModel.from_proto(proto).focal_length == model.focal_length


def test_plain_geometry_matches_proto(divb_field):
    """The port's plain geometry (no protobuf) gives the parsed proto's
    values, markings, perspective, field marks and rendered frame."""
    from vision_processor_tpu_torch.io.synthetic import Scene, SceneBall, render_raw
    from vision_processor_tpu_torch.models.device_finish import pack_field_marks
    from vision_processor_tpu_torch.models.perspective import Perspective
    from vision_processor_tpu_torch.net import geometry_io as G

    proto = type(divb_field.geometry)()
    proto.CopyFrom(divb_field.geometry)
    names = [f.name for f in proto.field.DESCRIPTOR.fields
             if f.name not in ("field_lines", "field_arcs")]
    plain = G.geometry_from_dict(
        {"field": {n: getattr(proto.field, n) for n in names if proto.field.HasField(n)}})
    for n in names:
        assert plain.field.HasField(n) == proto.field.HasField(n), n
        assert getattr(plain.field, n) == getattr(proto.field, n), n
    for kind, keys in (("field_lines", ("name", "p1.x", "p1.y", "p2.x", "p2.y", "thickness")),
                       ("field_arcs", ("name", "center.x", "center.y", "radius", "a1", "a2",
                                       "thickness"))):
        pairs = list(zip(getattr(plain.field, kind), getattr(proto.field, kind), strict=True))
        assert pairs
        for a, b in pairs:
            for key in keys:
                get = lambda o: functools.reduce(getattr, key.split("."), o)  # noqa: E731
                assert get(a) == get(b), (kind, key)

    model = C.CameraModel(**{k: getattr(small_model(), k) for k in (
        "focal_length", "principal_point", "distortion_k2", "pos", "quat", "size")})
    proto.ClearField("calib")
    proto.calib.append(model.to_proto(0))
    plain.calib = [G.calibration_from_model(model, 0)]
    for f in proto.calib[0].DESCRIPTOR.fields:
        assert getattr(plain.calib[0], f.name) == getattr(proto.calib[0], f.name), f.name
        assert plain.calib[0].HasField(f.name) == proto.calib[0].HasField(f.name), f.name

    persps = []
    for geometry in (plain, proto):
        persp = Perspective(cam_id=0)
        assert persp.update_geometry(geometry, 1, WIDTH, HEIGHT, 150.0, 1.25)
        persps.append(persp)
    for key in ("field_scale", "visible_field_extent", "reprojected_field_size",
                "min_blob_radius", "max_blob_radius"):
        np.testing.assert_array_equal(getattr(persps[0], key), getattr(persps[1], key))
    marks = [pack_field_marks(g.field, 10.0) for g in (plain, proto)]
    for key in marks[1]:
        np.testing.assert_array_equal(marks[0][key], marks[1][key])
    scene = Scene(balls=[SceneBall(-2100.0, -1150.0)], noise_sigma=1.5, seed=3)
    np.testing.assert_array_equal(render_raw(model, plain.field, scene, "RGGB"),
                                  render_raw(model, proto.field, scene, "RGGB"))


@pytest.mark.parametrize("fmt", ["RGGB", "GRBG"])
def test_warp_grid_parity(geom, fmt):
    persp, model = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    jg = JW.warp_grid(jnp.asarray(model.packed()), jnp.float32(150.0), scale, offset,
                      out_shape, plane_shape, fmt)
    tg = W.warp_grid(torch.from_numpy(model.packed()), 150.0, scale, offset,
                     out_shape, plane_shape, fmt)
    tg = to_numpy(tg)
    for key in ("pos1", "pos2"):
        assert tg[key].shape == np.asarray(jg[key]).shape
        np.testing.assert_allclose(tg[key], np.asarray(jg[key]), atol=1e-3)
    for key in ("r01", "r02"):
        np.testing.assert_array_equal(tg[key], np.asarray(jg[key]))


@pytest.mark.parametrize("yaw", [0.0, 0.8])
def test_warp_fits_parity(geom, yaw):
    persp, _ = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    model = small_model(yaw)
    got = W.warp_fits(model, scale, offset, out_shape, plane_shape, 150.0)
    want = JW.warp_fits(model, scale, offset, out_shape, plane_shape, 150.0)
    assert got == want == (yaw == 0.0)


def test_band_pass_parity(geom):
    """Both warp passes on the JAX grid: the port's band pass (two taps at
    floor(p)) vs the Pallas kernel (hat weights from the window start):
    atol 1e-3 on values in [0, 255] (weights from p - r0 vs p - floor(p))."""
    persp, model = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    jg = JW.warp_grid(jnp.asarray(model.packed()), jnp.float32(150.0), scale, offset,
                      out_shape, plane_shape, "RGGB")
    h = plane_shape[0]
    hp = W._pad_to(h, W.LAN)
    src1 = JW.cells_chfirst_t(jnp.asarray(_raw(2)), "RGGB", hp)
    mid_j = JW.band_pass(src1, jg["pos1"], jg["r01"], interpret=True)
    tg = to_torch({k: np.asarray(v) for k, v in jg.items()}, "cpu")
    mid_t = W.band_pass(torch.from_numpy(np.array(src1)), tg["pos1"])
    np.testing.assert_allclose(mid_t.numpy(), np.asarray(mid_j), atol=1e-3)

    rng = np.random.default_rng(3)
    src2 = rng.uniform(0, 255, (4, h, tg["pos2"].shape[2])).astype(np.float32)
    out_j = JW.band_pass(jnp.asarray(src2), jg["pos2"], jg["r02"], interpret=True)
    out_t = W.band_pass(torch.from_numpy(src2), tg["pos2"])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-3)


@pytest.mark.parametrize("fmt", ["RGGB", "BGR"])
def test_cells_chfirst_t_parity(fmt):
    rng = np.random.default_rng(4)
    shape = (2 * HEIGHT, 2 * WIDTH) if fmt != "BGR" else (HEIGHT, WIDTH, 3)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(JW.cells_chfirst_t(jnp.asarray(raw), fmt, 384))
    got = W.cells_chfirst_t(torch.from_numpy(raw), fmt, 384).numpy()
    np.testing.assert_array_equal(got, want)


def test_resample_flat_warp_parity(geom):
    """The whole two-pass warp on the JAX grid, raw frame -> flat dRGB."""
    persp, model = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    jg = JW.warp_grid(jnp.asarray(model.packed()), jnp.float32(150.0), scale, offset,
                      out_shape, plane_shape, "RGGB")
    raw = _raw(5)
    want = np.asarray(JW.resample_flat_warp(jnp.asarray(raw), jg, "RGGB", out_shape,
                                            plane_shape))
    tg = to_torch({k: np.asarray(v) for k, v in jg.items()}, "cpu")
    got = W.resample_flat_warp(torch.from_numpy(raw), tg, "RGGB", out_shape,
                               plane_shape).numpy()
    assert got.shape == want.shape == out_shape + (3,)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_gather_resample_parity(geom):
    persp, model = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    jg = JF.resample_grid(jnp.asarray(model.packed()), jnp.float32(150.0), scale,
                          offset, out_shape, plane_shape)
    jg = {k: np.asarray(v) for k, v in jg.items()}
    tg = to_numpy(F.resample_grid(torch.from_numpy(model.packed()), 150.0, scale,
                                  offset, out_shape, plane_shape))
    same = tg["idx"] == jg["idx"]
    assert same.mean() > 0.999  # a floor() on an exact cell edge may flip
    np.testing.assert_allclose(tg["ub"][same], jg["ub"][same], atol=1e-3)
    np.testing.assert_allclose(tg["vb"][same], jg["vb"][same], atol=1e-3)

    raw = _raw(6)
    want = np.asarray(JF.resample_flat_grid_raw(jnp.asarray(raw), jg, "RGGB"))
    got = F.resample_flat_grid_raw(torch.from_numpy(raw), to_torch(jg, "cpu"),
                                   "RGGB").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_interp_matches_jnp():
    rng = np.random.default_rng(8)
    xp = np.cumsum(rng.uniform(0.01, 2.0, (6, 50)), axis=1).astype(np.float32)
    fp = rng.uniform(-100, 100, (6, 50)).astype(np.float32)
    x = rng.uniform(-5, 110, (6, 80)).astype(np.float32)
    got = W.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    for i in range(6):
        want = np.asarray(jnp.interp(jnp.asarray(x[i]), jnp.asarray(xp[i]),
                                     jnp.asarray(fp[i])))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6, atol=1e-5)


def test_resolve_resample_mode(geom):
    persp, model = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    entries = [(model, scale, offset, 150.0)]
    assert W.resolve_resample_mode("auto", entries, out_shape, plane_shape,
                                   "cpu") == "gather"
    assert W.resolve_resample_mode("warp", entries, out_shape, plane_shape,
                                   "cpu") == "warp"
    assert W.cameras_fit_warp(entries, out_shape, plane_shape)


@pytest.mark.cuda
def test_band_pass_kernel_on_card(geom, cuda_device):
    persp, model = geom
    scale, offset, out_shape, plane_shape = _grid_args(persp)
    packed = torch.from_numpy(model.packed()).to(cuda_device)
    grid = W.warp_grid(packed, 150.0, scale, offset, out_shape, plane_shape, "RGGB")
    raw = torch.from_numpy(_raw(7)).to(cuda_device)
    src1 = W.cells_chfirst_t(raw, "RGGB", W._pad_to(plane_shape[0], W.LAN))
    got = W.band_pass(src1, grid["pos1"])
    want = W._band_pass_plain(src1, grid["pos1"])
    assert torch.equal(got, want)
