"""Kernel E2/E3, the sampler of the in-line projection resample: the port's
plain version against the JAX package's ``sample_planes_packed`` ->
``combine_planes`` -> ``rgb_to_drgb`` chain and against the TPU kernels
(``experiments/k2_proto.py`` and ``experiments/k2_stages.py``
``resample_k2``, in interpret mode), on identical positions fed from numpy;
the exact per-plane sampler against the JAX package's; and, on the card,
the CUDA kernel against the plain version, bit for bit.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.models.camera import field2image_packed as j_field2image
from vision_processor_tpu.ops import frame as JF
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import frame as F
from vision_processor_tpu_torch.ops import resample_packed as RP

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(fmt: str, h: int, w: int, seed: int) -> np.ndarray:
    """A random raw frame whose plane grid is (h, w)."""
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if fmt == "BGR" else (2 * h, 2 * w)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _positions(h: int, w: int, seed: int, shape=(24, 40)):
    """Image positions over the whole plane grid and up to 4 px beyond each
    side, plus exact cell edges, texel centers and the four corners."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-4.0, w + 4.0, shape).astype(np.float32)
    py = rng.uniform(-4.0, h + 4.0, shape).astype(np.float32)
    px[0, :8] = [-0.75, 0.5, 0.75, 1.0, w - 0.5, w - 0.25, w + 0.5, 3.0]
    py[0, :8] = [0.5, -0.75, 0.25, 2.0, h - 0.5, h + 0.75, 1.5, h - 1.0]
    px[1, :4] = [-2.0, w + 2.0, -2.0, w + 2.0]  # the four corners, off the image
    py[1, :4] = [-2.0, -2.0, h + 2.0, h + 2.0]
    return px, py


def _jax_chain(raw, px, py, fmt):
    planes = JF.raw2planes_packed(jnp.asarray(raw), fmt)
    samples = JF.sample_planes_packed(planes, jnp.asarray(px), jnp.asarray(py), fmt)
    return np.asarray(JF.rgb_to_drgb(*JF.combine_planes(samples, fmt)))


@pytest.mark.parametrize("fmt", ["RGGB", "GRBG", "BGR"])
def test_sampler_matches_jax(fmt):
    """Every entry of the port's sampler on the JAX package's positions:
    the raw frame, the packed planes in u8 and f32, and the chain of
    ``sample_planes_packed``; and the exact sampler (``raw2quad`` +
    ``sample_rgb``). On the CPU the plain versions run: no launch."""
    h, w = 37, 53  # odd sides
    raw = _raw(fmt, h, w, seed=len(fmt))
    px, py = _positions(h, w, seed=3)
    want = _jax_chain(raw, px, py, fmt)
    t_raw, t_px, t_py = (torch.from_numpy(a) for a in (raw, px, py))
    before = dict(cuda.LAUNCHES)
    planes = F.raw2planes_packed(t_raw, fmt)
    got = {
        "raw": RP.resample_packed(t_raw, t_px, t_py, fmt),
        "planes f32": RP.resample_packed_planes(planes, t_px, t_py, fmt),
        "planes u8": RP.resample_packed_planes(planes.to(torch.uint8), t_px, t_py, fmt),
        "chain": F.rgb_to_drgb(*F.combine_planes(
            F.sample_planes_packed(planes, t_px, t_py, fmt), fmt)),
    }
    assert cuda.LAUNCHES == before
    for label, out in got.items():
        assert out.shape == (24, 40, 3) and out.dtype == torch.float32, label
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-4, err_msg=label)
    # off the image the cell is clamped: the corners read the corner cells
    assert np.isfinite(want).all()

    jexact = JF.rgb_to_drgb(*JF.sample_rgb(JF.raw2quad(jnp.asarray(raw), fmt),
                                           jnp.asarray(px), jnp.asarray(py), fmt))
    exact = F.rgb_to_drgb(*F.sample_rgb(F.raw2quad(t_raw, fmt), t_px, t_py, fmt))
    np.testing.assert_allclose(exact.numpy(), np.asarray(jexact), rtol=0, atol=1e-4)


def test_resample_flat_packed_matches_jax(overhead_model):
    """The whole in-line resample (projection + sampler) and the exact one
    against the JAX package's, on a 960x720 camera's flat grid. The
    projections agree to 1e-3 px; where a position lies that close to a
    pixel edge the two packages may take neighbouring cells, so pixels are
    compared where both packages' cells agree."""
    hf, wf = 120, 200
    scale, offset, maxh = 30.0, (-5250.0, -1800.0), 150.0  # beyond the view
    packed_cam = overhead_model.packed().astype(np.float32)
    raw = _raw("RGGB", 720, 960, seed=9)
    jcam = jnp.asarray(packed_cam)
    jplanes = JF.raw2planes_packed(jnp.asarray(raw), "RGGB")
    want = np.asarray(JF.resample_flat_packed(jplanes, jcam, jnp.float32(maxh), scale,
                                              offset, (hf, wf), "RGGB"))
    want_exact = np.asarray(JF.resample_flat(JF.raw2quad(jnp.asarray(raw), "RGGB"), jcam,
                                             jnp.float32(maxh), scale, offset, (hf, wf),
                                             "RGGB"))
    cam = torch.from_numpy(packed_cam)
    traw = torch.from_numpy(raw)
    got = F.resample_flat_packed(F.raw2planes_packed(traw, "RGGB"), cam, maxh, scale,
                                 offset, (hf, wf), "RGGB").numpy()
    got_exact = F.resample_flat(F.raw2quad(traw, "RGGB"), cam, maxh, scale, offset,
                                (hf, wf), "RGGB").numpy()

    ys = jnp.arange(hf, dtype=jnp.float32) * scale + offset[1]
    xs = jnp.arange(wf, dtype=jnp.float32) * scale + offset[0]
    gx, gy = jnp.meshgrid(xs, ys)
    jimg = np.asarray(j_field2image(jcam, jnp.stack([gx, gy, jnp.full_like(gx, maxh)],
                                                    axis=-1)))
    timg = F.flat_image_points(cam, maxh, scale, offset, (hf, wf)).numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-3)
    # off-image positions on all four sides are in the grid
    assert (jimg[..., 0] < 0).any() and (jimg[..., 0] > 960).any()
    assert (jimg[..., 1] < 0).any() and (jimg[..., 1] > 720).any()

    def cells(img, shift):  # the cell each plane's quarter-shifted tap falls in
        return np.floor(img - 0.5 + shift)
    same = np.ones((hf, wf), bool)
    for shift in (-0.25, 0.0, 0.25):
        same &= (cells(timg, shift) == cells(jimg, shift)).all(axis=-1)
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_exact[same], want_exact[same], rtol=0, atol=1e-4)


def _experiment(name: str):
    """An experiment module, imported by path (its main() does not run)."""
    spec = importlib.util.spec_from_file_location(f"experiments_{name}",
                                                  ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k2_region():
    """E2/E3's own rig (k2_proto.build_inputs: a 1080p RGGB frame, field
    scale 4.857, offset (-4587, -2810), height 150), flat rows 200-215 and
    columns 300-555: a region whose tiles fit the TPU kernels' window."""
    k2 = _experiment("k2_proto")
    raw, packed_cam = k2.build_inputs()
    ys = jnp.arange(200, 216, dtype=jnp.float32) * 4.857 - 2810.0
    xs = jnp.arange(300, 556, dtype=jnp.float32) * 4.857 - 4587.0
    gx, gy = jnp.meshgrid(xs, ys)
    img = np.asarray(j_field2image(jnp.asarray(packed_cam, dtype=jnp.float32),
                                   jnp.stack([gx, gy, jnp.full_like(gx, 150.0)], axis=-1)))
    return k2, raw, np.ascontiguousarray(img[..., 0]), np.ascontiguousarray(img[..., 1])


@pytest.mark.parametrize("name", ["k2_proto", "k2_stages"])
def test_plain_matches_the_tpu_kernels(k2_region, name):
    k2, raw, px, py = k2_region
    mod = k2 if name == "k2_proto" else _experiment(name)
    packed = np.array(JF.raw2planes_packed(jnp.asarray(raw), "RGGB"))
    want = np.asarray(mod.resample_k2(jnp.asarray(packed), jnp.asarray(px),
                                      jnp.asarray(py), interpret=True))
    got = RP.resample_packed_planes(torch.from_numpy(packed), torch.from_numpy(px),
                                    torch.from_numpy(py), "RGGB").numpy()
    assert got.shape == want.shape == (16, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got_raw = RP.resample_packed(torch.from_numpy(raw), torch.from_numpy(px),
                                 torch.from_numpy(py), "RGGB").numpy()
    np.testing.assert_array_equal(got_raw, got)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,h,w", [("RGGB", 540, 960), ("GRBG", 70, 40),
                                     ("BGR", 540, 960), ("BGR", 37, 53)])
def test_kernel_matches_plain_on_card(cuda_device, fmt, h, w):
    """Bit-equal on every entry, positions off all four sides included,
    with dense and interleaved (the projection's layout) positions."""
    raw = torch.from_numpy(_raw(fmt, h, w, seed=w)).to(cuda_device)
    px, py = (torch.from_numpy(a).to(cuda_device) for a in _positions(h, w, seed=h,
                                                                       shape=(96, 160)))
    want = RP._resample_raw_plain(raw, px, py, fmt)
    n = cuda.LAUNCHES["resample_packed"]
    got = RP.resample_packed(raw, px, py, fmt)
    img = torch.stack([px, py], dim=-1)
    inter = RP.resample_packed(raw, img[..., 0], img[..., 1], fmt)
    planes = F.raw2planes_packed(raw, fmt)
    on_f32 = RP.resample_packed_planes(planes, px, py, fmt)
    on_u8 = RP.resample_packed_planes(planes.to(torch.uint8), px, py, fmt)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["resample_packed"] == n + 4
    for out in (got, inter, on_f32, on_u8):
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    raw = torch.zeros((10, 12), dtype=torch.uint8, device=cuda_device)
    px = torch.zeros((4, 6), device=cuda_device)
    with pytest.raises(ValueError):
        RP.resample_packed(raw.float(), px, px, "RGGB")
    with pytest.raises(ValueError):
        RP.resample_packed(raw[:, :11], px, px, "RGGB")  # odd width, not contiguous
    with pytest.raises(ValueError):
        RP.resample_packed(raw, px, px[:, :5], "RGGB")   # position shapes differ
    with pytest.raises(ValueError):
        RP.resample_packed(raw, px.t(), px.t(), "RGGB")  # not a dense layout
    with pytest.raises(ValueError):
        RP.resample_packed_planes(torch.zeros((5, 6, 3), device=cuda_device), px, px,
                                  "RGGB")
