"""Kernel E1, the banded warp pass with window starts: the port's plain
version against the TPU kernel (``experiments/pallas_band_warp.py``
``band_warp_pallas`` in interpret mode) and against the experiment's 2-tap
``reference`` at a shape whose windows fit, the precondition check, and, on
the card, the CUDA kernel against the plain version, bit for bit.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu_torch.ops import band_warp as BW
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import warp as W

ROOT = Path(__file__).resolve().parents[1]
WIN = 16


@pytest.fixture(scope="module")
def pallas_band_warp():
    """experiments/pallas_band_warp.py, imported by path (its main() does
    not run)."""
    spec = importlib.util.spec_from_file_location(
        "experiments_pallas_band_warp", ROOT / "experiments" / "pallas_band_warp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(ch=4, r=40, c=256, n_out=32, seed=0):
    """The experiment's inputs at a small shape: u8-valued source, a bent
    linear ramp of positions, per-channel quarter-pixel offsets."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (ch, r, c)).astype(np.float32)
    base = np.linspace(1.0, r - 3.0, n_out)
    bend = np.sin(np.linspace(0, np.pi, c)) * 4.0
    pos = np.clip(base[:, None] + bend[None, :] * (base[:, None] / r - 0.5),
                  1.0, r - 3.0).astype(np.float32)
    pos4 = np.stack([pos, pos, pos + 0.25, pos + 0.25])[:ch].astype(np.float32)
    return src, pos, pos4


def test_plain_matches_the_tpu_kernel(pallas_band_warp):
    src, pos, pos4 = _case()
    r0 = pallas_band_warp.block_starts_2d(pos, WIN, src.shape[1])
    want = np.asarray(pallas_band_warp.band_warp_pallas(
        jnp.asarray(src), jnp.asarray(pos4), jnp.asarray(r0), WIN, interpret=True))
    t_r0 = BW.block_starts(torch.from_numpy(pos), WIN, src.shape[1])
    np.testing.assert_array_equal(t_r0.numpy(), r0)
    before = dict(cuda.LAUNCHES)
    got = BW.band_warp(torch.from_numpy(src), torch.from_numpy(pos4), t_r0, WIN)
    assert cuda.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == want.shape == (4, 32, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    ref = pallas_band_warp.reference(src, pos4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # B1's function: the two taps at floor(pos)
    b1 = W.band_pass(torch.from_numpy(src), torch.from_numpy(pos4))
    np.testing.assert_allclose(got.numpy(), b1.numpy(), rtol=0, atol=1e-4)


def test_precondition_is_checked():
    src, pos, pos4 = _case()
    t_src, t_pos = torch.from_numpy(src), torch.from_numpy(pos4)
    r0 = BW.block_starts(torch.from_numpy(pos), WIN, src.shape[1])
    with pytest.raises(ValueError):  # a block's positions span more than the window
        BW.block_starts(torch.from_numpy(pos), 4, src.shape[1])
    with pytest.raises(ValueError):  # positions below their window
        BW.band_warp(t_src, t_pos, r0 + 1, WIN)
    with pytest.raises(ValueError):  # a window past the source's last row
        BW.band_warp(t_src, t_pos, torch.full_like(r0, src.shape[1] - WIN + 1), WIN)
    with pytest.raises(ValueError):  # positions past their window
        BW.band_warp(t_src, t_pos + 20.0, r0, WIN)
    with pytest.raises(ValueError):  # C not a multiple of 128
        BW.band_warp(t_src[..., :200], t_pos[..., :200], r0, WIN)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("win", [16, 120])
def test_kernel_matches_plain_on_card(cuda_device, win):
    """Bit-equal; win 120 takes more than 48 KB of shared memory."""
    src, pos, pos4 = _case(r=160, c=384, n_out=128, seed=win)
    src, pos, pos4 = (torch.from_numpy(a).to(cuda_device) for a in (src, pos, pos4))
    r0 = BW.block_starts(pos, win, src.shape[1])
    n = cuda.LAUNCHES["band_warp"]
    got = BW.band_warp(src, pos4, r0, win)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["band_warp"] == n + 1
    assert torch.equal(got, BW._band_warp_plain(src, pos4, r0, win))
