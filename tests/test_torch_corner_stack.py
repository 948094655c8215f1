"""Kernel E4, the corner stack of the gather resample: the port's plain
version against the TPU kernel (``experiments/pallas_stack.py``
``corner_stack_pallas`` in interpret mode) and against the JAX package's
``corner_stack`` / ``corner_stack_u32``, bit for bit; and, on the card,
the CUDA kernel against the plain version.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_processor_tpu.ops import frame as JF
from vision_processor_tpu_torch.ops import corner_stack as CS
from vision_processor_tpu_torch.ops import cuda
from vision_processor_tpu_torch.ops import frame as F

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pallas_stack():
    """experiments/pallas_stack.py, imported by path, in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "experiments_pallas_stack", ROOT / "experiments" / "pallas_stack.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def _raw(fmt: str, h: int, w: int, seed: int) -> np.ndarray:
    """A random raw frame whose plane grid is (h, w)."""
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if fmt == "BGR" else (2 * h, 2 * w)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("h,w", [(540, 960), (70, 40)])
def test_plain_matches_the_tpu_kernel(pallas_stack, h, w):
    """(540, 960) is the kernel's own shape; at (70, 40) the last of its
    64-row blocks is partial, so its down-shift replicates the final real
    row."""
    pallas_stack.H, pallas_stack.W = h, w  # the kernel reads W from the module
    raw = _raw("RGGB", h, w, seed=h)
    packed2d = np.asarray(JF.raw2planes_packed(jnp.asarray(raw), "RGGB")
                          ).astype(np.uint8).reshape(h, 4 * w)
    want = np.asarray(pallas_stack.corner_stack_pallas(jnp.asarray(packed2d)))
    got = CS.corner_stack_packed(torch.from_numpy(packed2d))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, 16 * w)
    np.testing.assert_array_equal(got.numpy(), want)
    # the raw-frame entry builds the same stack
    np.testing.assert_array_equal(F.corner_stack(torch.from_numpy(raw), "RGGB").numpy(),
                                  want.reshape(h, w, 16))


@pytest.mark.parametrize("fmt", ["RGGB", "GRBG", "BGR"])
def test_corner_stack_matches_jax(fmt):
    h, w = 37, 53  # odd sides: both clamped edges are off any tile
    raw = _raw(fmt, h, w, seed=len(fmt))
    before = dict(cuda.LAUNCHES)
    got = F.corner_stack(torch.from_numpy(raw), fmt).numpy()
    assert cuda.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (h, w, 16) and got.dtype == np.uint8
    jraw = jnp.asarray(raw)
    np.testing.assert_array_equal(got, np.asarray(JF.corner_stack(JF.raw2planes_packed(jraw,
                                                                                       fmt))))
    np.testing.assert_array_equal(got, np.asarray(JF.corner_stack_u32(jraw, fmt)))
    if fmt == "BGR":
        assert not got[..., 3::4].any()  # the zero 4th plane in every lane group


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,h,w", [("RGGB", 540, 960), ("GRBG", 70, 40),
                                     ("BGR", 540, 960), ("BGR", 37, 53)])
def test_kernel_matches_plain_on_card(cuda_device, fmt, h, w):
    raw = torch.from_numpy(_raw(fmt, h, w, seed=w)).to(cuda_device)
    n = cuda.LAUNCHES["corner_stack"]
    got = CS.corner_stack(raw, fmt)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["corner_stack"] == n + 1
    assert torch.equal(got, CS._corner_stack_plain(raw, fmt))
    if fmt != "BGR":
        packed2d = CS._corner_stack_plain(raw, fmt)[..., :4].reshape(h, 4 * w).contiguous()
        assert torch.equal(CS.corner_stack_packed(packed2d),
                           CS._corner_stack_packed_plain(packed2d))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    raw = torch.zeros((10, 12), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        CS.corner_stack(raw.float(), "RGGB")
    with pytest.raises(ValueError):
        CS.corner_stack(raw[:, :11], "RGGB")  # odd width, not contiguous
    with pytest.raises(ValueError):
        CS.corner_stack_packed(raw[:, :10].contiguous()[:, 1:].contiguous())  # 9 columns
