"""Colorspace conversions for the debug video stream (PyTorch port).

Counterpart of vision_processor_tpu/ops/nv12.py (reference
kernel/quad2nv12.cl:23-58, kernel/rgba2nv12.cl:20-31, kernel/f2nv12.cl:20-26):
RGB -> BT.601-style YUV with the same integer coefficient ratios, emitted as
an NV12 buffer (luma plane + interleaved half-res chroma). Plain PyTorch on
the input's device, in the JAX version's float32 arithmetic and order,
clipped to [0, 255] and then truncated to u8, so the bytes come out equal.
"""
from __future__ import annotations

import numpy as np
import torch

from .frame import quad2rgba


def _sat_u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def rgb_to_nv12(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float RGB -> NV12 buffer (H * 3 // 2, W) uint8.

    H and W must be even. Chroma is subsampled by taking the top-left pixel
    of each 2x2 block, like the reference kernels' pos/2 indexing.
    """
    h, w, _ = rgb.shape
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = _sat_u8((66 * r + 129 * g + 25 * b) / 256 + 16)

    r2, g2, b2 = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    u = _sat_u8((-38 * r2 - 74 * g2 + 112 * b2) / 256 + 128)
    v = _sat_u8((112 * r2 - 94 * g2 - 18 * b2) / 256 + 128)
    uv = torch.stack([u, v], dim=-1).reshape(h // 2, w)
    return torch.cat([y, uv], dim=0)


def quad_to_nv12(planes: torch.Tensor, fmt: str) -> torch.Tensor:
    """Demosaiced planes -> NV12 (debug raw-feed view)."""
    return rgb_to_nv12(quad2rgba(planes, fmt))


def f32_to_nv12(img: torch.Tensor, offset: float = 127.0) -> torch.Tensor:
    """(H, W) float map -> grayscale NV12 (value + offset as luma)."""
    h, w = img.shape
    y = _sat_u8(img + offset)
    uv = torch.full((h // 2, w), 127, dtype=torch.uint8, device=img.device)
    return torch.cat([y, uv], dim=0)


def nv12_to_rgb(nv12, width: int, height: int) -> np.ndarray:
    """Inverse transform for tests (numpy; a tensor is brought to the host)."""
    if isinstance(nv12, torch.Tensor):
        nv12 = nv12.cpu().numpy()
    nv12 = np.asarray(nv12)
    y = nv12[:height].astype(np.float32) - 16.0
    uv = nv12[height:].reshape(height // 2, width // 2, 2).astype(np.float32)
    u = (uv[..., 0] - 128.0).repeat(2, axis=0).repeat(2, axis=1)
    v = (uv[..., 1] - 128.0).repeat(2, axis=0).repeat(2, axis=1)
    y = y * 1.164  # BT.601 inverse luma scale
    r = y + 1.596 * v
    g = y - 0.392 * u - 0.813 * v
    b = y + 2.017 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255)
