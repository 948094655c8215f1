"""Corner-stack gather of the cached-grid resample (kernel B7): counterpart
of vision_processor_tpu/ops/pallas_resample.py (``gather_corners_pallas``,
``band_fits``, ``tile_starts``).

``gather_corners`` takes the u8 corner stack (N, 16) and the flat row index
of every output pixel — the ``idx = y0 * w + x0`` map the gather grid
already holds — and returns the rows widened to f32, exact for 8-bit data
as the TPU kernel's one-hot bf16 product is. On the card the CUDA kernel of
``csrc/gather.cu`` runs; ``_gather_corners_plain`` is its plain PyTorch
version, used for CPU tensors and held against the kernel on the card.

The TPU kernel's banding (``tile_starts``, ``band_fits``) exists because a
TPU cannot gather from HBM; Hopper can, so the CUDA kernel takes no band.
The two functions are kept for parity with the JAX package only.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda

TILE_H = 8
TILE_W = 128
BAND_H = 16
BAND_W = 192
CH = 16  # corner-stacked lanes (4 bilinear corners x 4 planes)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_starts(y0: torch.Tensor, x0: torch.Tensor, h: int, w: int):
    """Per-tile band start offsets of the TPU kernel from (HFp, WFp) i32
    index maps padded to tile multiples: (row_start, col_start), each
    (n_tiles,) row-major, clamped so the band stays inside (h, w)."""
    hfp, wfp = y0.shape
    nty, ntx = hfp // TILE_H, wfp // TILE_W
    ty = y0.reshape(nty, TILE_H, ntx, TILE_W)
    tx = x0.reshape(nty, TILE_H, ntx, TILE_W)
    ry = ty.amin(dim=(1, 3)).reshape(-1)
    rx = tx.amin(dim=(1, 3)).reshape(-1)
    ry = ry.clamp(0, max(h - BAND_H, 0)).to(torch.int32)
    rx = rx.clamp(0, max(w - BAND_W, 0)).to(torch.int32)
    return ry, rx


def band_fits(model, field_scale, field_offset, out_shape, img_size,
              max_bot_height: float) -> bool:
    """Whether every output tile's input window fits the TPU kernel's
    (BAND_H, BAND_W) band (numpy, once per geometry)."""
    hf, wf = out_shape
    w2, h2 = int(img_size[0]), int(img_size[1])
    ys = np.arange(_pad_to(hf, TILE_H)) * field_scale + field_offset[1]
    xs = np.arange(_pad_to(wf, TILE_W)) * field_scale + field_offset[0]
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx, gy, np.full_like(gx, max_bot_height)], axis=-1)
    img = model.field2image(pts.reshape(-1, 3)).reshape(gx.shape + (2,))
    if not np.isfinite(img).all():
        return False
    x0 = np.clip(np.floor(img[..., 0] - 0.5), 0, w2 - 1)
    y0 = np.clip(np.floor(img[..., 1] - 0.5), 0, h2 - 1)
    nty, ntx = x0.shape[0] // TILE_H, x0.shape[1] // TILE_W
    xt = x0.reshape(nty, TILE_H, ntx, TILE_W)
    yt = y0.reshape(nty, TILE_H, ntx, TILE_W)
    x_range = (xt.max(axis=(1, 3)) - xt.min(axis=(1, 3))).max()
    y_range = (yt.max(axis=(1, 3)) - yt.min(axis=(1, 3))).max()
    # +1 for the bilinear corner reach
    return bool(x_range + 2 <= BAND_W and y_range + 2 <= BAND_H)


def _gather_corners_plain(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B7."""
    rows = stacked.index_select(0, idx.reshape(-1).to(torch.int64))
    return rows.to(torch.float32).reshape(*idx.shape, stacked.shape[1])


def gather_corners(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stacked (N, 16) u8, idx (Hf, Wf) i32 in [0, N) -> (Hf, Wf, 16) f32,
    ``out[i, j] = stacked[idx[i, j]]``.

    The indices are in range by construction (``ops.frame.resample_grid``
    clamps the corners into the planes); the kernel does not check them.
    """
    if not stacked.is_cuda:
        return _gather_corners_plain(stacked, idx)
    cuda.require(stacked, "stacked", torch.uint8, 2)
    idx = idx.contiguous()
    cuda.require(idx, "idx", torch.int32, 2)
    if stacked.shape[1] != CH or stacked.data_ptr() % 4 != 0:
        raise ValueError(f"gather_corners: stacked {tuple(stacked.shape)} must be "
                         f"(N, {CH}) u8, 4-byte aligned")
    out = torch.empty((*idx.shape, CH), dtype=torch.float32, device=stacked.device)
    rc = cuda.lib().vp_gather_corners(
        stacked.data_ptr(), idx.data_ptr(), idx.numel(), out.data_ptr(),
        cuda.stream(stacked),
    )
    cuda.check(rc, "gather_corners")
    cuda.LAUNCHES["gather_corners"] += 1
    return out
