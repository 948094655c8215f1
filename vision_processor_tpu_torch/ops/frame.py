"""Frame-plane ops: Bayer splitting, the cached-grid gather resample, dRGB.

Counterpart of vision_processor_tpu/ops/frame.py (reference
kernel/raw2quad.cl:21-39, kernel/resampling.cl:52-105). The gather path
(``resample_grid`` + ``resample_flat_grid_raw``) is the resample for
cameras that ``ops.warp.warp_fits`` rejects. It builds the corner stack
straight from the raw frame with ``ops.corner_stack.corner_stack`` (kernel
E4 on the card, the function of ``experiments/pallas_stack.py`` and of the
JAX package's ``corner_stack_u32``), then gathers its rows with
``ops.gather_corners.gather_corners`` (kernel B7 on the card, the function
of the JAX package's ``gather_corners_pallas``).
"""
from __future__ import annotations

import torch

from ..models.camera import field2image_packed
from .corner_stack import corner_stack
from .gather_corners import gather_corners

# Supported raw formats
RGGB = "RGGB"
GRBG = "GRBG"
BGR = "BGR"

_PLANE_OFFSETS = {
    # per-channel quarter-pixel sample offsets within the Bayer cell
    # (reference kernel/resampling.cl:60-84); BGR needs none.
    RGGB: ((0.25, 0.25), (-0.25, 0.25), (0.25, -0.25), (-0.25, -0.25)),
    GRBG: ((0.25, 0.25), (-0.25, 0.25), (0.25, -0.25), (-0.25, -0.25)),
    BGR: ((0.0, 0.0),) * 4,
}


def raw2planes_packed(raw: torch.Tensor, fmt: str,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Raw frame -> channel-packed half-resolution planes (H, W, 4).

    Bayer (2H, 2W) u8: the 2x2 cell unrolled row-major into the last axis.
    BGR (H, W, 3): zero-padded to 4 channels.
    """
    if fmt == BGR:
        x = raw.to(dtype)
        return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
    h2, w2 = raw.shape[0] // 2, raw.shape[1] // 2
    x = raw.to(dtype).reshape(h2, 2, w2, 2)
    return x.permute(0, 2, 1, 3).reshape(h2, w2, 4)


def rgb_to_drgb(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differential RGB color space, channels stacked last
    (reference kernel/resampling.cl:88-94)."""
    dr = (2 * r - g - b + 510) * 0.25
    dg = (2 * g - b - r + 510) * 0.25
    db = (2 * b - r - g + 510) * 0.25
    return torch.stack([dr, dg, db], dim=-1)


def combine_planes(samples: torch.Tensor, fmt: str):
    """Per-plane samples (..., 4) -> (r, g, b) per the raw format."""
    if fmt == BGR:
        return samples[..., 2], samples[..., 1], samples[..., 0]
    if fmt == RGGB:
        r = samples[..., 0]
        g = 0.5 * samples[..., 1] + 0.5 * samples[..., 2]
        b = samples[..., 3]
        return r, g, b
    if fmt == GRBG:
        r = samples[..., 1]
        g = 0.5 * samples[..., 0] + 0.5 * samples[..., 3]
        b = samples[..., 2]
        return r, g, b
    raise ValueError(f"unknown raw format {fmt}")


def _grid_points(packed_cam, max_bot_height, field_scale, field_offset,
                 ys_idx: torch.Tensor, xs_idx: torch.Tensor) -> torch.Tensor:
    """Field points (len(ys), len(xs), 3) of flat-grid indices at the
    bot-height plane (torch.meshgrid 'xy' layout of the JAX code)."""
    ys = ys_idx.to(torch.float32) * field_scale + field_offset[1]
    xs = xs_idx.to(torch.float32) * field_scale + field_offset[0]
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    z = torch.ones_like(gx) * max_bot_height
    return torch.stack([gx, gy, z], dim=-1)


def _offset(field_offset, device) -> torch.Tensor:
    return torch.as_tensor(field_offset, dtype=torch.float32, device=device)


def resample_grid(packed_cam, max_bot_height, field_scale, field_offset,
                  out_shape: tuple[int, int], plane_shape: tuple[int, int]):
    """Flat-grid -> packed-plane sampling geometry, once per calibration.

    Returns {"idx": (Hf, Wf) i32 flat index into the (H*W, 16) corner
    stack, "ub"/"vb": (Hf, Wf) f32 fractional offsets u - x0 / v - y0}.
    """
    hf, wf = out_shape
    h, w = plane_shape
    dev = packed_cam.device
    off = _offset(field_offset, dev)
    pts = _grid_points(packed_cam, max_bot_height, field_scale, off,
                       torch.arange(hf, device=dev), torch.arange(wf, device=dev))
    img = field2image_packed(packed_cam, pts)
    u = img[..., 0] - 0.5
    v = img[..., 1] - 0.5
    x0 = torch.floor(u).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(v).to(torch.int32).clamp(0, h - 1)
    return {
        "idx": y0 * w + x0,
        "ub": u - x0.to(torch.float32),
        "vb": v - y0.to(torch.float32),
    }


def resample_flat_grid_raw(raw: torch.Tensor, grid: dict, fmt: str) -> torch.Tensor:
    """raw frame -> (Hf, Wf, 3) flat dRGB grid by the cached-grid gather
    (bit-identical semantics to the JAX package's resample_flat_grid_raw)."""
    stacked = corner_stack(raw, fmt).reshape(-1, 16)
    g = gather_corners(stacked, grid["idx"])
    g00, g01, g10, g11 = g[..., 0:4], g[..., 4:8], g[..., 8:12], g[..., 12:16]
    offs = torch.tensor(_PLANE_OFFSETS[fmt], dtype=torch.float32).to(raw.device)
    fx = (grid["ub"][..., None] + offs[:, 0]).clamp(0.0, 1.0)
    fy = (grid["vb"][..., None] + offs[:, 1]).clamp(0.0, 1.0)
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    samples = top * (1 - fy) + bot * fy
    r, gg, b = combine_planes(samples, fmt)
    return rgb_to_drgb(r, gg, b)
