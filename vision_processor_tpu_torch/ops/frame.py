"""Frame-plane ops: Bayer splitting, plane sampling, the flat-grid resamples,
dRGB.

Counterpart of vision_processor_tpu/ops/frame.py (reference
kernel/raw2quad.cl:21-39, kernel/resampling.cl:52-105). Three resamples
onto the flat field grid:

- the cached-grid gather (``resample_grid`` + ``resample_flat_grid_raw``),
  for cameras that ``ops.warp.warp_fits`` rejects. It builds the corner
  stack straight from the raw frame with ``ops.corner_stack.corner_stack``
  (kernel E4 on the card, the function of ``experiments/pallas_stack.py``
  and of the JAX package's ``corner_stack_u32``), then gathers its rows
  with ``ops.gather_corners.gather_corners`` (kernel B7 on the card);
- the in-line projection resample (``resample_flat_packed``): the per-pixel
  camera projection (``flat_image_points``, plain PyTorch as it is plain
  XLA in the JAX package), then the packed single-cell sampler
  (``sample_planes_packed`` -> ``combine_planes`` -> ``rgb_to_drgb``),
  which runs as kernel E2/E3 of ``ops.resample_packed`` on the card;
- the exact per-plane bilinear resample (``raw2quad`` + ``resample_flat``),
  plain PyTorch on every device, as it is plain XLA in the JAX package.
"""
from __future__ import annotations

import torch

from ..models.camera import field2image_packed
from .corner_stack import _stack_planes, corner_stack
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


def raw2quad(raw: torch.Tensor, fmt: str) -> torch.Tensor:
    """Raw frame -> 4 half-resolution planes (4, H, W) f32 (BGR: [B, G, R,
    zeros])."""
    return raw2planes_packed(raw, fmt).permute(2, 0, 1)


def bilinear_sample(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``plane`` (H, W) at float pixel coords, clamp-to-edge.

    Texel centers sit at integer + 0.5 (OpenCL unnormalized LINEAR
    convention): sampling at exactly (i + 0.5, j + 0.5) returns plane[j, i].
    """
    h, w = plane.shape
    u = x - 0.5
    v = y - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    x0 = x0.to(torch.int64).clamp(0, w - 1)
    y0 = y0.to(torch.int64).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    flatp = plane.reshape(-1)
    p00 = torch.take(flatp, y0 * w + x0)
    p01 = torch.take(flatp, y0 * w + x1)
    p10 = torch.take(flatp, y1 * w + x0)
    p11 = torch.take(flatp, y1 * w + x1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def sample_rgb(planes: torch.Tensor, px: torch.Tensor, py: torch.Tensor, fmt: str):
    """(r, g, b) at image positions (px, py) from the 4 planes (4, H, W),
    each channel at its quarter-pixel shift inside the Bayer cell
    (reference kernel/resampling.cl:60-84)."""
    if fmt == BGR:
        b = bilinear_sample(planes[0], px, py)
        g = bilinear_sample(planes[1], px, py)
        r = bilinear_sample(planes[2], px, py)
        return r, g, b
    if fmt == RGGB:
        r = bilinear_sample(planes[0], px + 0.25, py + 0.25)
        g = 0.5 * bilinear_sample(planes[1], px - 0.25, py + 0.25) + 0.5 * (
            bilinear_sample(planes[2], px + 0.25, py - 0.25))
        b = bilinear_sample(planes[3], px - 0.25, py - 0.25)
        return r, g, b
    if fmt == GRBG:
        r = bilinear_sample(planes[1], px - 0.25, py + 0.25)
        g = 0.5 * bilinear_sample(planes[0], px + 0.25, py + 0.25) + 0.5 * (
            bilinear_sample(planes[3], px - 0.25, py - 0.25))
        b = bilinear_sample(planes[2], px + 0.25, py - 0.25)
        return r, g, b
    raise ValueError(f"unknown raw format {fmt}")


def quad2rgba(planes: torch.Tensor, fmt: str) -> torch.Tensor:
    """Demosaic the planes (4, H, W) back to a half-resolution RGB image
    (H, W, 3) f32 on the planes' device: Bayer planes blended at the
    reference's quarter-pixel offsets over the full plane grid (reference
    kernel/quad2rgba.cl:23-53); BGR is a channel reorder."""
    if fmt == BGR:
        return torch.stack([planes[2], planes[1], planes[0]], dim=-1)
    h, w = planes.shape[1:]
    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=planes.device),
        torch.arange(w, dtype=torch.float32, device=planes.device), indexing="ij")
    return torch.stack(sample_rgb(planes, px, py, fmt), dim=-1)


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


def flat_image_points(packed_cam: torch.Tensor, max_bot_height, field_scale, field_offset,
                      out_shape: tuple[int, int]) -> torch.Tensor:
    """The camera projection of every flat-grid pixel: (Hf, Wf, 2) image
    positions (px, py) in the half-resolution plane space, on packed_cam's
    device. Flat pixel (x, y) is field point (x * field_scale + offx,
    y * field_scale + offy, max_bot_height)."""
    hf, wf = out_shape
    dev = packed_cam.device
    pts = _grid_points(packed_cam, max_bot_height, field_scale, _offset(field_offset, dev),
                       torch.arange(hf, device=dev), torch.arange(wf, device=dev))
    return field2image_packed(packed_cam, pts)


def resample_flat(planes: torch.Tensor, packed_cam: torch.Tensor, max_bot_height,
                  field_scale, field_offset, out_shape: tuple[int, int],
                  fmt: str) -> torch.Tensor:
    """The exact resample: planes (4, H, W) -> (Hf, Wf, 3) flat dRGB, each
    plane bilinearly sampled at its own quarter-pixel position."""
    img = flat_image_points(packed_cam, max_bot_height, field_scale, field_offset,
                            out_shape)
    r, g, b = sample_rgb(planes, img[..., 0], img[..., 1], fmt)
    return rgb_to_drgb(r, g, b)


def corner_stack_planes(packed: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) planes -> (H, W, 16) u8: the 2x2 bilinear corner
    neighbourhood [self, right, down, down-right], clamp-to-edge (the JAX
    package's u8 ``corner_stack`` of the packed planes; plain PyTorch; the
    raw-frame ``corner_stack`` here is kernel E4). Plane values are 8-bit
    camera data; f32 planes are cast as ``.to(torch.uint8)`` casts."""
    return _stack_planes(packed.to(torch.uint8))


def sample_planes_packed(packed: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                         fmt: str) -> torch.Tensor:
    """Bilinearly sample all 4 packed planes (H, W, 4) with one 16-lane
    gather of the corner stack: (..., 4) plane samples.

    Each plane applies its own quarter-pixel offset through per-plane
    fractions clipped to the shared 2x2 cell, a <= 0.25 px approximation at
    cell boundaries (the JAX package's ``sample_planes_packed``). This is
    the plain PyTorch form of kernel E2/E3's sampler (ops/resample_packed.py).
    """
    h, w = packed.shape[:2]
    u = px - 0.5
    v = py - 0.5
    x0 = torch.floor(u).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(v).to(torch.int32).clamp(0, h - 1)
    stacked = corner_stack_planes(packed).reshape(-1, 16)
    g = stacked[(y0 * w + x0).long()].to(torch.float32)
    g00, g01, g10, g11 = g[..., 0:4], g[..., 4:8], g[..., 8:12], g[..., 12:16]
    offs = torch.tensor(_PLANE_OFFSETS[fmt], dtype=torch.float32, device=px.device)
    fx = (u[..., None] + offs[:, 0] - x0[..., None]).clamp(0.0, 1.0)
    fy = (v[..., None] + offs[:, 1] - y0[..., None]).clamp(0.0, 1.0)
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy


def resample_flat_packed(packed: torch.Tensor, packed_cam: torch.Tensor, max_bot_height,
                         field_scale, field_offset, out_shape: tuple[int, int],
                         fmt: str) -> torch.Tensor:
    """The in-line projection resample on packed planes (H, W, 4): project
    every flat pixel, then sample -> (Hf, Wf, 3) flat dRGB (kernel E2/E3 on
    the card)."""
    from .resample_packed import resample_packed_planes

    img = flat_image_points(packed_cam, max_bot_height, field_scale, field_offset,
                            out_shape)
    return resample_packed_planes(packed, img[..., 0], img[..., 1], fmt)


def resample_grid(packed_cam, max_bot_height, field_scale, field_offset,
                  out_shape: tuple[int, int], plane_shape: tuple[int, int]):
    """Flat-grid -> packed-plane sampling geometry, once per calibration.

    Returns {"idx": (Hf, Wf) i32 flat index into the (H*W, 16) corner
    stack, "ub"/"vb": (Hf, Wf) f32 fractional offsets u - x0 / v - y0}.
    """
    h, w = plane_shape
    img = flat_image_points(packed_cam, max_bot_height, field_scale, field_offset,
                            out_shape)
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
