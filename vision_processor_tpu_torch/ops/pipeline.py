"""The blob machine: raw frame to compacted blobs (PyTorch port).

Counterpart of vision_processor_tpu/ops/pipeline.py: Bayer split ->
resample to the flat dRGB field grid -> extraction -> field mm positions.
The resample follows the JAX package's branch order: the exact per-plane
resample (``exact_resample``, plain PyTorch), the two-pass warp of a cached
warp grid (kernel B1), the gather of a cached gather grid (kernels E4 and
B7), else in line: the per-pixel camera projection, then the packed
sampler (kernel E2/E3, ops/resample_packed.py). The
extraction is score-first by default: the per-pixel blob response (fused
kernel B2 on the card, the eager chain on the CPU, as the JAX package uses
Pallas on the TPU only), then exact masked compaction by score (row stage
kernel B3). With ``VPTPU_SCOREFIRST=0``, read at call time as the JAX
package reads it at trace time, it is circularity-first: the circularity
alone (kernel B5 on the card when ``sat_radius >= 2``, else the eager
chain), compaction by circularity (B3), disc statistics at the candidates.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from . import blob as B
from . import frame as F
from .resample_packed import resample_packed


@dataclass(frozen=True)
class BlobMachineConfig:
    """Static configuration of the per-frame graph."""

    fmt: str  # RGGB / GRBG / BGR
    raw_shape: tuple[int, ...]  # (2H, 2W) bayer or (H, W, 3) bgr
    flat_shape: tuple[int, int]  # (Hf, Wf) flat field grid
    field_scale: float  # [mm/px]
    field_offset: tuple[float, float]  # flat grid origin in field mm
    grad_offset: int
    sat_radius: int
    disc_radius: int
    max_blobs: int = 2000
    # exact per-plane quarter-pixel bilinear (16 gathers) vs the packed
    # single-cell sampler (<= 0.25 px boundary approximation)
    exact_resample: bool = False
    # "gather": cached-grid gather; "warp": two-pass separable warp
    # (requires ops.warp.warp_fits on the geometry)
    resample_mode: str = "gather"

    @property
    def plane_shape(self) -> tuple[int, int]:
        """Shape of the channel-packed half-resolution planes."""
        if self.fmt == F.BGR:
            return (self.raw_shape[0], self.raw_shape[1])
        return (self.raw_shape[0] // 2, self.raw_shape[1] // 2)

    def make_resample_grid(self, packed_cam: torch.Tensor, max_bot_height,
                           field_scale=None, field_offset=None) -> dict:
        """Frame-invariant sampling geometry (tensors on packed_cam's
        device), recomputed once per calibration / bot-height change.
        ``field_scale`` / ``field_offset`` default to the config's; a
        camera batch passes each camera's own."""
        if field_scale is None:
            field_scale = self.field_scale
        if field_offset is None:
            field_offset = self.field_offset
        if self.resample_mode == "warp":
            from . import warp as W

            return W.warp_grid(packed_cam, max_bot_height, field_scale, field_offset,
                               self.flat_shape, self.plane_shape, self.fmt)
        return F.resample_grid(packed_cam, max_bot_height, field_scale, field_offset,
                               self.flat_shape, self.plane_shape)

    @classmethod
    def from_perspective(cls, perspective, fmt: str, raw_shape: tuple[int, ...],
                         max_blobs: int = 2000,
                         resample_mode: str = "gather") -> "BlobMachineConfig":
        hf = int(perspective.reprojected_field_size[1])
        wf = int(perspective.reprojected_field_size[0])
        return cls(
            fmt=fmt,
            raw_shape=tuple(raw_shape),
            flat_shape=(hf, wf),
            field_scale=float(perspective.field_scale),
            field_offset=(
                float(perspective.visible_field_extent[0]),
                float(perspective.visible_field_extent[2]),
            ),
            grad_offset=B.gradient_offset(
                perspective.max_blob_radius, perspective.field_scale
            ),
            sat_radius=B.sat_radius(
                perspective.min_blob_radius, perspective.field_scale
            ),
            disc_radius=B.disc_radius(
                perspective.min_blob_radius, perspective.field_scale
            ),
            max_blobs=max_blobs,
            resample_mode=resample_mode,
        )


def blob_response_map(cfg: BlobMachineConfig, flat: torch.Tensor,
                      circ_threshold):
    """(masked score, circ, mean, count): the fused kernel on a CUDA tensor
    when the radii fit it, else the eager chain."""
    from .blob_fused import blob_response_fused, response_kernel_fits

    if flat.is_cuda and response_kernel_fits(cfg.grad_offset, cfg.sat_radius,
                                             cfg.disc_radius):
        return blob_response_fused(flat, circ_threshold, cfg.grad_offset,
                                   cfg.sat_radius, cfg.disc_radius)
    circ = B.circularity(
        B.summed_area_table(B.gradient_dot(flat, cfg.grad_offset)), cfg.sat_radius
    )
    ms, mean, count = B.blob_response(flat, circ, circ_threshold, cfg.disc_radius)
    return ms, circ, mean, count


def score_first() -> bool:
    """The extraction order: score-first unless VPTPU_SCOREFIRST=0."""
    return os.environ.get("VPTPU_SCOREFIRST", "1") != "0"


def extraction_kernel_shape(grad_offset: int, sat_radius: int, disc_radius: int):
    """The radii the blob machine's extraction launches its kernel at on the
    card, in the current extraction order: B2's (o, r, dr) score-first, B5's
    (o, r, None) circularity-first; None where it runs the eager chain."""
    from .blob_fused import response_kernel_fits

    if score_first():
        if response_kernel_fits(grad_offset, sat_radius, disc_radius):
            return (grad_offset, sat_radius, disc_radius)
        return None
    return (grad_offset, sat_radius, None) if sat_radius >= 2 else None


def circularity_map(cfg: BlobMachineConfig, flat: torch.Tensor) -> torch.Tensor:
    """The circularity alone: the fused kernel on a CUDA tensor when
    ``sat_radius >= 2``, else the eager chain (SAT + quadrant reads)."""
    if flat.is_cuda and cfg.sat_radius >= 2:
        from .blob_fused import circularity_fused

        return circularity_fused(flat, cfg.grad_offset, cfg.sat_radius)
    return B.circularity(
        B.summed_area_table(B.gradient_dot(flat, cfg.grad_offset)), cfg.sat_radius
    )


def resample_frame(cfg: BlobMachineConfig, raw: torch.Tensor, packed_cam, max_bot_height,
                   field_scale, field_offset, rs_grid=None) -> torch.Tensor:
    """The raw frame on the flat grid (Hf, Wf, 3) dRGB, in the JAX package's
    branch order: exact, warp grid ("pos1"), gather grid, in line."""
    if cfg.exact_resample:
        return F.resample_flat(F.raw2quad(raw, cfg.fmt), packed_cam, max_bot_height,
                               field_scale, field_offset, cfg.flat_shape, cfg.fmt)
    if rs_grid is not None and "pos1" in rs_grid:
        from . import warp as W

        return W.resample_flat_warp(raw, rs_grid, cfg.fmt, cfg.flat_shape,
                                    cfg.plane_shape)
    if rs_grid is not None:
        return F.resample_flat_grid_raw(raw, rs_grid, cfg.fmt)
    img = F.flat_image_points(packed_cam, max_bot_height, field_scale, field_offset,
                              cfg.flat_shape)
    return resample_packed(raw, img[..., 0], img[..., 1], cfg.fmt)


def blob_machine(cfg: BlobMachineConfig, raw: torch.Tensor, packed_cam, max_bot_height,
                 circ_threshold, field_scale=None, field_offset=None,
                 rs_grid: dict | None = None) -> dict:
    """Full frame -> blobs. Returns the blob slot dict; positions in field
    mm are added as ``field_pos``. ``rs_grid`` is the optional precomputed
    sampling geometry (``cfg.make_resample_grid``): a warp grid ("pos1"
    key) or a gather grid; without it the frame is resampled in line from
    ``packed_cam`` and ``max_bot_height``. ``field_scale`` /
    ``field_offset`` default to the config's values; a camera batch passes
    each camera's own."""
    if field_scale is None:
        field_scale = cfg.field_scale
    if field_offset is None:
        field_offset = cfg.field_offset
    flat = resample_frame(cfg, raw, packed_cam, max_bot_height, field_scale, field_offset,
                          rs_grid)

    if score_first():
        ms, circ, mean, count = blob_response_map(cfg, flat, circ_threshold)
        blobs = B.extract_blobs_scored(flat, circ, ms, mean, count,
                                       max_blobs=cfg.max_blobs)
    else:
        blobs = B.extract_blobs(flat, circularity_map(cfg, flat), circ_threshold,
                                0.0, radius=cfg.disc_radius, max_blobs=cfg.max_blobs)
    offset = torch.as_tensor(field_offset, dtype=torch.float32, device=flat.device)
    blobs["field_pos"] = blobs["pos"] * field_scale + offset
    return blobs


class BlobMachine:
    """The blob machine for a fixed geometry/config on one device, resampled
    in line (or exactly, with ``cfg.exact_resample``) from the camera
    parameters of each call."""

    def __init__(self, cfg: BlobMachineConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def __call__(self, raw, packed_cam, max_bot_height, circ_threshold) -> dict:
        if tuple(raw.shape) != tuple(self.cfg.raw_shape):
            raise ValueError(f"raw shape {tuple(raw.shape)} != configured "
                             f"{self.cfg.raw_shape}")
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)  # noqa: E731
        return blob_machine(self.cfg, torch.as_tensor(raw, device=self.device),
                            f32(packed_cam), f32(max_bot_height), f32(circ_threshold))
