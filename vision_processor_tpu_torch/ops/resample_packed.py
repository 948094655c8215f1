"""The in-line projection resample's sampler (kernel E2/E3): counterpart of
experiments/k2_proto.py and experiments/k2_stages.py (``resample_k2``), and
of the JAX package's ``sample_planes_packed`` -> ``combine_planes`` ->
``rgb_to_drgb`` chain (ops/frame.py), which those two TPU kernels compute.

Given the projected image position (px, py) of every flat pixel, (Hf, Wf)
f32 each, it returns the (Hf, Wf, 3) f32 flat dRGB grid: the 2x2 cell of
the four half-resolution planes at floor(p - 0.5), clamped to the plane
grid, per-plane fractions clipped to that cell, bilinear per plane, the
Bayer green combine, dRGB.

- ``resample_packed(raw, px, py, fmt)`` takes the raw frame, Bayer (2H, 2W)
  u8 (RGGB, GRBG) or BGR (H, W, 3) u8: the blob machine's in-line path;
- ``resample_packed_planes(packed, px, py, fmt)`` takes packed planes
  (H, W, 4) u8 or f32 of any H and W, E2/E3's own contract (the
  experiments hard-code (540, 960) and RGGB).

On the card both launch the CUDA kernel of ``csrc/resample_packed.cu``;
px and py may be the two channels of the projection's (Hf, Wf, 2) output
(any common element stride). ``_resample_packed_plain`` is the plain
PyTorch version, used for CPU tensors and held against the kernel on the
card, which is bit-equal to it.
"""
from __future__ import annotations

import torch

from . import cuda

_BAYER, _BGR, _PACKED_U8, _PACKED_F32 = 0, 1, 2, 3  # the kernel's source modes
_FMT = {"RGGB": 0, "GRBG": 1, "BGR": 2}


def _resample_packed_plain(packed: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                           fmt: str) -> torch.Tensor:
    """Plain PyTorch version of kernel E2/E3 on packed planes (H, W, 4)."""
    from .frame import combine_planes, rgb_to_drgb, sample_planes_packed

    return rgb_to_drgb(*combine_planes(sample_planes_packed(packed, px, py, fmt), fmt))


def _resample_raw_plain(raw: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                        fmt: str) -> torch.Tensor:
    """Plain PyTorch version of kernel E2/E3 on the raw frame."""
    from .frame import raw2planes_packed

    return _resample_packed_plain(raw2planes_packed(raw, fmt), px, py, fmt)


def _position_stride(px: torch.Tensor, py: torch.Tensor) -> int:
    """The common element stride s of px and py, (Hf, Wf) f32 on the card
    with strides (Wf * s, s)."""
    for name, t in (("px", px), ("py", py)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"resample_packed: {name} must be a 2-D float32 CUDA tensor, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    s = px.stride(1)
    if (px.shape != py.shape or px.stride() != py.stride() or s < 1
            or px.stride(0) != px.shape[1] * s or px.device != py.device):
        raise ValueError(f"resample_packed: px {tuple(px.shape)} {px.stride()} and py "
                         f"{tuple(py.shape)} {py.stride()} must share one dense layout")
    return s


def _launch(src: torch.Tensor, mode: int, fmt: str, h: int, w: int,
            px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    s = _position_stride(px, py)
    if src.device != px.device:
        raise ValueError(f"resample_packed: source on {src.device}, positions on {px.device}")
    if fmt not in _FMT:
        raise ValueError(f"unknown raw format {fmt}")
    hf, wf = px.shape
    out = torch.empty((hf, wf, 3), dtype=torch.float32, device=src.device)
    rc = cuda.lib().vp_resample_packed(src.data_ptr(), mode, _FMT[fmt], h, w,
                                       px.data_ptr(), py.data_ptr(), s, hf * wf,
                                       out.data_ptr(), cuda.stream(src))
    cuda.check(rc, "resample_packed")
    cuda.LAUNCHES["resample_packed"] += 1
    return out


def resample_packed(raw: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    fmt: str) -> torch.Tensor:
    """Raw frame + projected positions -> (Hf, Wf, 3) flat dRGB: Bayer
    (2H, 2W) u8 (RGGB, GRBG) or BGR (H, W, 3) u8."""
    if not raw.is_cuda:
        return _resample_raw_plain(raw, px, py, fmt)
    if fmt == "BGR":
        cuda.require(raw, "raw", torch.uint8, 3)
        if raw.shape[2] != 3:
            raise ValueError(f"resample_packed: BGR frame {tuple(raw.shape)} must be "
                             f"(H, W, 3)")
        return _launch(raw, _BGR, fmt, raw.shape[0], raw.shape[1], px, py)
    cuda.require(raw, "raw", torch.uint8, 2)
    if raw.shape[0] % 2 or raw.shape[1] % 2 or raw.data_ptr() % 2:
        raise ValueError(f"resample_packed: Bayer frame {tuple(raw.shape)} must have even "
                         f"sides and be 2-byte aligned")
    return _launch(raw, _BAYER, fmt, raw.shape[0] // 2, raw.shape[1] // 2, px, py)


def resample_packed_planes(packed: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                           fmt: str) -> torch.Tensor:
    """Packed planes (H, W, 4) u8 or f32 (8-bit values) + projected
    positions -> (Hf, Wf, 3) flat dRGB, E2/E3's contract at any H, W and
    format."""
    if not packed.is_cuda:
        return _resample_packed_plain(packed, px, py, fmt)
    if packed.dtype == torch.uint8:
        mode, align = _PACKED_U8, 4
    elif packed.dtype == torch.float32:
        mode, align = _PACKED_F32, 16
    else:
        raise ValueError(f"resample_packed_planes: packed must be u8 or f32, got "
                         f"{packed.dtype}")
    cuda.require(packed, "packed", packed.dtype, 3)
    if packed.shape[2] != 4 or packed.data_ptr() % align:
        raise ValueError(f"resample_packed_planes: packed {tuple(packed.shape)} must be "
                         f"(H, W, 4) and {align}-byte aligned")
    return _launch(packed, mode, fmt, packed.shape[0], packed.shape[1], px, py)
