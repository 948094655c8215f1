"""Corner stack of the gather resample (kernel E4): counterpart of
experiments/pallas_stack.py (``corner_stack_pallas``) and of the JAX
package's ``ops/frame.py`` ``corner_stack`` / ``corner_stack_u32``.

For each cell (y, x) of the (H, W) half-resolution plane grid, 16 u8 lanes:
the cell's 4 planes, then those of its right, down and down-right
neighbours, replicated at the last row and column. ``corner_stack`` takes
the raw frame, Bayer (2H, 2W) u8 or BGR (H, W, 3) u8 with a zero 4th
plane, as ``corner_stack_u32`` does, and returns (H, W, 16) u8;
``corner_stack_packed`` takes the packed planes (H, 4W) u8 and returns
(H, 16W) u8, the experiment's own contract. On the card both launch the
CUDA kernel of ``csrc/corner_stack.cu``; ``_corner_stack_plain`` and
``_corner_stack_packed_plain`` are their plain PyTorch versions, used for
CPU tensors and held against the kernel on the card.
"""
from __future__ import annotations

import torch

from . import cuda

_BAYER, _PACKED, _BGR = 0, 1, 2  # the kernel's source modes
_MAX_ROWS = 65535  # the launch grid's y extent


def _stack_planes(p: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) planes -> (H, W, 16): [cell, right, down, down-right]."""
    right = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
    down = torch.cat([p[1:], p[-1:]], dim=0)
    down_right = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    return torch.cat([p, right, down, down_right], dim=-1)


def _corner_stack_plain(raw: torch.Tensor, fmt: str) -> torch.Tensor:
    """Plain PyTorch version of kernel E4 on the raw frame."""
    from .frame import raw2planes_packed  # frame imports this module

    return _stack_planes(raw2planes_packed(raw, fmt, dtype=torch.uint8))


def _corner_stack_packed_plain(packed2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E4 on packed planes (H, 4W)."""
    h = packed2d.shape[0]
    return _stack_planes(packed2d.reshape(h, -1, 4)).reshape(h, -1)


def _launch(src: torch.Tensor, mode: int, h: int, w: int) -> torch.Tensor:
    if not (0 < h <= _MAX_ROWS and w > 0):
        raise ValueError(f"corner_stack: plane grid ({h}, {w}) out of range")
    out = torch.empty((h, w, 16), dtype=torch.uint8, device=src.device)
    rc = cuda.lib().vp_corner_stack(src.data_ptr(), mode, h, w, out.data_ptr(),
                                    cuda.stream(src))
    cuda.check(rc, "corner_stack")
    cuda.LAUNCHES["corner_stack"] += 1
    return out


def corner_stack(raw: torch.Tensor, fmt: str) -> torch.Tensor:
    """Raw frame -> (H, W, 16) u8 corner stack: Bayer (2H, 2W) u8 (RGGB,
    GRBG) or BGR (H, W, 3) u8."""
    if not raw.is_cuda:
        return _corner_stack_plain(raw, fmt)
    if fmt == "BGR":
        cuda.require(raw, "raw", torch.uint8, 3)
        if raw.shape[2] != 3:
            raise ValueError(f"corner_stack: BGR frame {tuple(raw.shape)} must be (H, W, 3)")
        return _launch(raw, _BGR, raw.shape[0], raw.shape[1])
    cuda.require(raw, "raw", torch.uint8, 2)
    if raw.shape[0] % 2 or raw.shape[1] % 2 or raw.data_ptr() % 2:
        raise ValueError(f"corner_stack: Bayer frame {tuple(raw.shape)} must have even "
                         f"sides and be 2-byte aligned")
    return _launch(raw, _BAYER, raw.shape[0] // 2, raw.shape[1] // 2)


def corner_stack_packed(packed2d: torch.Tensor) -> torch.Tensor:
    """Packed planes (H, 4W) u8 -> (H, 16W) u8 corner stack, the contract
    of ``corner_stack_pallas``."""
    if not packed2d.is_cuda:
        return _corner_stack_packed_plain(packed2d)
    cuda.require(packed2d, "packed2d", torch.uint8, 2)
    if packed2d.shape[1] % 4 or packed2d.data_ptr() % 4:
        raise ValueError(f"corner_stack_packed: {tuple(packed2d.shape)} must be (H, 4W) "
                         f"and 4-byte aligned")
    h, w = packed2d.shape[0], packed2d.shape[1] // 4
    return _launch(packed2d, _PACKED, h, w).reshape(h, 16 * w)
