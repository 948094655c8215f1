"""Two-pass separable reprojection warp: the gather-free resample.

Counterpart of vision_processor_tpu/ops/warp.py. Pass 1 resamples the
image u axis, pass 2 the v axis; each pass is a 2-tap linear
interpolation along one axis (``band_pass``), which runs as the CUDA
kernel ``csrc/warp.cu`` on the card (kernel B1, replacing the Pallas
``_band_kernel``). The frame-invariant positions come from ``warp_grid``
once per calibration; ``warp_fits`` checks per geometry that the map is
separable and that the TPU kernel's 16-row window would hold every
stencil, so the port and the JAX package accept the same cameras.

``cells_chfirst_t``'s u32 byte packing exists in the JAX package only for
TPU relayouts; a plain permute replaces it here.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda
from ..models.camera import field2image_packed
from .frame import _PLANE_OFFSETS, _grid_points, _offset, combine_planes
from .frame import raw2planes_packed, rgb_to_drgb

BLK = 8     # output rows per TPU kernel block (grid padding kept for parity)
LAN = 128   # lane tile
WIN = 16    # source rows per TPU window (fit-checked by warp_fits)


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# the banded pass (kernel B1)
# ---------------------------------------------------------------------------


def _band_pass_plain(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the B1 kernel: the two taps at floor(p)."""
    r = src.shape[1]
    i0 = torch.floor(pos).clamp(0, r - 2).to(torch.int64)
    f = pos - i0.to(pos.dtype)
    a = torch.gather(src, 1, i0)
    b = torch.gather(src, 1, i0 + 1)
    return (1.0 - f) * a + f * b


def band_pass(src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """1-D linear resample along axis 1 of ``src`` (ch, R, C) at positions
    ``pos`` (ch, n_out, C) -> (ch, n_out, C) f32.

    The TPU kernel's window starts (the grid's ``r01``/``r02``) are not
    needed: the CUDA kernel reads both taps at floor(p) directly, and
    ``warp_fits`` guarantees the positions stay inside the source.
    """
    if not src.is_cuda:
        return _band_pass_plain(src, pos)
    cuda.require(src, "src", torch.float32, 3)
    cuda.require(pos, "pos", torch.float32, 3)
    ch, r, c = src.shape
    if pos.shape[0] != ch or pos.shape[2] != c or r < 2:
        raise ValueError(f"band_pass: src {tuple(src.shape)} vs pos {tuple(pos.shape)}")
    n_out = pos.shape[1]
    out = torch.empty((ch, n_out, c), dtype=torch.float32, device=src.device)
    rc = cuda.lib().vp_band_pass(
        src.data_ptr(), pos.data_ptr(), out.data_ptr(), ch, r, c, n_out,
        cuda.stream(src),
    )
    cuda.check(rc, "band_pass")
    cuda.LAUNCHES["band_pass"] += 1
    return out


# ---------------------------------------------------------------------------
# grid precompute (once per calibration)
# ---------------------------------------------------------------------------


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Row-wise ``numpy.interp`` (constant end values) on (N, M) xp/fp and
    (N, K) x, built on searchsorted as jnp.interp computes it."""
    m = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = i.clamp(1, m - 1)
    xl = torch.gather(xp, -1, i - 1)
    xr = torch.gather(xp, -1, i)
    fl = torch.gather(fp, -1, i - 1)
    fr = torch.gather(fp, -1, i)
    df = fr - fl
    dx = xr - xl
    delta = x - xl
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fl, fl + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    f = torch.where(x > xp[..., -1:], fp[..., -1:], f)
    return f


def _block_starts(pos: torch.Tensor, win: int, n_src: int) -> torch.Tensor:
    """(n_blocks, n_tiles) i32 TPU window starts (kept in the grid dict for
    warp_fits and parity with the JAX grid)."""
    ch, n_out, c = pos.shape
    p = pos.reshape(ch, n_out // BLK, BLK, c // LAN, LAN)
    lo = torch.floor(p.amin(dim=(0, 2, 4)))
    return lo.clamp(0, n_src - win).to(torch.int32)


def warp_grid(packed_cam, max_bot_height, field_scale, field_offset,
              out_shape: tuple[int, int], plane_shape: tuple[int, int], fmt: str):
    """Separable warp geometry for ``resample_flat_warp``.

    Returns {"pos1": (4, WFp8, Hp), "r01", "pos2": (4, HFp8, WFp128),
    "r02"} as the JAX warp_grid does: pass-1 positions U1(xo, vs) from
    per-column monotone inversion of the projection, pass-2 positions
    V2(yo, xo), the per-plane quarter-pixel offsets folded in.
    """
    hf, wf = out_shape
    h, w = plane_shape
    hp = _pad_to(h, LAN)
    wfp = _pad_to(wf, LAN)
    no1 = _pad_to(wf, BLK)
    no2 = _pad_to(hf, BLK)
    dev = packed_cam.device

    off = _offset(field_offset, dev)
    ys = torch.clamp(torch.arange(no2, device=dev), max=hf - 1)
    xs = torch.clamp(torch.arange(no1, device=dev), max=wf - 1)
    pts = _grid_points(packed_cam, max_bot_height, field_scale, off, ys, xs)
    img = field2image_packed(packed_cam, pts)  # (no2, no1, 2)
    u = torch.nan_to_num(img[..., 0] - 0.5, nan=0.0)
    v = torch.nan_to_num(img[..., 1] - 0.5, nan=0.0)
    u = u.clamp(0.0, w - 1.0)
    v = v.clamp(0.0, h - 1.0)

    # pass 2: V2(yo, xo), edge-padded to lane width
    vv = v[:, :wf]
    pos2_base = torch.cat([vv, vv[:, -1:].expand(-1, wfp - wf)], dim=1)

    # pass 1: U1(xo, vs) by per-column inversion of yo -> v (monotone;
    # warp_fits guarantees); a tiny ramp keeps saturated entries strictly
    # increasing for interp
    vs = torch.arange(hp, dtype=torch.float32, device=dev)
    ramp = torch.arange(no2, dtype=torch.float32, device=dev) * 1e-4
    vc = v.t()                                   # (no1, no2)
    uc = u.t()
    inc = (vc[:, -1] >= vc[:, 0])[:, None]       # (no1, 1)
    xp = torch.where(inc, vc + ramp, -vc + ramp)
    q = torch.where(inc, vs[None, :], -vs[None, :])
    pos1_base = interp(q, xp, uc)                # (no1, hp)

    offs = np.asarray(_PLANE_OFFSETS[fmt], dtype=np.float32)  # (4, 2) x, y
    pos1 = torch.stack(
        [(pos1_base + float(offs[c, 0])).clamp(0.0, w - 1.001) for c in range(4)]
    )
    pos2 = torch.stack(
        [(pos2_base + float(offs[c, 1])).clamp(0.0, h - 1.001) for c in range(4)]
    )
    return {
        "pos1": pos1.contiguous(),
        "r01": _block_starts(pos1, WIN, w),
        "pos2": pos2.contiguous(),
        "r02": _block_starts(pos2, WIN, h),
    }


def warp_fits(model, field_scale, field_offset, out_shape, plane_shape,
              max_bot_height: float) -> bool:
    """Host-side separability check at geometry time: per-column v strictly
    monotone over the visible grid, finite projections, and every
    (BLK, LAN) block's source span within WIN-1 rows for both passes
    (numpy; the same test as the JAX package's warp_fits)."""
    hf, wf = out_shape
    h2, w2 = int(plane_shape[0]), int(plane_shape[1])
    if h2 < WIN or w2 < WIN:
        return False
    no1, no2 = _pad_to(wf, BLK), _pad_to(hf, BLK)
    ys = np.minimum(np.arange(no2), hf - 1) * field_scale + field_offset[1]
    xs = np.minimum(np.arange(no1), wf - 1) * field_scale + field_offset[0]
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx, gy, np.full_like(gx, max_bot_height)], axis=-1)
    img = model.field2image(pts.reshape(-1, 3)).reshape(gx.shape + (2,))
    if not np.isfinite(img).all():
        return False
    u = np.clip(img[..., 0] - 0.5, 0.0, w2 - 1.0)
    v = np.clip(img[..., 1] - 0.5, 0.0, h2 - 1.0)
    dv = np.diff(v[:hf], axis=0)
    if not ((dv >= 0).all() or (dv <= 0).all()):
        return False
    # exact ties are fine only where the clip saturates
    sat = (v[:hf] <= 0.0) | (v[:hf] >= h2 - 1.0)
    if ((dv == 0) & ~(sat[:-1] | sat[1:])).any():
        return False

    def span_ok(pos):
        n_out, c = pos.shape
        cp = _pad_to(c, LAN)
        pos = np.pad(pos, ((0, 0), (0, cp - c)), mode="edge")
        p = pos.reshape(n_out // BLK, BLK, cp // LAN, LAN)
        span = np.ceil(p.max(axis=(1, 3))) - np.floor(p.min(axis=(1, 3)))
        # +0.5 for the plane offsets, +1 for the 2-tap stencil
        return (span + 1.5 <= WIN - 1).all()

    vs = np.arange(_pad_to(h2, LAN), dtype=np.float64)
    pos1 = np.empty((no1, vs.shape[0]), np.float64)
    ramp = np.arange(no2) * 1e-4
    for c in range(no1):
        vc, uc = v[:, c], u[:, c]
        if vc[-1] >= vc[0]:
            pos1[c] = np.interp(vs, vc + ramp, uc)
        else:
            pos1[c] = np.interp(-vs, -vc + ramp, uc)
    return span_ok(pos1) and span_ok(v[:, :wf])


def cameras_fit_warp(entries, out_shape, plane_shape) -> bool:
    """warp_fits over a rig of (model, field_scale, field_offset,
    max_bot_height) entries: True iff every camera admits the warp."""
    return all(
        warp_fits(model, scale, offset, out_shape, plane_shape, zmax)
        for model, scale, offset, zmax in entries
    )


def resolve_resample_mode(requested: str, entries, out_shape, plane_shape,
                          device) -> str:
    """"auto" becomes "warp" on a CUDA device when every camera passes
    warp_fits, else "gather" (on the CPU the port keeps the gather, as the
    JAX package does off the TPU). Other requests pass through."""
    if requested != "auto":
        return requested
    if torch.device(device).type != "cuda":
        return "gather"
    if cameras_fit_warp(entries, out_shape, plane_shape):
        return "warp"
    from ..utils.log import get_logger

    get_logger(__name__).info("warp_fits rejected the geometry; gather resample")
    return "gather"


# ---------------------------------------------------------------------------
# device apply
# ---------------------------------------------------------------------------


def cells_chfirst_t(raw: torch.Tensor, fmt: str, hp: int) -> torch.Tensor:
    """(4, W, Hp) f32 channel-first transposed cell planes, zero-padded
    along the source-row axis to Hp."""
    planes = raw2planes_packed(raw, fmt)            # (H, W, 4)
    t = planes.permute(2, 1, 0)                     # (4, W, H)
    pad = hp - t.shape[2]
    return torch.nn.functional.pad(t, (0, pad)).contiguous()


def resample_flat_warp(raw: torch.Tensor, wgrid: dict, fmt: str,
                       out_shape: tuple[int, int],
                       plane_shape: tuple[int, int]) -> torch.Tensor:
    """raw frame -> (Hf, Wf, 3) flat dRGB grid via the two-pass warp."""
    hf, wf = out_shape
    h, w = plane_shape
    hp = _pad_to(h, LAN)
    wfp = _pad_to(wf, LAN)
    no1 = _pad_to(wf, BLK)

    src1 = cells_chfirst_t(raw, fmt, hp)                     # (4, W, Hp)
    mid = band_pass(src1, wgrid["pos1"])                     # (4, no1, Hp)
    mid_t = mid.permute(0, 2, 1)[:, :h]                      # (4, H, no1)
    mid_t = torch.nn.functional.pad(mid_t, (0, wfp - no1)).contiguous()
    out = band_pass(mid_t, wgrid["pos2"])                    # (4, no2, WFp)

    samples = out.permute(1, 2, 0)[:hf, :wf]                 # (Hf, Wf, 4)
    r, g, b = combine_planes(samples, fmt)
    return rgb_to_drgb(r, g, b)
