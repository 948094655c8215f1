"""The yardstick of the port's twelve hand-written kernel functions: the
least time that each call needs on one H100, from the call's shapes.

The least time is the larger of the bytes that must move over the HBM
rate and the float32 operations over the peak rate. Bytes count each
input read once and each output written once; operations are the
arithmetic the function's contract needs. Both are counted from what the
function computes, not from how one implementation reads, so a later
kernel that replaces one keeps the same yardstick. The formulas are those
of the port's kernel contract runs (``chip_smoke.py``, phase 8).

Peaks: NVIDIA H100 SXM5 80 GB data sheet, 3.35 TB/s HBM3 and 67 TFLOP/s
float32 outside the tensor cores, at the full 700 W power limit.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the kernel wrappers the main path calls: launch-count name -> (module of
# the port, attribute); the card-side functions each of them launches
WRAPPERS = {
    "band_pass": ("ops.warp", "band_pass"),
    "blob_response_fused": ("ops.blob_fused", "blob_response_fused"),
    "row_topk": ("ops.topk", "row_topk"),
    "query_select_topk": ("ops.topk", "query_select_topk"),
    "gather_corners": ("ops.frame", "gather_corners"),
    "circularity_fused": ("ops.blob_fused", "circularity_fused"),
    "combo_chain": ("ops.combo_fused", "combo_chain"),
    "corner_stack": ("ops.frame", "corner_stack"),
    "resample_packed": ("ops.pipeline", "resample_packed"),
    "band_warp": ("ops.band_warp", "band_warp"),
    "row_topk_blk": ("ops.topk", "row_topk_blk"),
}
KERNEL_NAMES = frozenset({
    "band_pass_kernel", "blob_tile_kernel", "row_topk_kernel", "row_topk_warps",
    "query_topk_kernel", "query_topk_blocks", "gather_corners_kernel",
    "combo_chain_kernel", "corner_stack_kernel", "resample_packed_kernel",
    "band_warp_kernel", "row_topk_blk_warps",
})
_IDENT = re.compile(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(?:\w+::)*([A-Za-z_]\w*)\s*[<(]")


def kernel_function(device_name: str) -> str | None:
    """The kernel function a device event ran, when it is one of the
    twelve; None for any other operation."""
    m = _IDENT.match(device_name.strip())
    name = m.group(1) if m else device_name.strip()
    return name if name in KERNEL_NAMES else None


def _n(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def work(name: str, args: tuple, kwargs: dict) -> tuple[float, float]:
    """(bytes, float32 operations) that one call of wrapper ``name`` needs.
    ``args`` holds a tensor argument's shape (a tuple) and a scalar as is;
    gather_corners's index argument also brings its distinct rows."""
    a = args
    if name == "band_pass":
        src, pos = _n(a[0]), _n(a[1])
        return 4.0 * (src + 2 * pos), 5.0 * pos
    if name == "band_warp":
        src, pos, r0, win = _n(a[0]), _n(a[1]), _n(a[2]), int(a[3])
        return 4.0 * (src + 2 * pos + r0), 5.0 * win * pos
    if name == "blob_response_fused":
        h, w = a[0][0], a[0][1]
        r, dr = int(a[3]), int(a[4])
        ops_px = 11 + 2 * (r - 2) + 6 + 4 + 6 * (4 * dr + 1) + 3 + 15 + 5
        return 4.0 * h * w * (3 + 5) + 4, float(ops_px * h * w)
    if name == "circularity_fused":
        h, w = a[0][0], a[0][1]
        r = int(a[2])
        return 4.0 * h * w * (3 + 1), float((11 + 2 * (r - 2) + 6) * h * w)
    if name in ("row_topk", "row_topk_blk"):
        r, l = a[0]
        m = int(a[1])
        return 4.0 * r * l + 8.0 * r * m, float(r * l)
    if name == "query_select_topk":
        q, k = a[0][0], a[2][0]
        m = int(kwargs["m"] if "m" in kwargs else a[4])
        return 12.0 * q + 12.0 * k + 8.0 * q * m, 6.0 * q * k
    if name == "gather_corners":
        n, rows = _n(a[1]), int(kwargs["distinct_rows"])
        return 4.0 * n + 16.0 * rows + 64.0 * n, 16.0 * n
    if name == "corner_stack":
        shape, fmt = a[0], a[1]
        h, w = (shape[0], shape[1]) if fmt == "BGR" else (shape[0] // 2, shape[1] // 2)
        return 20.0 * h * w, 0.0
    if name == "resample_packed":
        n = _n(a[1])
        return float(_n(a[0])) + 20.0 * n, 106.0 * n
    if name == "combo_chain":
        _, n, c = a[0]
        return 4.0 * 12 * n * c + 13.0 * n + 4.0 * c + 24.0 * n, 120.0 * n * c
    raise KeyError(name)


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time on the card: bytes over the HBM rate or operations
    over the float32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
