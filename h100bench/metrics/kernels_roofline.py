"""``kernels_roofline``: the least time that the profiled part's calls of
the twelve kernel functions need (``roofline.work`` from their shapes, at
3.35 TB/s or 67 TFLOP/s), over the card's busy time in those functions'
kernels, in %. Nothing to read where no such call or kernel ran."""

from roofline import kernel_function, least_seconds


def read(record: dict):
    prof = record["profiled"]
    if not prof or not prof["calls"]:
        return None
    busy = sum(e - s for s, e, name in prof["device"] if kernel_function(name))
    if busy <= 0:
        return None
    least = sum(least_seconds(b, o) for _, b, o in prof["calls"])
    return 100.0 * least / busy
