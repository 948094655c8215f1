"""``device_idle_share``: the share (%) of the profiled part in which the
card ran no kernel, copy or fill."""

from spans import busy_intervals


def read(record: dict):
    prof = record["profiled"]
    if not prof or not prof["device"]:
        return None
    a, b = prof["window"]
    busy = sum(e - s for s, e in busy_intervals(prof["device"], (a, b)))
    return 100.0 * (1.0 - busy / (b - a))
