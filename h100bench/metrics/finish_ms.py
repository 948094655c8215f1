"""``finish_ms``: host ms a frame-set in finishing and sending
(``MultiCamApp.finish_frames``: the device-to-host copy, host finishing on
the pool, the bus's send), over the traced window's host part."""


def read(record: dict):
    host = record["host"]
    spans = host["spans"]["finish"]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
