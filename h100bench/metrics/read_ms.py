"""``read_ms``: host ms a frame-set in the app loop's camera read
(``MultiCamApp._read_all``), over the traced window's host part."""


def read(record: dict):
    host = record["host"]
    if not host["frame_sets"]:
        return None
    return 1e3 * sum(b - a for a, b in host["spans"]["read"]) / host["frame_sets"]
