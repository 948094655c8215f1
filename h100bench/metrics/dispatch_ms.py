"""``dispatch_ms``: host ms a frame-set in the camera batch and the step's
dispatch (``MultiCamApp.dispatch_frames``), over the traced window's host
part."""


def read(record: dict):
    host = record["host"]
    if not host["frame_sets"]:
        return None
    return 1e3 * sum(b - a for a, b in host["spans"]["dispatch"]) / host["frame_sets"]
