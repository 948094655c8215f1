"""``launches_per_frameset``: kernel, copy and fill operations that the card
ran in the profiled part, over the frame-sets dispatched in it."""


def read(record: dict):
    prof = record["profiled"]
    if not prof or not prof["frame_sets"] or not prof["device"]:
        return None
    return len(prof["device"]) / prof["frame_sets"]
