"""``host_cpu_ms``: the measured process's CPU time (user and system, every
thread, ``getrusage(RUSAGE_SELF)``) a frame-set over the traced window's
host part."""


def read(record: dict):
    host = record["host"]
    if not host["frame_sets"] or host["cpu_s"] is None:
        return None
    return 1e3 * host["cpu_s"] / host["frame_sets"]
