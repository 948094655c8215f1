"""The port's span recorder (``vision_processor_tpu_torch.utils.timing
RECORDER``) against the benchmark's own yardsticks, on the clock they
share (``time.monotonic``): in a traced run on the CPU, each outside
``dispatch`` span of the window holds one program ``dispatch`` span of
nearly its length; on the card, a program span holds the device interval
of the kernel it waits for, as ``Profiled.device_events`` maps it.

    python -m pytest h100bench/tests/test_h100bench_program_spans.py
"""
import pytest

torch = pytest.importorskip("torch")

import run  # noqa: E402
import spans as SP  # noqa: E402
from test_h100bench_card import card  # noqa: E402,F401
from test_h100bench_faults import small_cell  # noqa: E402

from vision_processor_tpu_torch.utils.timing import RECORDER  # noqa: E402


def test_program_dispatch_spans_fill_the_outside_ones():
    """A traced CPU run with the recorder on from before the warm-up: every
    outside ``dispatch`` span of the host part holds exactly one program
    ``dispatch`` span, their sums agree to 2 %, and the k-means counters
    count live rounds among the rounds launched."""
    cfg, mix, limits = small_cell()
    try:
        out = run.run_cell(cfg, mix, 2**31 + 93, 4.0, True, torch.device("cpu"), torch,
                           app_hook=lambda app: RECORDER.enable(device_counting=True))
        drained = RECORDER.drain()
    finally:
        RECORDER.disable()
    assert run.is_correct(run.checks(out["numbers"], out["failed"], limits))
    outside = out["record"]["host"]["spans"]["dispatch"]
    program = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in drained["spans"]
               if s.name == "dispatch"]
    assert outside and drained["dropped"] == 0
    inside = [[p for p in program if a <= p[0] and p[1] <= b] for a, b in outside]
    assert [len(held) for held in inside] == [1] * len(outside)
    assert (sum(b - a for (a, b), in inside) == pytest.approx(
        sum(b - a for a, b in outside), rel=0.02))
    counts = {}
    for c in drained["counts"]:
        counts[c.name] = counts.get(c.name, 0) + c.value
    assert 0 < counts["kmeans.live_rounds"] < counts["kmeans.rounds"]
    assert counts["rebuild.step"] == 1


@pytest.mark.cuda
def test_a_program_span_holds_its_kernel_on_the_profilers_clock(card):  # noqa: F811
    """A span of the port's recorder around ``torch.cuda._sleep`` and its
    sync contains the kernel's device interval as ``Profiled.device_events``
    maps it, to 0.2 ms."""
    torch.cuda.synchronize()
    prof = SP.Profiled(torch, 0.0, lambda: None)
    prof.maybe_start()
    RECORDER.enable()
    try:
        torch.cuda._sleep(20_000_000)  # a first launch, outside the span
        torch.cuda.synchronize()
        with RECORDER.span("sleep"):
            torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
        span = next(s for s in RECORDER.drain()["spans"] if s.name == "sleep")
    finally:
        RECORDER.disable()
        prof.stop()
    sleeps = sorted(e for e in prof.device_events() if "spin_kernel" in e[2])
    assert len(sleeps) == 2, prof.device_events()
    start, end, _ = sleeps[1]
    assert end - start > 1e-3
    assert span.start_ns * 1e-9 - 2e-4 <= start and end <= span.end_ns * 1e-9 + 2e-4
