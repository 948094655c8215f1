"""The port's timing utilities (``utils/timing.py``) on the CPU:
``StageTimer.measure`` against the JAX package's on the same calls, and
``trace``'s Chrome trace of a traced op."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from vision_processor_tpu.utils.timing import StageTimer as JStageTimer
from vision_processor_tpu_torch.utils.timing import StageTimer, trace


@pytest.mark.parametrize("device", [None, "cpu"])
def test_measure_counts_as_the_jax_timer(device):
    """Returns fn's output (args and kwargs passed through) and adds one
    run to ``counts`` and its wall time to ``totals`` per call, as the JAX
    ``StageTimer.measure`` does on the same calls; the CPU records no
    device time."""
    import jax.numpy as jnp

    timer, jtimer = StageTimer(device), JStageTimer()
    x = np.arange(8, dtype=np.float32)
    calls = [("double", lambda v, k=2: v * k, {}), ("double", lambda v, k=2: v * k, {"k": 3}),
             ("sum", lambda v: v.sum(), {})]
    for name, fn, kw in calls:
        out = timer.measure(name, fn, torch.from_numpy(x), **kw)
        jout = jtimer.measure(name, fn, jnp.asarray(x), **kw)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert dict(timer.counts) == dict(jtimer.counts) == {"double": 2, "sum": 1}
    assert set(timer.totals) == set(jtimer.totals)
    assert all(t > 0 for t in timer.totals.values())
    assert timer.device_ms("double") == []
    timer.print_runtimes()
    timer.clear()
    assert not timer.totals and not timer.counts


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    """On the CPU, ``trace`` yields its directory and leaves one Chrome
    trace there holding the events of the op run inside it."""
    a = torch.ones(64, 64)
    with trace(str(tmp_path)) as log_dir:
        assert log_dir == str(tmp_path)
        torch.mm(a, a)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_raises_the_block_error_and_still_writes(tmp_path):
    """An error in the block leaves it; the trace up to it is written."""
    with pytest.raises(ValueError, match="in the block"):
        with trace(str(tmp_path)):
            torch.ones(4).add_(1)
            raise ValueError("in the block")
    events = json.loads(next(tmp_path.iterdir()).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
