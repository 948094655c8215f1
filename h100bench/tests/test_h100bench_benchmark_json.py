"""``BENCHMARK.json`` against the contract's characters and limits, and
every workload's files found by name."""
import json
import re
from pathlib import Path

import pytest

import rig
from reference.truth import NUMBERS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_workload_finds_its_files(work):
    config = next(c for c in BENCH["configs"] if c["name"] == work["config"])
    assert (ROOT / config["file"]).is_file()
    assert config["file"] == f"h100bench/configs/{work['config']}.json"
    cfg = rig.load_json("configs", work["config"])
    assert cfg["reduced"] == config["reduced"] and "assumed" in cfg
    rig.load_json("traffic", work["traffic"])
    limits = rig.load_json("limits", work["name"])
    assert set(NUMBERS) <= set(limits)
    for m in BENCH["per_layer"]:
        if work["name"] in m.get("workloads", [work["name"]]):
            assert (ROOT / "h100bench" / "metrics" / f"{m['name']}.py").is_file()


def test_every_config_is_used_and_pairs_are_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
