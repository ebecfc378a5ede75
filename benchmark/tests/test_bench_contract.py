"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units, bounds and files."""

from __future__ import annotations

import json
import os
import re

from benchmark.harness import ROOT

PATH = os.path.join(ROOT, "BENCHMARK.json")
BENCH = json.load(open(PATH))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATHLIKE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(PATH) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATHLIKE.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(line(w) and not w.startswith("/") for w in BENCH["command"])


def test_entries_names_and_units():
    for section, keys in KEYS.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metrics = [m["name"] for s in ("end_to_end", "per_layer")
               for m in BENCH[s]]
    assert len(metrics) == len(set(metrics))


def test_cells_configs_and_metrics_hang_together():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in configs.values():
        assert line(c["source"]) and line(c["why"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert any(w in m.get("workloads", cells) and m["name"] != "setup_s"
                   for m in BENCH["end_to_end"])
