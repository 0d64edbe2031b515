"""BENCHMARK.json against the contract it is written to, and every name in
it against the files the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"][:1] == ["python3"] and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path) and not path.startswith("/")
        assert ".." not in path.split("/") and not path.endswith("_torch")
    for word in BENCH["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"])
    for group, key in (("configs", "config"), ("workloads", "workload"),
                       ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        assert 1 <= len(BENCH[group]) <= (128 if group == "per_layer" else 24)
        for entry in BENCH[group]:
            assert set(entry) <= KEYS[key], entry["name"]


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_texts(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_cells_configs_and_metrics_refer_to_each_other():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert {w["config"] for w in cells.values()} == configs
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert all(w["chips"] == 1 for w in cells.values())
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(cells) and m["moves"] in e2e
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
        layers.setdefault(m["layer"], []).append(m["name"])
    for name in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(name in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(name in m["workloads"] for m in BENCH["per_layer"])
    roofline = [m for m in BENCH["per_layer"] if "roofline" in m["name"] or "mfu" in m["name"]]
    assert roofline and all(m["unit"] == "%" for m in roofline)


def test_files_found_by_name():
    from perfbench.harness import cell as C

    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []
        C.reference_module(conf).arguments(conf["settings"])
    for w in BENCH["workloads"]:
        cell = C.load_cell(w["name"])
        assert cell["limits"] and cell["mix"]["driver"] == "sweep"
    for m in BENCH["per_layer"]:
        assert callable(C.load_reader(m["name"]))


def test_a_metric_reader_returns_nothing_without_a_trace():
    from perfbench.harness import cell as C

    for m in BENCH["per_layer"]:
        assert C.load_reader(m["name"])({"driver": "sweep", "trace": {}, "stages": {}}) is None
