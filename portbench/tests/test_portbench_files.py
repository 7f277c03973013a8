"""BENCHMARK.json against the benchmark's contract, and every name in it
against its file."""
import json
import os
import re

import pytest

from portbench.common import (ROOT, Cell, driver_module, load_benchmark,
                              load_reader, reader_path, traffic_path)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = Cell(BENCH, cell)
    assert os.path.isfile(traffic_path(c.entry["traffic"]))
    assert c.config_entry["file"].startswith("portbench/")
    assert hasattr(driver_module(c.kind), "Driver")
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    assert len(files) == len(BENCH["configs"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_has_a_reader(metric):
    assert os.path.isfile(reader_path(metric))
    assert load_reader(metric).read({}) is None


def test_names_units_and_keys():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.add(m["layer"])
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    for x in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_lists_only_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_roofline_and_mfu_metrics_are_shares():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "roofline." in m["name"] or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"
