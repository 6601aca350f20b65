"""BENCHMARK.json against the rules it is held to: its keys, names and
units, the files every name points to, and the time a full check takes."""

import json
import os
import re

import pytest

from benchmarks import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_top_level_keys_and_size(man):
    assert set(man) == TOP_KEYS
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_command_and_paths(man):
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert len(man["command"]) <= 32
    script = man["command"][1]
    assert any(script.startswith(p + "/") for p in man["paths"])


def test_entries_have_only_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(man, group):
    names = [e["name"] for e in man[group]]
    assert len(names) == len(set(names))
    for e in man[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_every_name_finds_its_files(man):
    for c in man["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("benchmarks/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert cfg["source"] == c["source"]
    for w in man["workloads"]:
        tr = harness.traffic(w["traffic"])
        assert os.path.isfile(os.path.join(
            harness.BENCH, "drivers", tr["driver"] + ".py"))
        assert "limits" in tr
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_metric_cells_report_what_they_move(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    assert "setup_s" in e2e
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        ends = harness.metrics_of(man, cell, traced=False)
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert harness.metrics_of(man, cell, traced=True)


def test_layers_are_named_alike(man):
    layers = {m["layer"] for m in man["per_layer"]}
    assert layers <= {"data", "step", "model", "kernels", "device"}


def test_full_check_fits(man):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1,200 s spare fit into 43,200 s (the limit with 24 cells)."""
    rs = man["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_four_chip_cells_within_share(man):
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_config_files_hold_no_cut_width(man):
    for c in man["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["hidden_size"] == 768 and cfg["intermediate_size"] == 3072
        assert cfg["num_hidden_layers"] == 12
        assert cfg["num_attention_heads"] == 12
        assert json.dumps(cfg)
