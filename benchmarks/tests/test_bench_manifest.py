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


# a width: hidden and intermediate sizes (an expert's too), head counts,
# head and other dims, latent ranks, experts per token, expansion factors
WIDTH = re.compile(r"(hidden_size|intermediate_size|_heads|_dim|_rank|"
                   r"_width|_factor|experts_per_tok|experts_per_token)$")
# the deployment a cut stands for: "EP8", "TP 4", "8 chips", "4 GPUs"
DEPLOYMENT = re.compile(r"\b(EP|TP|DP|PP) ?\d+\b|\b\d+ (chips|GPUs|cards)\b")
FIXTURE = os.path.join(os.path.dirname(__file__), "kimi_vl_cut.json")


def config_faults(cfg: dict, reduced) -> list:
    """What breaks the rule that a configuration holds its source's own
    shape: (a) a ``published`` key whose value differs from the file's
    without being in ``reduced``; (b) a width in ``reduced``; (c) a key in
    ``reduced`` that ``published`` lacks or that equals its published
    value, or a cut whose ``description`` names no deployment."""
    pub = cfg.get("published")
    if not pub:
        return ["no published values"]
    faults = [f"{k} is {cfg.get(k)!r}, published {v!r}, not in reduced"
              for k, v in pub.items() if k not in reduced and cfg.get(k) != v]
    faults += [f"{k} is a width" for k in reduced if WIDTH.search(k)]
    for k in reduced:
        if k not in pub:
            faults.append(f"{k} has no published value")
        elif cfg.get(k) == pub[k]:
            faults.append(f"{k} is in reduced but equals its published value")
    if reduced and not DEPLOYMENT.search(cfg.get("description", "")):
        faults.append("the description names no deployment")
    return faults


@pytest.mark.parametrize("name", ["vlp-base-coco-cap", "vlp-base-vqa2"])
def test_config_holds_its_published_shape(man, name):
    entry = {c["name"]: c for c in man["configs"]}[name]
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    assert config_faults(cfg, entry["reduced"]) == []
    assert cfg["reduced"] == entry["reduced"]


def test_every_config_holds_its_published_shape(man):
    for c in man["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert config_faults(cfg, c["reduced"]) == [], c["name"]
        assert json.dumps(cfg)


@pytest.mark.parametrize("name", ["vlp-base-coco-cap", "vlp-base-vqa2"])
def test_vlp_base_holds_bert_base(man, name):
    """What was asserted of every configuration while both were
    BERT-base: the two VLP files keep its widths and depth."""
    entry = {c["name"]: c for c in man["configs"]}[name]
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    assert cfg["hidden_size"] == 768 and cfg["intermediate_size"] == 3072
    assert cfg["num_hidden_layers"] == 12
    assert cfg["num_attention_heads"] == 12


def test_a_share_of_a_deployment_passes():
    """A cut in the shape of a planned expert-parallel share (experts
    held, vocabulary, depth) keeps every width and passes."""
    cfg = harness.load_json(FIXTURE)
    assert config_faults(cfg, cfg["reduced"]) == []


CUT = ["num_hidden_layers", "n_routed_experts_held", "vocab_size"]


@pytest.mark.parametrize("key, value, listed, fault", [
    ("hidden_size", 1024, False, "not in reduced"),              # (a)
    ("hidden_size", 1024, True, "is a width"),                   # (b)
    ("moe_intermediate_size", 704, True, "is a width"),
    ("kv_lora_rank", 256, True, "is a width"),
    ("qk_rope_head_dim", 32, True, "is a width"),
    ("num_attention_heads", 2, True, "is a width"),
    ("num_experts_per_tok", 2, True, "is a width"),
    ("num_hidden_layers", 27, True, "equals its published"),     # (c)
    ("ep_size", 8, True, "has no published value"),
    ("description", "Kimi-VL-A3B's language model, cut", False,
     "names no deployment"),
], ids=["width_not_listed", "hidden_listed", "expert_width_listed",
        "latent_rank_listed", "head_dim_listed", "head_count_listed",
        "experts_per_tok_listed", "reduced_equals_published",
        "reduced_unpublished", "no_deployment"])
def test_a_cut_width_or_an_unstated_cut_fails(key, value, listed, fault):
    cfg = harness.load_json(FIXTURE)
    cfg[key] = value
    reduced = CUT + [key] if listed and key not in CUT else CUT
    faults = config_faults(cfg, reduced)
    assert any(fault in f for f in faults), faults
