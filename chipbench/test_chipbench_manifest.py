"""BENCHMARK.json against the benchmark's rules, and the files it
names: configurations, traffic, limits, metric readers."""
import json
import re

import pytest

from chipbench import harness, program

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]
# the source's key of each size the port's ModelConfig takes
PUBLISHED = {"hidden_size": "d_model", "intermediate_size": "d_ff",
             "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
             "num_hidden_layers": "n_layers", "num_experts": "n_experts",
             "num_local_experts": "n_experts", "num_experts_per_tok": "experts_per_token",
             "vocab_size": "vocab_size", "rope_theta": "rope_theta",
             "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"] and BENCH["command"][1] == "chipbench/run.py"
    assert len(json.dumps(BENCH)) < 64 * 1024
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells, 14 runs each, fits in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS and cell in moved.get("workloads", CELLS)
    assert m["better"] in ("lower", "higher")
    assert m["layer"] in (ROOT / "PERF.md").read_text()    # PERF.md's list of layers


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_reports(cell):
    assert cell["chips"] == 1
    assert any(c["name"] == cell["config"] for c in BENCH["configs"])
    traffic = json.loads((ROOT / "chipbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "chipbench" / "drivers" / f"{traffic['kind']}.py").exists()
    limits = json.loads((ROOT / "chipbench" / "limits" / f"{cell['name']}.json").read_text())
    assert limits["numbers"] and all(v > 0 for v in limits["numbers"].values())
    e2e = harness.metrics_for(BENCH, cell["name"], False)
    layer = harness.metrics_for(BENCH, cell["name"], True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_every_metric_has_a_reader():
    for m in METRICS:
        assert (ROOT / "chipbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs_hold_the_published_widths(entry):
    assert entry["file"].startswith("chipbench/configs/")
    assert entry["source"].startswith("https://")
    used = [w for w in BENCH["workloads"] if w["config"] == entry["name"]]
    assert used
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["source"] == entry["source"] and conf["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= {"num_hidden_layers"}   # depth only: no width is cut
    for key, port in PUBLISHED.items():
        if key in conf:
            assert conf["model"][port] == conf[key], key
    assert conf["model"]["sliding_window"] == (conf.get("sliding_window") or 0)
    cfg = program.model_config(conf)
    assert cfg.hd == conf["hidden_size"] // conf["num_attention_heads"]
    assert cfg.n_layers == conf["num_hidden_layers"] and cfg.is_moe
