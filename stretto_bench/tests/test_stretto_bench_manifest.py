"""BENCHMARK.json and the files it names: found by name, within the
contract's limits, and open to a new configuration, cell and metric added
as files alone."""
import json
import re

import pytest

from stretto_bench import harness
from stretto_bench_tiny import ROOT, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SB = ROOT / "stretto_bench"


def reporters(entry):
    return set(entry.get("workloads",
                         [w["name"] for w in BENCH["workloads"]]))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["stretto_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_names_files_that_exist(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    w = json.loads((SB / "workloads" / f"{cell['name']}.json").read_text())
    assert (w["config"], w["traffic"]) == (cell["config"], cell["traffic"])
    assert (SB / "traffic" / f"{w['kind']}.py").exists()
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    model = json.loads((ROOT / conf["file"]).read_text())
    assert model["name"] == conf["name"]
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in reporters(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in reporters(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_is_used_and_states_its_cuts(conf):
    assert NAME.match(conf["name"])
    assert conf["file"].startswith("stretto_bench/configs/")
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    model = json.loads((ROOT / conf["file"]).read_text())
    assert set(conf["reduced"]) == set(model["reduced"])
    assert all(NAME.match(k) for k in conf["reduced"])
    harness.check_layout(harness.port_config(model), model)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader_and_valid_names(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (SB / "metrics" / f"{metric['name']}.py").exists()
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert reporters(metric) <= reporters(moved)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path,
                                                       monkeypatch):
    """Files added beside the others, and entries in BENCHMARK.json, are
    all a new cell takes: no file that is there changes."""
    for key in ("STRETTO_TORCH_KERNELS", "STRETTO_FUSED"):
        monkeypatch.delenv(key, raising=False)
    root = tiny_root(tmp_path)
    sb = root / "stretto_bench"
    before = {p: p.read_bytes() for p in sb.rglob("*") if p.is_file()}
    model = json.loads((sb / "configs" / "granite-8b-l4.json").read_text())
    model.update(name="granite-8b-l3", num_hidden_layers=3)
    model["port"]["replace"]["n_layers"] = 3
    (sb / "configs" / "granite-8b-l3.json").write_text(json.dumps(model))
    w = json.loads((sb / "workloads" / "granite-8b-l4.gold_flush_long.json")
                   .read_text())
    w.update(config="granite-8b-l3", traffic="gold_flush_short")
    w["params"].update(len_min=8, len_max=24)
    (sb / "workloads" / "granite-8b-l3.gold_flush_short.json").write_text(
        json.dumps(w))
    (sb / "metrics" / "flushes_per_s.py").write_text(
        "def read(run):\n"
        "    w = run['window']\n"
        "    return w['steps'] / w['seconds']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "granite-8b-l3", "source": "x",
                             "file": "stretto_bench/configs/"
                                     "granite-8b-l3.json",
                             "reduced": [], "why": "x"})
    cell = "granite-8b-l3.gold_flush_short"
    bench["workloads"].append({"name": cell, "config": "granite-8b-l3",
                               "traffic": "gold_flush_short", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in ("items_per_s", "flush_ms_p95"):
            m["workloads"].append(cell)
    bench["end_to_end"].append({"name": "flushes_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run_cell(cell, 3, 0.2, False, device="cpu", root=root)
    assert set(line["metrics"]) == {"items_per_s", "flush_ms_p95",
                                    "setup_s", "flushes_per_s"}
    assert line["correct"], line["checks"]
    assert all(p.read_bytes() == b for p, b in before.items())
