"""The harness finds every configuration, mix, metric and limit file by the
name BENCHMARK.json gives it, refuses an unknown one, and BENCHMARK.json keeps
to the shape the benchmark's contract sets."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_is_found(workload):
    cell = cells.find_cell(workload, BENCH)
    assert cell.end_to_end and "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for name in cell.per_layer:
        assert callable(cells.load_metric(name))
    assert cell.limits and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("kind,name", [("workload", "no-such-cell"), ("config", "no-such-config"),
                                       ("mix", "no-such-mix"), ("metric", "no_such.metric"),
                                       ("limits", "no-such-cell"), ("driver", "no-such-kind"),
                                       ("tower", "no-such-tower")])
def test_unknown_names_are_refused(kind, name):
    find = {"workload": lambda n: cells.find_cell(n, BENCH), "config": cells.load_config, "mix": cells.load_mix,
            "metric": cells.load_metric, "limits": cells.load_limits, "driver": cells.load_driver,
            "tower": cells.load_tower}[kind]
    with pytest.raises(KeyError, match=re.escape(name)):
        find(name)


def test_every_mix_and_config_finds_its_driver_and_tower():
    for w in BENCH["workloads"]:
        cell = cells.find_cell(w["name"], BENCH)
        driver = cells.load_driver(cell.mix["kind"])
        assert callable(driver.run) and callable(driver.reading) and driver.controls(cell)
        if cell.mix["kind"] == "clips":
            tower = cells.load_tower(cell.config["tower"])
            assert callable(tower.visual_tree) and callable(tower.encode)


def test_a_mix_of_an_unknown_kind_is_refused(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "odd.json").write_text(json.dumps({"kind": "no-such-kind"}))
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    with pytest.raises(KeyError, match="no-such-kind"):
        cells.load_mix("odd")


def test_a_workload_naming_an_unlisted_config_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["config"] = "unlisted"
    with pytest.raises(KeyError, match="unlisted"):
        cells.find_cell(bench["workloads"][0]["name"], bench)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + WORKLOADS
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(WORKLOADS)
        for w in m["workloads"]:
            assert m["moves"] in cells.find_cell(w, BENCH).end_to_end
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["reduced"] == cells.load_config(c["name"])["reduced"] == []
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0
