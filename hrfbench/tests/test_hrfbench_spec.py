"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file it names."""
import json
import re

import pytest

from hrfbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hrfbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert len(json.dumps(SPEC)) <= 64 * 1024
    cells = len(SPEC["workloads"])
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200, "a full check of 24 cells must fit"
    assert cells <= 24 and sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for e in SPEC[section]:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_entries(section):
    for m in SPEC[section]:
        extra = {"bound"} if section == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == METRIC_KEYS | extra, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in SPEC["workloads"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, w["name"], "per_layer")


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(SPEC, cell, "end_to_end")}, (m["name"], cell)


def test_every_name_resolves_to_a_file():
    for c in SPEC["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (harness.BENCH_DIR / "configs" / f"{w['config']}.json").exists()
        traffic = harness.load_json("traffic", w["traffic"])
        assert (harness.BENCH_DIR / "drivers" / f"{traffic['driver']}.py").exists()
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_configuration_is_used_by_a_cell():
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
