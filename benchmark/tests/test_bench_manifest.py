"""BENCHMARK.json keeps to the contract's names and finds a file for each entry."""

import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"] and 1 <= MAN["run_seconds"] <= 51
    assert all(LINE.match(w) for w in MAN["command"]) and len(MAN["command"]) <= 32
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + metrics]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(NAME.match(w[k]) for w in MAN["workloads"] for k in ("config", "traffic"))
    assert all(LINE.match(x["why"]) for x in MAN["configs"] + MAN["workloads"])
    assert all(LINE.match(m["layer"]) for m in MAN["per_layer"])
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    assert all(0 < m["bound"] <= 0.25 for m in MAN["end_to_end"])


def test_each_entry_has_its_files():
    configs = {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert json.load(open(os.path.join(harness.ROOT, c["file"])))["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(harness.BENCH, "traffic", w["traffic"] + ".json"))
        t = harness.load_json(os.path.join(harness.BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(harness.BENCH, "loops", t["loop"] + ".py"))
        assert os.path.isfile(os.path.join(harness.BENCH, "limits", w["name"] + ".json"))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert os.path.isfile(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        shown = harness.cell_metrics(MAN, w["name"], False)
        assert "setup_s" in [m["name"] for m in shown] and len(shown) >= 2
        layer = harness.cell_metrics(MAN, w["name"], True)
        assert layer and all(m["moves"] in [s["name"] for s in shown] for m in layer)
        assert all(e2e[m["moves"]]["source"] in ("host_clock", "device_trace") for m in layer)


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_layers_of_one_name_agree(m):
    same = [x for x in MAN["per_layer"] if x["layer"] == m["layer"]]
    assert all(x["layer"] == m["layer"] for x in same)
    if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
        assert m["unit"] == "%"
