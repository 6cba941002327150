"""Every configuration, cell and metric of ``BENCHMARK.json`` loads by name
from its own file, and the file keeps to the benchmark's contract."""
import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_from_its_own_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = core.load_json("configs", config["name"])
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert all(NAME.match(k) for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert importlib.import_module(f"portbench.reference.{data['algorithm']}")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_from_its_own_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    spec = core.cell_spec(cell["name"], BENCH)
    assert spec["workload"]["config"] == cell["config"]
    driver = core.load_module("drivers", spec["workload"]["driver"])
    assert callable(driver.setup) and callable(driver.window)
    assert callable(core.load_module("checks", spec["workload"]["check"]).compare)
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_loads_from_its_own_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(core.reader(metric["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "bound" not in metric and metric["layer"].strip() == metric["layer"]
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert core.applies(moved, cell)
    if metric["unit"] == "%" and metric["name"].endswith("_roofline"):
        assert metric["better"] == "higher"


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_under_paths_has_a_plain_name():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel


def synthetic_run(cell):
    """A traced window of ``cell`` as its driver would record it: two calls
    (or three pushes and a flush), each with the configuration's main
    kernels under the names the card gives them and an unrelated copy."""
    spec = core.cell_spec(cell, BENCH)
    wl, cfg = spec["workload"], spec["config"]
    run = core.Run(cell, spec, 1, "cpu")
    if wl["driver"] == "offline_call":
        kinds = [("call", wl["units_per_call"], wl["batch"] * cfg["clip_seconds"])] * 2
    else:
        hop_s = cfg["hop_length"] / cfg["sample_rate"]
        kinds = [("push", 1, wl["streams"] * hop_s)] * 3 + [("flush", 3, 0.0)]
    kernels, spans = [], []
    for i, (kind, units, audio) in enumerate(kinds):
        a = 1000.0 * i
        spans.append((f"portbench.{kind}", a, a + 900))
        for j, name in enumerate(cfg["kernels"]["main"] * 3):
            kernels.append((f"void (anonymous namespace)::{name}<1>(float*, int)",
                            a + 100 + 200 * j, a + 250 + 200 * j))
        kernels.append(("Memcpy DtoD (Device -> Device)", a + 50, a + 60))
        run.records.append(core.Record(a / 1e6, (a + 900) / 1e6, audio, units, True, kind))
    run.window_s = 1000.0 * len(kinds) / 1e6
    run.trace = {"kernels": kernels, "spans": spans, "host": [],
                 "window": (0.0, 1000.0 * len(kinds))}
    return spec, run


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_per_layer_metric_of_a_cell_reads_its_synthetic_trace(cell):
    spec, run = synthetic_run(cell)
    for metric in spec["per_layer"]:
        value = core.reader(metric["name"]).read(run)
        assert value is not None and value > 0, metric["name"]
