"""Every file the benchmark finds by name is there and loads."""
import importlib.util
import json
import re

import pytest

from simbench import harness
from simbench.tests.conftest import CHECKOUT

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _metric(name):
    path = CHECKOUT / "simbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_and_names_only_metrics_with_files(w):
    cell = harness.load_cell(w)
    assert cell.traffic["scenarios"] and cell.config["steps"] > 0
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names
    for name in names:
        assert callable(_metric(name).read), name
    for _, proto, _ in harness.scenario_params(cell.config, cell.traffic):
        assert proto["algorithm"] in cell.config["algorithms"]
    assert set(cell.traffic["limits"]) == {"outputs_mismatched", "state_mismatched",
                                           "theta_mean_gap"}


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_file_is_found_by_name(m):
    assert NAME.match(m)
    assert (CHECKOUT / "simbench" / "metrics" / f"{m}.py").is_file()


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(c):
    cfg = json.loads((CHECKOUT / c["file"]).read_text())
    assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    assert cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in cfg


def test_benchmark_json_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["simbench"] and BENCH["command"] == ["python3", "simbench/run.py"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
