"""Every name in `BENCHMARK.json` resolves to its file, and the manifest
keeps to the contract's shapes."""

import json
import os
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.manifest()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"])
    assert config["file"].startswith("portbench/")
    with open(os.path.join(spec.ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["name"] == config["name"] and data["reduced"] == []
    for net in data["networks"].values():
        assert os.path.exists(os.path.join(spec.ROOT, net["file"]))
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and entry["chips"] == 1
    assert len(entry["why"]) <= 200
    cell = spec.Cell(entry["name"], BENCH)
    for key in ("batch", "sqp_config", "perturbation", "obstacle",
                "warmup_ticks", "check_lanes", "check_tick_below",
                "trace_ticks", "gap_ticks", "sync_ticks"):
        assert key in cell.traffic, key
    from harness.check import NUMBERS
    compared = set(cell.limits) - {"readings"}
    assert compared <= set(NUMBERS) and {"state_gap", "ok_mismatch"} <= compared
    assert cell.limits["ok_mismatch"] == 0
    assert {m["name"] for m in cell.end_to_end} == {
        "solves_per_s", "tick_p95_ms", "setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", names)) <= names
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(spec.reader(metric["name"]))


def test_kernels_resolve():
    mods = spec.kernels()
    assert {m.SYMBOL for m in mods} == {
        "ipm_kernel", "assembly_kernel", "eval_kernel", "kin_kernel",
        "admm_kernel"}
    from refmpcc.system import HUSKY_PANDA, PANDA
    for m in mods:
        for sy in (PANDA, HUSKY_PANDA):
            nbytes, flops = m.work(sy, 64, 2, 500.0)
            assert nbytes > 0 and flops > 0
