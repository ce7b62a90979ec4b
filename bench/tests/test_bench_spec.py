"""The benchmark finds its pieces by name, and BENCHMARK.json keeps to
the contract the harness is built on."""

import json
import re

import pytest

from bench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_configs_traffic_and_limits_are_found_by_name(bench):
    for w in bench["workloads"]:
        assert spec.config(w["config"])["name"] == w["config"]
        assert spec.traffic(w["traffic"])["runner"] in ("stream", "engine")
        assert set(spec.limits(w["name"])) >= {"spike_gap", "mismatches"}
        assert spec.limits(w["name"])["mismatches"] == 0


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_missing_pieces_raise(bench):
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", bench)
    with pytest.raises(FileNotFoundError):
        spec.config("no_such_config")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_metrics_of_a_cell_follow_the_workloads_key(bench):
    names = {m["name"] for m in spec.metrics_of("ext4case.engine",
                                                "end_to_end", bench)}
    assert names == {"experiments_per_s", "result_p95_s", "setup_s"}
    names = {m["name"] for m in spec.metrics_of("fullbp.sweep", "per_layer",
                                                bench)}
    assert "exchange_roofline" in names
    assert "merge_pack_roofline.stream" not in names


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        names.append(w["name"])
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
