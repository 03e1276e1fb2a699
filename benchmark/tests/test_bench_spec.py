"""The harness finds every configuration, traffic mix, limit and metric by
name, and ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re

import pytest

import tiny
import run

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline_pct") or m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_are_whole():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert w["name"].startswith(w["config"] + ".")


@pytest.mark.parametrize("workload", CELLS)
def test_harness_finds_the_cell_by_name(workload):
    spec = run.load_spec(workload)
    assert spec["family"].__name__ == "families." + spec["config"]["family"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for name, reader in spec["readers"].items():
        assert reader.__name__ == f"metrics.{name}" and callable(reader.read)
    assert set(spec["limits"]) >= {"cost_gap", "state_gap"}
    entry = next(c for c in BENCH["configs"] if c["name"] == spec["cell"]["config"])
    assert entry["file"].startswith("benchmark/configs/")
    assert spec["config"]["reduced"] == entry["reduced"]


def test_run_names_no_cell():
    source = (tiny.HERE / "run.py").read_text()
    for w in BENCH["workloads"]:
        assert w["name"] not in source and w["config"] not in source


@pytest.mark.parametrize("workload", CELLS)
def test_traffic_builds_valid_parameters(workload):
    import tike_tpu_torch.ptycho as tp

    spec = tiny.spec(workload)
    family = spec["family"]
    inputs = family.make_inputs(spec["config"], 5, "cpu")
    params = family.parameters(inputs, spec["traffic"])
    assert params.algorithm_options.num_batch == spec["traffic"]["options"]["num_batch"]
    assert (params.position_options is None) == (spec["traffic"]["position_options"] is None)
    assert (params.eigen_weights is None) == (spec["config"]["eigen_probes"] == 0)
    with tp.Reconstruction(inputs["data"], params, device="cpu", random_seed=spec["config"]["cluster_seed"]) as context:
        assert context._fused_eligible()
