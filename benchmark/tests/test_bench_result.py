"""A run's result line, driven on the CPU at a tiny size (the harness's
look for a card skipped), and the refusal of a machine without a card."""

import json

import pytest
import torch

import tiny
import run

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contract_keys(trace):
    workload = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    spec = tiny.spec(workload)
    result = run.run(spec, 2**31 + 11, 0.3, trace, device="cpu")
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "check"
    for name, c in result["check"].items():
        assert set(c) >= {"value", "limit"}, name
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "step_s", "call_p95_s"} <= set(result["metrics"])
        assert result["attempted"] >= 1
    json.dumps(result)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    workload = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    assert run.main(["--workload", workload, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
