"""The plain reference against the program on the CPU at a tiny size: its
forward model gives the input maker's data and the program's simulated
data, its patch pair is adjoint, and the inputs follow the seed alone."""

import json

import pytest
import torch

import tiny
from families import ptycho as family
from reference import ptycho as ref

CELLS = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.parametrize("workload", [w["name"] for w in CELLS])
def test_forward_model_gives_the_data(workload):
    import tike_tpu_torch.ptycho as tp

    spec = tiny.spec(workload)
    config = spec["config"]
    inputs = family.make_inputs(config, 9, "cpu")
    truth = family.true_object(config["object"], torch.Generator().manual_seed(9))
    data = tp.simulate_device(config["detector"], inputs["probe"], inputs["scan"], truth, device="cpu")
    assert torch.allclose(inputs["data"], data, rtol=1e-4, atol=1e-5 * float(data.max()))
    again = ref.intensity(truth[0], inputs["scan"], inputs["probe"][0, 0], config["detector"])
    assert torch.equal(again, inputs["data"])


def test_patch_pair_is_adjoint():
    gen = torch.Generator().manual_seed(3)
    image = torch.randn((40, 50), dtype=torch.complex64, generator=gen)
    pos = torch.rand((30, 2), generator=gen) * 30 + 1
    values = torch.randn((30, 8, 8), dtype=torch.complex64, generator=gen)
    left = torch.vdot(ref.extract(image, pos, 8).reshape(-1), values.reshape(-1))
    right = torch.vdot(image.reshape(-1), ref.insert(values, pos, (40, 50)).reshape(-1))
    assert abs(left - right) <= 1e-4 * abs(left)


@pytest.mark.parametrize("workload", [w["name"] for w in CELLS])
def test_inputs_follow_the_seed(workload):
    config = tiny.spec(workload)["config"]
    a = family.make_inputs(config, 2**31 + 1, "cpu")
    b = family.make_inputs(config, 2**31 + 1, "cpu")
    c = family.make_inputs(config, 4, "cpu")
    for key in a:
        if a[key] is None:
            continue
        assert torch.equal(a[key], b[key])
        assert a[key].shape == c[key].shape
    # Every seed the same positions; the object, and so the data, differ.
    assert torch.equal(a["scan"], c["scan"])
    assert not torch.equal(a["data"], c["data"])


@pytest.mark.parametrize("workload", [w["name"] for w in CELLS])
def test_one_batch_epochs_match_the_program(workload):
    """With one batch an epoch has a single step-size solve, and the
    reference follows the program to float32 rounding."""
    spec = tiny.spec(workload)
    spec["traffic"]["options"]["num_batch"] = 1
    session = family.setup(spec["config"], spec["traffic"], 31, "cpu", spec["limits"])
    session.close()
    numbers = session.check()
    assert numbers["cost_gap"]["value"] < 1e-5
    assert numbers["state_gap"]["value"] < 1e-4


def test_a_leaf_moved_by_round_off_is_left_out():
    import numpy as np

    start = {"psi": np.full((1, 4, 4), 0.5 + 0j), "scan": np.full((3, 2), 1000.0)}
    want = {"psi": start["psi"] + 0.1, "scan": start["scan"] + 1e-3, "costs": [1.0]}
    got = {"psi": want["psi"] + 1e-5, "scan": want["scan"] + 1e-4, "costs": [1.0]}
    numbers = family.compare([got], [want], start, {"cost_gap": 0, "state_gap": 1e-3})
    assert numbers["detail"]["left_out"] == ["scan@call1"]
    assert numbers["state_gap"]["value"] == pytest.approx(1e-4) and numbers["correct"]
    want["scan"] = start["scan"] + 1.0
    numbers = family.compare([got], [want], start, {"cost_gap": 0, "state_gap": 1e-3})
    assert numbers["detail"]["left_out"] == [] and not numbers["correct"]
