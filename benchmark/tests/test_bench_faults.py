"""The check fails a broken program: a run driven on the CPU at a tiny
size, the harness's look for a card skipped, with the program's timed path
broken underneath, reads ``correct`` false; and so does the control, the
reference in bfloat16 in the program's place. One card: no exchange
between cards to leave out."""

import dataclasses
import json

import pytest
import torch

import tiny
import run

CELLS = [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _unchanged(monkeypatch):
    import tike_tpu_torch.ptycho.ptycho as recon

    epoch = recon._epoch_math

    def step(plan, data, idx, mask, real, order, state, *args, **kwargs):
        return epoch(plan, data, idx, mask, real, order, dataclasses.replace(state), *args, **kwargs)

    monkeypatch.setattr(recon, "_epoch_math", step)


def _half_batch(monkeypatch):
    from tike_tpu_torch.ptycho.solvers import epoch

    batch = epoch._batch_update_math

    def half(plan, data_n, idx_n, mask_n, real_n, *args, **kwargs):
        keep = (torch.arange(mask_n.shape[0], device=mask_n.device) < mask_n.shape[0] // 2).to(mask_n.dtype)
        mask_n = mask_n * keep
        return batch(plan, data_n, idx_n, mask_n, real_n[: int(keep.sum())], *args, **kwargs)

    monkeypatch.setattr(epoch, "_batch_update_math", half)


def _altered(monkeypatch):
    import tike_tpu_torch.ptycho.ptycho as recon

    epoch = recon._epoch_math

    def step(plan, data, idx, mask, real, order, state, *args, **kwargs):
        out = epoch(plan, data, idx, mask, real, order, state, *args, **kwargs)
        psi = state.psi.clone()
        psi[0, psi.shape[-2] // 2, psi.shape[-1] // 2] = 0
        state.psi = psi
        return out

    monkeypatch.setattr(recon, "_epoch_math", step)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_program_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run.run(tiny.spec(workload), 2**31 + 3, 0.2, False, device="cpu")
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, seed):
    spec = tiny.spec(workload)
    session = spec["family"].setup(spec["config"], spec["traffic"], seed, "cpu", spec["limits"])
    session.close()
    assert session.check(control=True)["correct"] is False
