"""The comparison has to refuse (a) the control, the reference in
bfloat16 put in the program's place, and (b) the run driven end to end
with the timed path broken underneath: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. (The cells run on one chip, so no exchange between chips
exists to leave out.)"""
import pytest

from simbench import harness
from simbench.reference import compare
from simbench.tests import tiny


def _over(numbers, limits):
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("make", [tiny.paper, tiny.production], ids=["paper", "production"])
def test_control_in_bfloat16_is_refused(make):
    cell = make()
    run = harness.Run(cell, "cpu")
    key = harness.study_key(11, 0)
    jobs = harness.reference_jobs(run, key, 11, 16, 16)
    want = harness.run_reference(jobs, "cpu", 1)
    for _, _, kw in jobs:
        kw["precision"] = "bfloat16"
    ctl = harness.run_reference(jobs, "cpu", 1)
    numbers = compare.compare(ctl, want)
    assert _over(numbers, cell.traffic["limits"]), numbers


def _broken(monkeypatch, how):
    from repro_torch.core import simulator as sim

    real = sim.protocol_step

    def step(state, setup, decision=None):
        new, out = real(state, setup, decision)
        if how == "unchanged":
            return state, out
        if how == "half":  # rows of the second half keep their state
            half = state.t.shape[0] // 2
            return type(new)(*[
                None if a is None else _keep_rows(a, b, half)
                for a, b in zip(new, state)]), out
        if how == "answer":
            return new, out._replace(forks=out.forks + (state.t == 20).int())
        if how == "theta":
            return new, out._replace(theta_mean=out.theta_mean * 1.01)
        raise ValueError(how)

    monkeypatch.setattr(sim, "protocol_step", step)


def _keep_rows(new, old, half):
    import torch

    if isinstance(new, torch.Tensor):
        out = new.clone()
        out[half:] = old[half:]
        return out
    return type(new)(*[None if a is None else _keep_rows(a, b, half) for a, b in zip(new, old)])


@pytest.mark.parametrize("how", ["unchanged", "half", "answer", "theta"])
@pytest.mark.parametrize("make", [tiny.paper, tiny.production], ids=["paper", "production"])
def test_broken_timed_path_is_refused(monkeypatch, how, make):
    from repro_torch.api import plan as plan_mod

    plan_mod.clear_cache()
    _broken(monkeypatch, how)
    cell = make()
    rec = harness.run_cell(cell, 2**31 + 7, 0.0, False, "cpu", 0.0, log=lambda m: None)
    plan_mod.clear_cache()
    assert _over(rec["compared"], cell.traffic["limits"]), rec["compared"]
