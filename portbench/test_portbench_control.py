"""The comparison fails what it should: the control (the reference in the
program's place with TF32 products) and the timed path broken underneath
in each way a clustering cell can break (:mod:`portbench.faults`). Each
broken run goes through the harness as a run does, past its look for a
card."""
import json
from pathlib import Path

import pytest
import torch

from portbench import check, control, faults
from portbench import run as harness

LIMITS = Path(__file__).parent / "limits"
CELLS = ["kmeans-bigcross", "kmedian-census1990"]
OBJECTIVE = {"kmeans-bigcross": "kmeans", "kmedian-census1990": "kmedian"}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, small):
    limits = json.loads((LIMITS / f"{workload}.json").read_text())
    seeds = [2_000_000_201, 2_000_000_202, 2_000_000_203]
    rows = list(control.readings(workload, [], seeds, torch.device("cpu"),
                                 overrides=small))
    assert len(rows) == 3
    for row in rows:
        assert row["correct"] is False, row
        assert not check.verdict(row["numbers"], limits), row


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(fault, workload, small):
    with faults.planted(fault, OBJECTIVE[workload]):
        out, _ = harness.run_cell(workload, 2_000_000_301, 0.2, False,
                                  torch.device("cpu"), overrides=small)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_each_fault_as_not_correct(fault, workload, small):
    rows = list(control.readings(workload, [], [], torch.device("cpu"),
                                 overrides=small, faults=[fault],
                                 fault_seeds=[2_000_000_401]))
    assert [r["side"] for r in rows] == [f"fault:{fault}"]
    assert rows[0]["correct"] is False, rows[0]


@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_on_one_site_fails_its_own_centres_cost(workload, small):
    limits = json.loads((LIMITS / f"{workload}.json").read_text())
    rows = list(control.readings(workload, [], [], torch.device("cpu"),
                                 overrides=small, faults=["one_site_cost"],
                                 fault_seeds=[2_000_000_501]))
    numbers = rows[0]["numbers"]
    over = {n for n in limits if numbers[n] > limits[n]}
    assert "local_cost_eval_gap" in over, numbers
    assert not over & {"local_cost_median_gap", "local_cost_sites_off"}, over


@pytest.mark.parametrize("workload", CELLS)
def test_the_unbroken_path_is_correct(workload, small):
    out, _ = harness.run_cell(workload, 2_000_000_301, 0.2, False,
                              torch.device("cpu"), overrides=small)
    assert out["correct"] is True, out["checks"]
