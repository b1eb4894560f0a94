"""The harness's result line and the files it finds by name."""
import json
from pathlib import Path

import pytest
import torch

from portbench import check
from portbench import run as harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


E2E = {"kmeans-bigcross": "clustering_s",
       "kmedian-census1990": "clustering_s.kmedian"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(E2E))
def test_result_line_has_its_keys(workload, trace, small):
    out, extra = harness.run_cell(workload, 3_000_000_007, 0.3, bool(trace),
                                  torch.device("cpu"), overrides=small)
    # set-up by stage, and no kernels built on the CPU
    assert {"torch_import_s", "harness_s", "program_import_s", "data_s",
            "warmup_s"} <= set(
        extra["setup"])
    assert extra["compiled"] is False
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(out) == keys + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    device = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == (device | {"busy_s", "window_s"}
                                  if trace else device)
    mine = {m["name"] for m in BENCH["per_layer"]
            if workload in m["workloads"]}
    if trace:
        # on the CPU only the phase times are there to read
        assert set(out["metrics"]) <= mine
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {E2E[workload], "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["checks"]) == set(json.loads(
        (ROOT / "portbench" / "limits" / f"{workload}.json").read_text()))
    json.dumps(out)


def test_without_a_card_main_exits_1_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "kmeans-bigcross", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc == 1 and capsys.readouterr().out == ""


def test_every_name_has_its_file():
    bench = ROOT / "portbench"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader(m["name"]), m["name"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads(
            (bench / "limits" / f"{w['name']}.json").read_text())
        assert set(limits) <= set(check.NUMBERS)
