"""The plain reference is the program on the CPU: on a small cell the
port's CPU path and the reference draw the same seeds and samples and
give the same coreset, ledger and centres, and the judge reads ~0."""
import json
from pathlib import Path

import pytest
import torch

from portbench import check, data
from portbench import reference as ref
from portbench import run as harness
from portbench import threefry as tf


@pytest.mark.parametrize("objective", ["kmeans", "kmedian"])
def test_reference_is_the_program_on_the_cpu(objective, small):
    from repro_torch.core import distributed, prng, topology
    cfg = {**json.loads((Path(__file__).parent / "configs"
                         / "census1990-grid100.json").read_text()), **small}
    sites = data.make_sites(cfg, 2_000_000_123, torch.device("cpu"))
    n, edges = data.graph_edges(cfg["topology"])
    key = tf.fold_in(tf.PRNGKey(2_000_000_123), 5)
    assert torch.equal(key, prng.fold_in(prng.PRNGKey(2_000_000_123), 5))
    got = harness.as_output(distributed.graph_distributed_kmeans(
        key, sites.points, sites.mask, cfg["k"], cfg["t"],
        topology.Graph(n, tuple(edges)), objective=objective,
        lloyd_iters=cfg["lloyd_iters"], backend="torch", device="cpu"))
    want = ref.cluster(key, sites.points, sites.mask, cfg["k"], cfg["t"],
                       objective, cfg["lloyd_iters"], len(edges))
    assert torch.equal(got.cs_points, want.cs_points)
    torch.testing.assert_close(got.cs_weights, want.cs_weights,
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.local_costs, want.local_costs,
                               rtol=1e-5, atol=0.0)
    torch.testing.assert_close(got.centres, want.centres, rtol=1e-5,
                               atol=1e-5)
    assert got.ledger == want.ledger
    nums = check.judge(got, key, sites.points, sites.mask, cfg, objective,
                       len(edges))
    assert nums["alloc_miss"] == 0 and nums["ledger_miss"] == 0
    assert nums["draw_miss"] == 0.0
    assert max(nums["local_cost_gap"], nums["sample_weight_gap"],
               nums["centre_weight_gap"], nums["solve_gap"]) < 1e-5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0000002])
    got = ref.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]
