"""The benchmark's inputs: fixed site sizes and padding, data from the
seed, the grid's edges."""
import json
from pathlib import Path

import torch

from portbench import data

CONFIGS = sorted((Path(__file__).parent / "configs").glob("*.json"))


def test_sizes_and_padding_are_the_same_for_two_seeds(small):
    cfg = {**json.loads(CONFIGS[0].read_text()), **small}
    a = data.make_sites(cfg, 3_000_000_001, torch.device("cpu"))
    b = data.make_sites(cfg, 3_000_000_002, torch.device("cpu"))
    assert a.sizes == b.sizes and a.padded == b.padded
    assert torch.equal(a.mask, b.mask)
    assert not torch.equal(a.points, b.points)
    again = data.make_sites(cfg, 3_000_000_001, torch.device("cpu"))
    assert torch.equal(a.points, again.points)
    for s, size in enumerate(a.sizes):
        assert bool(a.mask[s, :size].all()) and not bool(a.mask[s, size:].any())
        assert not bool(a.points[s, size:].any())


def test_the_configurations_sizes():
    for path in CONFIGS:
        cfg = json.loads(path.read_text())
        sizes = data.site_sizes(cfg["n"], cfg["sites"], cfg["partition_seed"])
        assert sum(sizes) == cfg["n"] and min(sizes) >= 1
        assert len(sizes) == cfg["sites"]
        assert sizes == data.site_sizes(cfg["n"], cfg["sites"],
                                        cfg["partition_seed"])
        assert data.padded_rows(sizes, cfg["pad_multiple"]) % 8 == 0
        assert cfg["t"] == 3 * cfg["k"] * cfg["sites"]
        assert cfg["reduced"] == []


def test_grid_edges_are_the_programs():
    from repro_torch.core import topology
    n, edges = data.graph_edges({"kind": "grid", "rows": 10, "cols": 10})
    g = topology.grid(10, 10)
    assert n == g.n and tuple(edges) == g.edges and len(edges) == 180
