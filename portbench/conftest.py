"""Shared pieces of the benchmark's CPU tests: a small cell of the same
shape as the configurations (sites on a grid, weighted partition, t = 3 k
sites), and one torch thread so parallel test workers do not contend."""
import pytest
import torch

SMALL = {"n": 20000, "d": 8, "k": 4, "sites": 9,
         "topology": {"kind": "grid", "rows": 3, "cols": 3}, "t": 108,
         "lloyd_iters": 3}


@pytest.fixture
def small():
    torch.set_num_threads(1)
    return dict(SMALL)
