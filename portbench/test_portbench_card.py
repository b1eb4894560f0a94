"""The harness on the card at a small size (skips without one)."""
import pytest
import torch

from portbench import run as harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kmeans-bigcross",
                                      "kmedian-census1990"])
def test_a_small_cell_is_correct_on_the_card(workload, small):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, _ = harness.run_cell(workload, 2_000_000_077, 1.0, False,
                           torch.device("cuda", 0), overrides=small)
    assert out["correct"] is True, out["checks"]
