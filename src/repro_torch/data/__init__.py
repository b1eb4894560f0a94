"""The data layer: deterministic synthetic data (numpy only) and
coreset-based data selection."""

from repro_torch.data import selection, synthetic
from repro_torch.data.selection import (Selection, embed_examples,
                                        gather_selected, select_coreset)
from repro_torch.data.synthetic import paper_dataset, paper_dataset_names

__all__ = ["selection", "synthetic", "Selection", "embed_examples",
           "gather_selected", "select_coreset", "paper_dataset",
           "paper_dataset_names"]
