"""The data layer: deterministic synthetic data (the bigram token streams
and the paper's datasets) and coreset-based data selection."""

from repro_torch.data import selection, synthetic
from repro_torch.data.selection import (Selection, embed_examples,
                                        gather_selected, select_coreset)
from repro_torch.data.synthetic import (BigramLM, paper_dataset,
                                        paper_dataset_names)

__all__ = ["selection", "synthetic", "Selection", "embed_examples",
           "gather_selected", "select_coreset", "BigramLM", "paper_dataset",
           "paper_dataset_names"]
