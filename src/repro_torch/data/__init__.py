"""Deterministic synthetic data (numpy only)."""

from repro_torch.data import synthetic
from repro_torch.data.synthetic import paper_dataset, paper_dataset_names

__all__ = ["synthetic", "paper_dataset", "paper_dataset_names"]
