"""Deterministic synthetic data (numpy only)."""
