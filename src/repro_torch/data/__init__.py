"""Deterministic, seekable synthetic data (no dataset files are needed)."""
