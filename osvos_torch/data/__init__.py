"""Synthetic frames for checks and benchmarks."""
