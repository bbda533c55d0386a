"""Checkpoint reading and numeric-precision helpers."""
