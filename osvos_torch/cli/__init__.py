"""Command-line entry points of the port (``python -m osvos_torch.cli.<name>``)."""
