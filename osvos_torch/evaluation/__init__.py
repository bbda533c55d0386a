"""Inference with PNG output, and the DAVIS J/F evaluation."""
