"""Metrics and checkpoints of the port."""
