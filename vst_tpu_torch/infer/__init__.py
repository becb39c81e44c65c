"""Inference entry points of the port (slice 1: ReCoNet family)."""
