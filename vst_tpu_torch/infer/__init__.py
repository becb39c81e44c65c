"""Inference entry points of the port (the ReCoNet family and AdaAttN)."""
