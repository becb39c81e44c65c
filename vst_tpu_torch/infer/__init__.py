"""Inference entry points of the port (the ReCoNet family, RTNSTV and
AdaAttN)."""
