"""Plain PyTorch references of the benchmark's configurations (NCHW,
functional, over flat state dicts in the reference repositories' key
layout), frozen here from the port's test oracles with the VGG layer
tables inlined.  They import nothing of the port or of JAX."""
