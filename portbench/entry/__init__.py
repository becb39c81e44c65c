"""The port's public entry points for each configuration, found by name."""
