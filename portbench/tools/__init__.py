"""tools of the benchmark, found by name."""
