"""counts of the benchmark, found by name."""
