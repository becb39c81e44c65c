"""metrics of the benchmark, found by name."""
