"""drivers of the benchmark, found by name."""
