"""synth of the benchmark, found by name."""
