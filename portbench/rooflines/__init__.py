"""The frozen byte and operation counts of the benchmark's kernels, and the
card's published peaks (`counts`)."""
