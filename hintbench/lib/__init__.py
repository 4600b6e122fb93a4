"""The benchmark's general harness: specs, traffic, weights, data, cells,
the trace, the work counts and the check."""
