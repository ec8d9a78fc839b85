"""The harness: files found by name, weights, traffic, counts, traces."""
