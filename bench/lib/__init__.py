"""The harness: spec files, the program adapter, the load loops, tracing and the check."""
