"""The harness: cells, traffic, the timed window, tracing and the checks."""
