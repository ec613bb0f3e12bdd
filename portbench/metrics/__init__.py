"""Per-layer metric readers, one module per base name (the metric's name up
to its first dot): ``read(ctx)`` returns the value, or None where the run
gives it nothing to read."""
