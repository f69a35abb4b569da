"""One reader a metric, found by the metric's name: `read(rec)` returns
the metric's value from the run's records, or None where the run has
nothing to read for it."""
