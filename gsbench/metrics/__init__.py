"""One reader per metric, named as the metric: ``read(outcome)`` returns
the number, or None where the run gives it nothing to read (never 0 for a
share of a roofline or a peak)."""
