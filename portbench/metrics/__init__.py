"""One reader per metric: ``read(run) -> float | None`` (None: nothing to
read in this run, and the metric is left out of the result line)."""
