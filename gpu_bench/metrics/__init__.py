"""One reader per metric: ``read(ctx) -> float | None`` (None: nothing to
read in this cell, and the metric is left out of the result)."""
