"""The statistics of the end-to-end metrics."""

from __future__ import annotations

import numpy as np


def percentile(values, p: float) -> float:
    """The p-th percentile of all `values`, linear between the closest
    ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), p))


def rate(count: int, seconds: float) -> float:
    """`count` over the whole of `seconds`."""
    return count / seconds
