"""Frames completed in the window over the window's wall time."""

from slam_bench.stats import rate


def read(rec):
    return rate(rec["frames"], rec["window_s"]) if rec["frames"] else None
