"""The 90th percentile of every window frame's latency, `step` called to
returned, in ms."""

from slam_bench.stats import percentile


def read(rec):
    lat = rec["latencies_s"]
    return 1000.0 * percentile(lat, 90) if lat else None
