"""The end-to-end metrics' statistics over every frame of a window."""

import numpy as np

from slam_bench import stats
from slam_bench.harness import read_metric


def test_p90_is_over_all_frames():
    lat = [0.1] * 90 + [1.0] * 10
    rec = {"latencies_s": lat, "frames": 100, "window_s": 20.0}
    # numpy's linear percentile over all 100 frames: rank 89.1
    assert read_metric("frame_ms_p90", rec) == 1000 * np.percentile(lat, 90)
    assert abs(read_metric("frame_ms_p90", rec) - 190.0) < 1e-9
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_fps_is_frames_over_the_whole_window():
    rec = {"frames": 57, "window_s": 19.0, "latencies_s": [0.3] * 57}
    assert read_metric("fps", rec) == 3.0 == stats.rate(57, 19.0)
    assert read_metric("fps", {"frames": 0, "window_s": 1.0,
                               "latencies_s": []}) is None


def test_stage_readers():
    rec = {"stages": {"tracker": [10.0, 20.0], "add/densify": [5.0],
                      "local/optimize_scan x50": [100.0, 200.0]}}
    assert read_metric("tracker_ms", rec) == 15.0
    assert read_metric("densify_ms", rec) == 5.0
    assert read_metric("scan_step_ms", rec) == 3.0
    assert read_metric("tracker_ms", {}) is None


def test_trace_readers():
    t = {"window_s": 2.0, "busy_s": 0.5, "frames": 4, "launches": 1000}
    assert read_metric("device_idle_pct", {"trace": t}) == 75.0
    assert read_metric("launches_per_frame", {"trace": t}) == 250.0
    assert read_metric("device_idle_pct", {"trace": dict(t, busy_s=0.0)}) \
        is None
