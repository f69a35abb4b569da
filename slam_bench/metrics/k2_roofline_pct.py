"""K2's share of its roofline over the sampled launches of the profiled
stretch (`slam_bench/roofline.py`)."""


def read(rec):
    return rec.get("k2_roofline")
