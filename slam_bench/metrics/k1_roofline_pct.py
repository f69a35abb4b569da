"""K1's share of its roofline over the sampled launches of the profiled
stretch (`slam_bench/roofline.py`)."""


def read(rec):
    return rec.get("k1_roofline")
