"""Kernel launches in the profiled stretch's trace over its frames."""


def read(rec):
    t = rec.get("trace")
    return t["launches"] / t["frames"] if t and t["frames"] else None
