"""The card's idle time while the host tracks, a frame: the profiled
stretch's idle gaps that began inside the benchmark's `tracking/icp` span
(the tracker's `tracking` call: ICP, the readback and, with the feature
backend, its host work), over the stretch's frames, in ms."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["frames"]:
        return None
    return 1000.0 * dict(t["idle_gaps"]).get("tracking/icp", 0.0) / t["frames"]
