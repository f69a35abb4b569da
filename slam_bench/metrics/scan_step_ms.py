"""The local scan's time a step: each `local/optimize_scan x{iters}` stage
over its iterations, averaged over the stage-timed scans."""


def read(rec):
    per = []
    for tag, ms in rec.get("stages", {}).items():
        if tag.startswith("local/optimize_scan x"):
            iters = int(tag.rsplit("x", 1)[1])
            per += [m / iters for m in ms if iters > 0]
    return sum(per) / len(per) if per else None
