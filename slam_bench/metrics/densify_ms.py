"""Mean of the program's `add/densify` stage a frame, stage-timed frames."""


def read(rec):
    ms = rec.get("stages", {}).get("add/densify")
    return sum(ms) / len(ms) if ms else None
