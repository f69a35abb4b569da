"""Mean of the program's `tracker` stage over the stage-timed frames."""


def read(rec):
    ms = rec.get("stages", {}).get("tracker")
    return sum(ms) / len(ms) if ms else None
