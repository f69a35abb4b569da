"""The feature backend's host time a frame: the program's
`tracker/feature_detect` and `tracker/feature_backend` stages (detection,
matching, fusion and the loop search) summed over the stage-timed frames,
over those frames (the `tracker` stage, one a frame). None where the
program ran no backend."""


def read(rec):
    st = rec.get("stages", {})
    frames = len(st.get("tracker", []))
    parts = st.get("tracker/feature_detect", []) + st.get(
        "tracker/feature_backend", [])
    return sum(parts) / frames if frames and parts else None
