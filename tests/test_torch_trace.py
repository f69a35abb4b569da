"""The port's span recorder (`dqo_map_tpu_torch/utils/trace.py`) on the
CPU.

Runs of `SLAMSystem.step` over synthetic frames at 64x48 with 3 Adam
steps on every 2nd frame (so local scans, the keyframe scan and the model
renders all run): `FEATURES`, four frames with the feature backend in
loose sync every 2nd frame, frame 3 a keyframe; `OBJECTS`, four frames
with ICP alone in strict sync and the MODE=1 object layer, as the
benchmark's office0-explore cell runs it, frames 1 and 3 keyframes (frame
1's refines an object seen twice); and `ORB_LOOSE`, seven frames with the
feature backend, loose sync every 6th frame and the object layer, as the
benchmark's office0-orb-loose cell runs it (its loop search on frame 5).
The recorder is checked in its three states:

- off: nothing is recorded and `torch.profiler.record_function` is never
  called (it raises here);
- on, under a CPU-only `torch.profiler.profile`: every program span nests
  in its frame's `system/step#<frame id>` span, `scans/step` and its three
  phases appear once per Adam step of every scan, each scan has its
  `prepare`, every host-read site on the path has its `/wait` span, and
  an op enters its wait span once for each of its reads; the feature
  backend's four spans nest in the tracker's span, and loose sync waits
  only at the end of every `sync_tracker2mapper_frames`-th frame;
- staged: the JAX tags, each recorded as often as the Mapping's own
  counts say, and the staged readings (densification's KNN, both scans
  and the keyframe scan's steps, each with its steps and how they ran,
  the object refinement), and no reading of a step or wait span.
"""

import json

import pytest
import torch

from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from dqo_map_tpu_torch.models import gaussian_map as gm
from dqo_map_tpu_torch.slam.system import SLAMSystem
from dqo_map_tpu_torch.utils import trace

W, H, FRAMES, ITERS = 64, 48, 4, 3
BASE = dict(
    type="Synthetic", use_gt_pose=False, capacity=8192, add_capacity=2048,
    uniform_sample_num=1200, gaussian_update_frame=2,
    gaussian_update_iter=ITERS, stable_confidence_thres=2,
    global_keyframe_num=3, min_depth=0.1, max_depth=8.0, memory_length=5,
    keyframe_theta_thes=2.5, keyframe_trans_thes=10.0, initial_bucket=8192)
FEATURES = dict(BASE, use_orb_backend=True, use_object=False,
                sync_tracker2mapper_method="loose",
                sync_tracker2mapper_frames=2)
OBJECTS = dict(BASE, use_orb_backend=False, use_object=True,
               sync_tracker2mapper_method="strict", keyframe_theta_thes=1.0)
ORB_LOOSE = dict(BASE, use_orb_backend=True, use_object=True,
                 sync_tracker2mapper_method="loose",
                 sync_tracker2mapper_frames=6, keyframe_theta_thes=1.0)
RUNS = {"features": FEATURES, "objects": OBJECTS, "orb_loose": ORB_LOOSE}
N_FRAMES = {"features": FRAMES, "objects": FRAMES, "orb_loose": 7}
KEYFRAMES = {"features": [0, 3], "objects": [0, 1, 3],
             "orb_loose": [0, 1, 3, 5]}
BACKEND_SPANS = ("tracking/backend/detect", "tracking/backend/match",
                 "tracking/backend/fuse", "tracking/backend/loop")
PREFIXES = ("tracking", "mapping", "scans", "render", "objects")

# the wait spans of the host-read sites each run's frames pass through:
# a layer's own under its path, an op's under its name
WAITS_BOTH = {
    "bin_gaussians/wait", "render_inputs/upload/wait", "mapping/counts/wait",
    "make_new_points/wait", "scales_from_knn/wait",
    "mapping/add/densify/wait", "add_points/wait",
    "mapping/sync/wait", "scans/local/prepare/gather/wait",
    "scans/keyframe/prepare/gather/wait",
    "scans/keyframe/prepare/touched/wait",
    "scans/keyframe/prepare/tiles/wait", "tracking/pose/upload/wait"}
WAITS_OBJECTS = {"mapping/obj_ids/wait", "objects/upload/wait",
                 "refine_objects/wait", "project_bbox/wait",
                 "objects/readback/wait"}
WAITS = {
    "features": WAITS_BOTH | {"tracking/icp/readback/wait"},
    "objects": WAITS_BOTH | WAITS_OBJECTS | {
        "tracking/sync/wait", "tracking/icp/residual/wait",
        "tracking/pose/wait"},
    "orb_loose": WAITS_BOTH | WAITS_OBJECTS | {"tracking/icp/readback/wait"},
}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    trace.enable(False)
    trace.stage_times(reset=True)
    trace.span_readings(reset=True)
    yield
    trace.enable(False)
    trace.stage_times(reset=True)
    trace.span_readings(reset=True)


def _run(name, save_path) -> SLAMSystem:
    _, cams = synthetic_sequence(N_FRAMES[name], width=W, height=H,
                                 with_detections=RUNS[name]["use_object"])
    system = SLAMSystem(default_config(save_path=str(save_path), **RUNS[name]),
                        cameras=cams, device="cpu")
    for i, cam in enumerate(cams):
        system.step(cam, i)
        system.mapping.time += 1
    m = system.mapping
    assert m.scan_counts["local"] > 0 and m.scan_counts["global"] > 0
    assert m.keyframe_ids == KEYFRAMES[name]
    return system


def test_off_records_nothing_and_calls_no_profiler(tmp_path, monkeypatch,
                                                   one_thread):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for name in RUNS:
        _run(name, tmp_path / name)
    assert trace.stage_times() == {} and trace.span_readings() == {}


@pytest.fixture(scope="module", params=sorted(RUNS))
def traced(request, tmp_path_factory, one_thread):
    """(run name, the run's system, its spans as (name, start, end)) of one
    run with the recorder on under the CPU profiler."""
    from torch.profiler import ProfilerActivity, profile
    name = request.param
    path = tmp_path_factory.mktemp(name)
    trace.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            system = _run(name, path)
    finally:
        trace.enable(False)
    out = path / "trace.json"
    prof.export_chrome_trace(str(out))
    ev = json.loads(out.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in ev if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    return name, system, spans


def test_on_every_span_nests_in_its_frame(traced):
    name, _, spans = traced
    frames = [s for s in spans if s[0].startswith("system/step#")]
    assert sorted(int(n.split("#")[1]) for n, _, _ in frames) == list(
        range(N_FRAMES[name]))
    frames.sort(key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(frames, frames[1:]))
    program = [s for s in spans if s[0].split("/")[0] in PREFIXES
               or s[0].endswith("/wait")]
    assert len(program) > 100
    for name, s, e in program:
        assert any(fs <= s and e <= fe for _, fs, fe in frames), name


def _frame_of(spans, s, e):
    """The id of the frame whose span holds [s, e]."""
    for n, fs, fe in spans:
        if n.startswith("system/step#") and fs <= s and e <= fe:
            return int(n.split("#")[1])
    raise AssertionError("outside every frame")


def test_on_backend_spans_nest_in_tracking(traced):
    name, system, spans = traced
    got = {b: [(s, e) for n, s, e in spans if n == b] for b in BACKEND_SPANS}
    be = system.tracker.pose_backend
    if be is None:
        assert not any(got.values())
        return
    n = N_FRAMES[name]
    # detection and matching on every frame (frame 0 primes the feature
    # tracker), the policy on every tracked frame, the loop search on every
    # LOOP_EVERY-th tracked frame
    assert len(got["tracking/backend/detect"]) == n
    assert len(got["tracking/backend/match"]) == n
    assert len(got["tracking/backend/fuse"]) == n - 1 == sum(
        be.source_counts.values())
    assert [_frame_of(spans, s, e) for s, e in got["tracking/backend/loop"]
            ] == list(range(be.LOOP_EVERY, n, be.LOOP_EVERY))
    tracking = [(s, e) for n_, s, e in spans if n_ == "tracking/icp"]
    for b, ivs in got.items():
        for s, e in ivs:
            assert any(a <= s and e <= z for a, z in tracking), b


def test_on_sync_waits_follow_the_mode(traced):
    """strict waits at the end of tracking and of mapping on every frame;
    loose only at the end of every `sync_tracker2mapper_frames`-th."""
    name, _, spans = traced
    n, cfg = N_FRAMES[name], RUNS[name]

    def frames_with(wait):
        return sorted(_frame_of(spans, s, e) for w, s, e in spans if w == wait)

    if cfg["sync_tracker2mapper_method"] == "strict":
        assert frames_with("mapping/sync/wait") == list(range(n))
        assert frames_with("tracking/sync/wait") == list(range(n))
    else:
        k = cfg["sync_tracker2mapper_frames"]
        assert frames_with("mapping/sync/wait") == [
            i for i in range(n) if (i + 1) % k == 0]
        assert frames_with("tracking/sync/wait") == []


def test_on_a_step_span_per_adam_step(traced):
    _, system, spans = traced
    names = [n for n, _, _ in spans]
    iters = system.mapping.scan_counts["iters"]
    assert iters == ITERS * (system.mapping.scan_counts["local"]
                             + system.mapping.scan_counts["global"])
    for n in ("scans/step", "scans/step/forward", "scans/step/backward",
              "scans/step/adam"):
        assert names.count(n) == iters, n
    # each step's phases inside it
    steps = [(s, e) for n, s, e in spans if n == "scans/step"]
    for n, s, e in spans:
        if n.startswith("scans/step/"):
            assert any(a <= s and e <= b for a, b in steps), n
    # each scan prepares, the local one merges
    for kind in ("local", "keyframe"):
        scans = [(s, e) for n, s, e in spans if n == f"scans/{kind}"]
        assert len(scans) == system.mapping.scan_counts[
            "local" if kind == "local" else "global"]
        for a, b in scans:
            assert any(n == f"scans/{kind}/prepare" and a <= s and e <= b
                       for n, s, e in spans)
    assert names.count("scans/local/merge") == system.mapping.scan_counts[
        "local"]
    assert names.count("scans/keyframe/scan") == system.mapping.scan_counts[
        "global"]


def test_on_every_host_read_site_has_its_wait_span(traced):
    name, system, spans = traced
    waits = {n for n, _, _ in spans if n.endswith("/wait")}
    assert WAITS[name] <= waits, sorted(WAITS[name] - waits)
    # each binning reads its layout size once, in its own span
    binnings = sum(n == "bin_gaussians/wait" for n, _, _ in spans)
    assert binnings >= N_FRAMES[name]
    # a wait span holds no span of its own
    for n, s, e in spans:
        if n.endswith("/wait"):
            assert not any(s < s2 and e2 < e for n2, s2, e2 in spans
                           if n2 != n and (n2.split("/")[0] in PREFIXES
                                           or n2.endswith("/wait"))), n


class Entered:
    """`torch.profiler.record_function` that notes each span's name."""

    seen: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.seen.append(self.name)

    def __exit__(self, *exc):
        return False


@pytest.fixture
def entered(monkeypatch):
    Entered.seen = []
    monkeypatch.setattr(torch.profiler, "record_function", Entered)
    trace.enable(True)
    yield Entered.seen
    trace.enable(False)


def test_on_compact_names_its_wait(entered):
    gm.compact(gm.empty_map(64, "cpu"))
    # the two nonzero's and the count: one span a read
    assert entered == ["compact/wait"] * 3


@pytest.mark.parametrize("site", ["add_points", "render_inputs_host",
                                  "render_inputs_device"])
def test_on_each_read_has_its_own_wait_span(entered, site):
    if site == "add_points":
        new = gm.make_new_points(torch.rand(40, 3), torch.rand(40, 3),
                                 torch.rand(40, 3), torch.rand(40) > 0.3,
                                 0, 0, 0.1, (1.0, 1.0, 1.0))
        gm.add_points(gm.empty_map(64, "cpu"), new)
        # the slots, the count, and the 13 fields' masked gathers
        assert entered == ["add_points/wait"] * 15
        return
    _, cams = synthetic_sequence(1, width=W, height=H)
    cam = cams[0]
    if site == "render_inputs_device":
        cam.set_pose_device(torch.as_tensor(cam.c2w, dtype=torch.float32),
                            None)
        entered.clear()
        cam.render_inputs("cpu")
        assert entered == ["render_inputs/upload/wait",
                           "render_inputs/inverse/wait",
                           "render_inputs/upload/wait"]
    else:
        cam.render_inputs("cpu")
        assert entered == ["render_inputs/upload/wait"] * 4


def test_staged_tags_and_readings(tmp_path, one_thread):
    trace.profile_enable(True)
    try:
        system = _run("objects", tmp_path)
    finally:
        trace.profile_enable(False)
    tags = {k: len(v) for k, v in trace.stage_times(reset=True).items()}
    m = system.mapping
    scans = m.scan_counts["local"] + m.scan_counts["global"]
    assert tags["tracker"] == tags["gaussians_add"] == FRAMES
    assert tags["add/densify"] == tags["finalize(fix+err+del)"] == FRAMES
    assert tags[f"local/optimize_scan x{ITERS}"] == m.scan_counts["local"]
    assert tags["global_optimization"] == m.scan_counts["global"]
    assert tags["get_render_output"] == scans
    assert tags["render/_render_global"] == m.renders
    assert not any(t.startswith(("scans/", "tracking/", "objects/"))
                   or t.endswith("/wait") for t in tags)
    readings = trace.span_readings(reset=True)
    assert set(readings) == {"mapping/add/densify/knn", "scans/local",
                             "scans/keyframe", "scans/keyframe/scan",
                             "objects/refine"}
    assert len(readings["mapping/add/densify/knn"]) == FRAMES
    # each scan's steps and how they ran: on the CPU every one eagerly
    for name, kind in (("scans/local", "local"), ("scans/keyframe", "global"),
                       ("scans/keyframe/scan", "global")):
        assert readings[name] == [
            {"ms": r["ms"], "steps": ITERS, "eager_steps": ITERS,
             "graph_captures": 0, "graph_replays": 0}
            for r in readings[name]], name
        assert len(readings[name]) == m.scan_counts[kind], name
    assert len(readings["objects/refine"]) >= 1
    assert all(r["ms"] >= 0 for v in readings.values() for r in v)
    assert trace.stage_times() == {} and trace.span_readings() == {}


def test_count_adds_to_every_open_staged_span():
    trace.count(steps=1)                    # off: nothing to add to
    trace.profile_enable(True)
    try:
        with trace.span("scans/keyframe", staged=True, steps=2):
            with trace.span("scans/step"):  # no reading of its own
                with trace.span("scans/keyframe/scan", staged=True):
                    trace.count(steps=3, graph_replays=1)
            trace.count(graph_replays=2)
        trace.count(steps=5)                # no staged span open
    finally:
        trace.profile_enable(False)
    got = {k: [{c: n for c, n in r.items() if c != "ms"} for r in v]
           for k, v in trace.span_readings(reset=True).items()}
    assert got == {"scans/keyframe": [{"steps": 5, "graph_replays": 3}],
                   "scans/keyframe/scan": [{"steps": 3, "graph_replays": 1}]}
    trace.enable(True)
    try:
        with trace.span("scans/local", staged=True):
            trace.count(steps=1)            # on: the trace holds the spans
    finally:
        trace.enable(False)
    assert trace.span_readings() == {}


@pytest.mark.parametrize("name", BACKEND_SPANS)
def test_off_backend_span_is_one_flag_test(name):
    assert trace.span(name, tag="tracker/feature_loop",
                      wait_end=False) is trace._NULL
    trace.profile_enable(True)
    try:
        # staged, a span without a tag records nothing either
        assert trace.span(name) is trace._NULL
    finally:
        trace.profile_enable(False)


def test_staged_backend_tags(tmp_path, one_thread):
    """The feature backend's stages, staged: detection, the pose readback
    and the fusion on every tracked frame, the loop search on every
    LOOP_EVERY-th, and no tag or reading of its named spans."""
    trace.profile_enable(True)
    try:
        system = _run("orb_loose", tmp_path)
    finally:
        trace.profile_enable(False)
    tags = {k: len(v) for k, v in trace.stage_times(reset=True).items()}
    n, be = N_FRAMES["orb_loose"], system.tracker.pose_backend
    assert tags["tracker"] == n
    for t in ("tracker/feature_detect", "tracker/pose_sync",
              "tracker/feature_backend"):
        assert tags[t] == n - 1, t
    assert tags["tracker/feature_loop"] == (n - 1) // be.LOOP_EVERY
    assert not any(t.startswith("tracking/") for t in tags)
    assert not any(r.startswith("tracking/")
                   for r in trace.span_readings(reset=True))


def test_staged_spans_wait_only_where_their_reading_needs_it(monkeypatch):
    waits = []
    monkeypatch.setattr(trace, "_sync", lambda: waits.append(1))
    trace.profile_enable(True)
    try:
        with trace.span("scans/step"), trace.span("bin_gaussians/wait"):
            pass
        assert waits == []
        with trace.span("tracking/icp/readback/wait",
                        tag="tracker/pose_sync", wait_end=False):
            pass
        assert waits == []
        with trace.span("mapping/add", tag="gaussians_add"):
            pass
        assert len(waits) == 1
        with trace.span("scans/keyframe/scan", staged=True, steps=4):
            pass
        assert len(waits) == 3
    finally:
        trace.profile_enable(False)
    assert trace.span_readings(reset=True)["scans/keyframe/scan"][0][
        "steps"] == 4
    assert set(trace.stage_times(reset=True)) == {"tracker/pose_sync",
                                                 "gaussians_add"}
