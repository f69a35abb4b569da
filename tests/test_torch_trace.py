"""The port's span recorder (`dqo_map_tpu_torch/utils/trace.py`) on the
CPU.

Two runs of `SLAMSystem.step` over four synthetic frames at 64x48 with
3 Adam steps on every 2nd frame (so local scans, the keyframe scan and the
model renders all run): `FEATURES` with the feature backend in loose
sync, frame 3 a keyframe, as the stage-tag test runs it, and `OBJECTS`
with ICP alone in strict sync and the MODE=1 object layer, as the
benchmark's office0 cell runs it, frames 1 and 3 keyframes (frame 1's
refines an object seen twice). The recorder is checked in its three states:

- off: nothing is recorded and `torch.profiler.record_function` is never
  called (it raises here);
- on, under a CPU-only `torch.profiler.profile`: every program span nests
  in its frame's `system/step#<frame id>` span, `scans/step` and its three
  phases appear once per Adam step of every scan, each scan has its
  `prepare`, every host-read site on the path has its `/wait` span, and
  an op enters its wait span once for each of its reads;
- staged: the JAX tags, each recorded as often as the Mapping's own
  counts say, and the three staged readings (densification's KNN, the
  keyframe scan with its steps, the object refinement), and no reading of
  a step or wait span.
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
RUNS = {"features": FEATURES, "objects": OBJECTS}
KEYFRAMES = {"features": [0, 3], "objects": [0, 1, 3]}
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
WAITS = {
    "features": WAITS_BOTH | {"tracking/icp/readback/wait"},
    "objects": WAITS_BOTH | {
        "tracking/sync/wait", "tracking/icp/residual/wait",
        "tracking/pose/wait", "mapping/obj_ids/wait",
        "objects/upload/wait", "refine_objects/wait",
        "project_bbox/wait", "objects/readback/wait"},
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
    _, cams = synthetic_sequence(FRAMES, width=W, height=H,
                                 with_detections=name == "objects")
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
    _, _, spans = traced
    frames = [s for s in spans if s[0].startswith("system/step#")]
    assert sorted(int(n.split("#")[1]) for n, _, _ in frames) == list(
        range(FRAMES))
    frames.sort(key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(frames, frames[1:]))
    program = [s for s in spans if s[0].split("/")[0] in PREFIXES
               or s[0].endswith("/wait")]
    assert len(program) > 100
    for name, s, e in program:
        assert any(fs <= s and e <= fe for _, fs, fe in frames), name


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
    assert binnings >= FRAMES
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
    assert set(readings) == {"mapping/add/densify/knn", "scans/keyframe/scan",
                             "objects/refine"}
    assert len(readings["mapping/add/densify/knn"]) == FRAMES
    assert [r["steps"] for r in readings["scans/keyframe/scan"]] == [
        ITERS] * m.scan_counts["global"]
    assert len(readings["objects/refine"]) >= 1
    assert all(r["ms"] >= 0 for v in readings.values() for r in v)
    assert trace.stage_times() == {} and trace.span_readings() == {}


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
