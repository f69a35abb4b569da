"""The traced run's records: spans around the calls into each layer, the
profiler's device trace of a profiled stretch, and a named sample of the
blend kernels' launches.

The spans are the benchmark's own (`torch.profiler.record_function`
around the system's calls, installed on the one system the run drives);
the program's stage timers are off in the profiled stretch, since each of
their stages waits for the card. `read_trace` reduces a Chrome trace to
the device's busy intervals (their union, so that overlapping work counts
once), the kernels by name, and the idle gaps by the innermost span that
was open on the host when each gap began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

# (object attribute, method name, span name)
SPANS = (
    ("tracker", "map_preprocess", "tracking/preprocess"),
    ("tracker", "tracking", "tracking/icp"),
    ("mapping", "gaussians_add", "mapping/add"),
    ("mapping", "local_optimize", "scans/local"),
    ("mapping", "global_optimization", "scans/keyframe"),
    ("mapping", "get_render_output", "render/model"),
    ("mapping", "finalize_frame", "mapping/finalize"),
    ("object_layer", "process_frame", "objects/associate"),
    ("object_layer", "optimize_objects", "objects/refine"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K1_NAME, K2_NAME = "blend_fwd_kernel", "blend_bwd_kernel"
SAMPLE_EVERY = 8         # every 8th launch of each kernel is kept
SAMPLE_MAX = 6           # at most this many a kernel


def install_spans(system) -> list:
    """Wrap the methods of `SPANS` on the system's own objects in a span
    each; returns what `uninstall` restores."""
    undo = []
    for owner, meth, name in SPANS:
        obj = getattr(system, owner, None)
        if obj is None or not hasattr(obj, meth):
            continue
        fn = getattr(obj, meth)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)

        undo.append((obj, meth, obj.__dict__.get(meth)))
        setattr(obj, meth, wrapped)
    return undo


def uninstall(undo: list):
    for obj, meth, prev in reversed(undo):
        if prev is None:
            delattr(obj, meth)
        else:
            setattr(obj, meth, prev)


class LaunchSampler:
    """Wraps the blend kernels' launch functions (`blend_cuda.blend_fwd`,
    `blend_bwd`) while on: counts every launch in order and keeps the
    arguments of every `SAMPLE_EVERY`-th, `SAMPLE_MAX` at most, by
    reference (no copy and no wait inside the stretch). The pairs each
    sampled launch walks are counted afterwards by the frozen plain walk
    (`roofline.py`)."""

    def __init__(self, blend_cuda):
        self.mod = blend_cuda
        self.calls = {"k1": 0, "k2": 0}
        self.samples = {"k1": [], "k2": []}
        self._orig = {}

    def _wrap(self, key, fn):
        def launch(*args, **kw):
            i = self.calls[key]
            self.calls[key] += 1
            if i % SAMPLE_EVERY == 0 and len(self.samples[key]) < SAMPLE_MAX:
                self.samples[key].append((i, args, dict(kw)))
            return fn(*args, **kw)
        return launch

    def __enter__(self):
        for key, name in (("k1", "blend_fwd"), ("k2", "blend_bwd")):
            self._orig[name] = getattr(self.mod, name)
            setattr(self.mod, name, self._wrap(key, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.mod, name, fn)
        return False


def profile_stretch(step_frames, frames: int, on_card: bool) -> dict:
    """Run `step_frames(n)` under the profiler (host and device) and reduce
    its trace; the Chrome trace is written under the temporary directory
    and deleted once read."""
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("slam_bench/stretch"):
            step_frames(frames)
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return read_trace(trace, frames)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_trace(trace: dict, frames: int) -> dict:
    """The profiled stretch: its window (the `slam_bench/stretch` span),
    the device operations inside it by name and as busy intervals, the
    kernel launches, each blend kernel's launches in order, and the idle
    gaps by the innermost host span open at each gap's start. Times in
    seconds."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in ev if e.get("name") == "slam_bench/stretch"]
    if not win:
        raise RuntimeError("the trace has no stretch span")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    dev = [e for e in dev if t0 <= float(e["ts"]) <= t1]
    by_name, k1, k2 = {}, [], []
    for e in dev:
        d = float(e["dur"]) * 1e-6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
        if e.get("cat") == "kernel":
            if K1_NAME in e["name"]:
                k1.append((float(e["ts"]), d))
            elif K2_NAME in e["name"]:
                k2.append((float(e["ts"]), d))
    busy = _union((float(e["ts"]), min(t1, float(e["ts"]) + float(e["dur"])))
                  for e in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in ev if e.get("cat") == "user_annotation"
        and e.get("name", "").split("/")[0] in (
            "tracking", "mapping", "scans", "render", "objects"))
    starts = [s for s, _, _ in spans]
    gaps = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # the innermost span open at a: the latest-starting one covering it
        i = bisect.bisect_right(starts, a)
        tag = "host/other"
        for s, e, name in reversed(spans[max(0, i - 64):i]):
            if s <= a < e:
                tag = name
                break
        gaps[tag] = gaps.get(tag, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6, "busy_s": busy_s, "frames": frames,
        "launches": sum(1 for e in dev if e.get("cat") == "kernel"),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
        "k1": [d for _, d in sorted(k1)], "k2": [d for _, d in sorted(k2)],
    }
