"""On a card, every synchronising call that `SLAMSystem.step` makes lies
in one of the port's wait spans (a name ending in `/wait`,
`utils/trace.py`), and each entry of a wait span holds at most one, so
that counting the wait spans entered counts the host's waits on the card
that the CUDA sync debug mode sees.

Six frames at 160x120 with 3 Adam steps on every 2nd frame, a keyframe
scan among them, in the benchmark's three configurations: ICP alone in
strict sync with the MODE=1 object layer (office0-explore's), ICP against
the model depth with the depth filter (fr1_desk's), and the feature
backend in loose sync every 6th frame with the object layer
(office0-orb-loose's: one readback of ICP's pose a tracked frame); and
office0-explore's with 8 steps a scan, so that every scan captures its
steps' CUDA graphs and replays them (`slam/mapper.py::GradsGraph`). They
run with the recorder on and under `torch.cuda.set_sync_debug_mode("warn")`;
each of the mode's warnings is caught with the spans open when it was
raised (the recorder's `record_function` wrapped to keep them, each entry
numbered), and the innermost must be a wait span that has not yet seen
one. The
census, wait span by wait span, is printed. The mode does not see an
event's wait (`HostCopy`) or `torch.cuda.synchronize`; both have their
wait spans all the same.

This file imports neither JAX nor the JAX package; on the card, run it
without the JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_wait_census.py -q -s

It needs a CUDA card (marker `cuda`) and skips without one.
"""

import collections
import itertools
import warnings

import pytest
import torch

FRAMES = 6
SYNC_WARNING = "called a synchronizing CUDA operation"
BASE = dict(
    type="Synthetic", use_gt_pose=False, use_orb_backend=False,
    capacity=16384, add_capacity=4096, uniform_sample_num=1000,
    gaussian_update_frame=2, gaussian_update_iter=3,
    stable_confidence_thres=2, global_keyframe_num=3, min_depth=0.1,
    max_depth=8.0, memory_length=5, keyframe_theta_thes=1.0,
    keyframe_trans_thes=10.0, sync_tracker2mapper_method="strict")
RUNS = {
    "objects": dict(BASE, use_object=True, icp_use_model_depth=False),
    "model_depth": dict(BASE, use_object=False, icp_use_model_depth=True,
                        depth_filter=True),
    "orb_loose": dict(BASE, use_object=True, icp_use_model_depth=False,
                      use_orb_backend=True, sync_tracker2mapper_method="loose",
                      sync_tracker2mapper_frames=6),
    # office0-explore's with 8 steps a scan: the pinned second half
    # replays the newest frame's graph, so every scan captures and replays
    "graphed": dict(BASE, use_object=True, icp_use_model_depth=False,
                    gaussian_update_iter=8),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the sync debug mode reports a card's synchronising "
                    "calls")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(RUNS))
def test_every_synchronising_call_is_in_a_wait_span(cuda_device, run,
                                                    tmp_path, monkeypatch):
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    from dqo_map_tpu_torch.utils import trace
    _, cams = synthetic_sequence(FRAMES, width=160, height=120,
                                 with_detections=RUNS[run]["use_object"])
    system = SLAMSystem(default_config(save_path=str(tmp_path), **RUNS[run]),
                        cameras=cams, device=cuda_device)
    census, per_entry = collections.Counter(), collections.Counter()
    outside, crowded, other = [], [], []
    stack, serial = [], itertools.count()
    record_function = torch.profiler.record_function

    class Numbered:
        """`record_function`, keeping the open spans, each entry numbered."""

        def __init__(self, name):
            self.name, self.rf = name, record_function(name)

        def __enter__(self):
            stack.append((next(serial), self.name))
            return self.rf.__enter__()

        def __exit__(self, *exc):
            stack.pop()
            return self.rf.__exit__(*exc)

    def caught(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            # such as the mode's own notice when it is first set
            other.append(f"{category.__name__}: {message}")
            return
        if not stack or not stack[-1][1].endswith("/wait"):
            outside.append(f"{filename}:{lineno} in "
                           f"{[n for _, n in stack[-3:]]}")
            return
        entry, name = stack[-1]
        census[name] += 1
        per_entry[entry] += 1
        if per_entry[entry] == 2:
            crowded.append(f"{name} at {filename}:{lineno}")

    monkeypatch.setattr(torch.profiler, "record_function", Numbered)
    trace.enable(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = caught
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i, cam in enumerate(cams):
                    system.step(cam, i)
                    system.mapping.time += 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        trace.enable(False)
    print(f"\n{run}: {sum(census.values())} synchronising calls in "
          f"{FRAMES} frames, in {len(per_entry)} wait-span entries: "
          f"{dict(census)}; other warnings: {other}")
    assert not stack
    assert not outside, outside
    assert not crowded, crowded
    m = system.mapping
    assert m.scan_counts["local"] > 0 and m.scan_counts["global"] > 0
    # the mode was on: every frame's binning reads its layout size
    assert census["bin_gaussians/wait"] >= FRAMES - 1
    if run == "objects":
        assert census["objects/readback/wait"] >= 3
    if run == "graphed":
        sc = m.scan_counts
        assert sc["graph_captures"] >= sc["local"] + sc["global"]
        assert sc["graph_replays"] > sc["graph_captures"]
    if run == "orb_loose":
        # the backend's host work reads nothing of the card but the pose
        assert census["tracking/icp/readback/wait"] == FRAMES - 1
