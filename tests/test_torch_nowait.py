"""ICP-only tracking in loose sync waits for nothing on the card: from the
third frame on, the tracker's `map_preprocess` and `tracking` run under
`torch.cuda.set_sync_debug_mode("error")`, so that any synchronising
call there (a blocking copy, `.item()`, `.tolist()`, a constant written
into a card's tensor) raises. The previous frame's residual is read from
the pinned host copy queued with it (`slam/tracker.py::HostCopy`), whose
event wait the mode does not count; the test also shows that the mode is
on, by a blocking read that it must refuse. Since the mode does not see
every wait, each guarded `tracking` call also starts behind ~1 s of
spinning queued on the card, and must return before its own residual's
copy has landed (`HostCopy.done()` False): a wait for anything queued
after the spin would prevent that. Only the last pose is left a device
tensor with its copy; every earlier one is the numpy array of its copy.
The ICP pyramid runs there as a CUDA graph (`slam/icp.py::IcpGraph`),
held against `icp_pyramid` on two pairs of frames.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; on the card, run it without the JAX-pinning
conftest:

    python -m pytest --noconftest tests/test_torch_nowait.py -q

It needs a CUDA card (marker `cuda`) and skips without one.
"""

import numpy as np
import pytest
import torch

FRAMES, FROM = 6, 2
SLEEP_CYCLES = 2_000_000_000       # ~1 s at the H100's 1980 MHz


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the deferred residual copy is a card's (pinned memory "
                    "and an event)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["loose", "free"])
def test_icp_only_tracking_makes_no_synchronising_call(cuda_device, method,
                                                       tmp_path):
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.ones(1, device=cuda_device).item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _, cams = synthetic_sequence(FRAMES, width=160, height=120)
    cfg = default_config(
        type="Synthetic", save_path=str(tmp_path), use_object=False,
        use_gt_pose=False, use_orb_backend=False, icp_use_model_depth=False,
        capacity=16384, add_capacity=4096, uniform_sample_num=1000,
        gaussian_update_frame=3, gaussian_update_iter=2, min_depth=0.1,
        max_depth=8.0, memory_length=3, sync_tracker2mapper_method=method,
        sync_tracker2mapper_frames=3)
    system = SLAMSystem(cfg, cameras=cams, device=cuda_device)
    tr = system.tracker
    frame_at, early = [0], []

    def guarded(fn, track):
        def call(*a, **kw):
            if frame_at[0] < FROM:
                return fn(*a, **kw)
            if track:
                torch.cuda._sleep(SLEEP_CYCLES)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if track:
                early.append(not tr._pending_p2p.done())
            return out
        return call

    tr.map_preprocess = guarded(tr.map_preprocess, False)
    tr.tracking = guarded(tr.tracking, True)
    for i, cam in enumerate(cams):
        frame_at[0] = i
        system.step(cam, i)
        system.mapping.time += 1
    torch.cuda.synchronize()
    assert len(tr.poses_np()) == FRAMES and tr.icp_fail_count == 0
    assert tr.eval_ate_series() < 1.0                        # cm
    assert early == [True] * (FRAMES - FROM)
    # every later host reader gets the pose from its queued copy
    assert all(isinstance(p, np.ndarray) for p in tr.pose_es[:-1])
    assert isinstance(tr.pose_es[-1], torch.Tensor) and tr._pose_copy.done()


@pytest.mark.cuda
def test_icp_graph_matches_icp_pyramid(cuda_device):
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.icp import IcpGraph, icp_pyramid
    from dqo_map_tpu_torch.slam.tracker import Tracker
    _, cams = synthetic_sequence(4, width=160, height=120)
    tr = Tracker(default_config(use_orb_backend=False).tracking, 160, 120,
                 device=cuda_device)
    pyrs = []
    for i, cam in enumerate(cams):
        fm = tr.map_preprocess(cam, i)
        pyrs.append((fm["vertex_pyr"], fm["normal_pyr"]))
    graph = None
    for a, b in ((0, 1), (2, 3)):
        want = icp_pyramid(*pyrs[a], *pyrs[b], tr.K, tr.icp_cfg)
        if graph is None:
            graph = IcpGraph(*pyrs[a], *pyrs[b], tr.K, tr.icp_cfg)
        assert graph.fits(pyrs[a][0], tr.K)
        got = graph(*pyrs[a], *pyrs[b], tr.K)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
