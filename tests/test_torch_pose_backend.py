"""The port's feature pose backend, pose graph, tracker hooks and sync modes
against the JAX package, on the CPU.

Both packages' backends run the same C++ source (`runtime/orb_backend.cc`)
built with the same flags (the JAX one from `runtime/`, the port's own
from `dqo_map_tpu_torch/_build/`), and its RANSAC draws from a fixed
xorshift, so inlier counts, pose sources and poses are EQUAL, as are the
pose graph's numpy results. The trackers' poses agree to 1e-4, the
tolerance `test_torch_tracking.py` holds ICP to. The sync modes change
when the host waits, not what is computed: `free` and `strict`
trajectories agree to 1e-4, as `tests/test_overlap.py` holds them in the
JAX package.
"""

import numpy as np
import pytest
import torch

from dqo_map_tpu.slam import pose_graph as jpg
from dqo_map_tpu.slam.pose_backend import PoseBackend as JPoseBackend
from dqo_map_tpu_torch.slam import pose_backend, pose_graph
from dqo_map_tpu_torch.slam.pose_backend import PoseBackend
from test_pose_backend import FakeFrame, _ensure_lib, _shift_frame, _textured_pair
from test_pose_graph import _rand_xi


@pytest.fixture(scope="module", autouse=True)
def jax_backend_library():
    """The JAX package's backend loads `runtime/liborb_backend.so`; its own
    tests build it where it is missing."""
    _ensure_lib()


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _square(noise):
    steps = []
    for _ in range(4):
        steps += [np.array([0, 0, 0, 1.0, 0, 0])] * 3
        steps += [np.array([0, np.pi / 2, 0, 0, 0, 0])]
    poses = [np.eye(4)]
    for s in steps:
        poses.append(poses[-1] @ jpg.exp_se3(s + noise))
    return np.stack(poses)


def test_pose_graph_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        xi = _rand_xi(rng, rot=1.2, trans=2.0)
        assert np.array_equal(pose_graph.exp_se3(xi), jpg.exp_se3(xi))
        T = jpg.exp_se3(xi)
        assert np.array_equal(pose_graph.log_se3(T), jpg.log_se3(T))
    gt = _square(np.zeros(6))
    drifted = _square(np.array([0.0, 0.01, 0.0, 0.02, 0.0, 0.0]))
    N = drifted.shape[0]
    rel = np.linalg.solve(gt[0], gt[-1])
    got = pose_graph.close_loop(drifted, q_idx=N - 1, m_idx=0, rel=rel)
    ref = jpg.close_loop(drifted, q_idx=N - 1, m_idx=0, rel=rel)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    # the relaxation did pull the end home
    assert (np.linalg.norm(got[0][-1][:3, 3] - gt[-1][:3, 3])
            < 0.05 * np.linalg.norm(drifted[-1][:3, 3] - gt[-1][:3, 3]))
    rng = np.random.default_rng(3)
    poses = np.stack([jpg.exp_se3(_rand_xi(rng)) for _ in range(5)])
    edges = jpg.chain_edges(poses)
    edges.append((0, 4, jpg.exp_se3(_rand_xi(rng, 0.05, 0.05))
                  @ np.linalg.solve(poses[0], poses[4]), 10.0))
    assert np.array_equal(pose_graph.optimize_pose_graph(poses, edges, iters=6),
                          jpg.optimize_pose_graph(poses, edges, iters=6))


# ---------------------------------------------------------------------------
# the backend, on the scenes of tests/test_pose_backend.py
# ---------------------------------------------------------------------------

def _texture(seed, W, H, max_shift):
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 1, (H, W + max_shift, 3)).astype(np.float32)
    for _ in range(2):
        big = 0.25 * (np.roll(big, 1, 0) + np.roll(big, -1, 0)
                      + np.roll(big, 1, 1) + np.roll(big, -1, 1))
    return 0.5 * big + 0.5 * (big > big.mean())


def _blank():
    return FakeFrame(np.zeros((120, 160, 3), np.float32),
                     np.full((120, 160), 2.0, np.float32),
                     np.array([[80, 0, 80], [0, 80, 60], [0, 0, 1.0]]))


def _trace(be):
    return {"poses": [np.asarray(p) for p in be.poses],
            "source": be.source_last, "n": be.n_inliers_last,
            "kf": be.kf_inliers_last, "loops": be.loop_closures,
            "keyframes": be.num_keyframes(),
            "mappoints": be.num_mappoints(), "residual": be.ba_residual()}


def scene_known_translation(cls):
    class Args:
        orb_useicp = True
        orb_max_feats = 800
    f0, f1, _ = _textured_pair()
    be = cls(Args())
    out = {"first": be.ingest(f0), "second": be.ingest(f1)}
    out.update(rel=be.rel, abs=be.abs_pose, **_trace(be))
    assert out["second"] >= be.MIN_INLIERS
    return out


def scene_fusion_fallback(cls):
    class Args:
        orb_useicp = True
    be = cls(Args())
    blank = _blank()
    be.ingest(blank)
    be.poses.append(np.eye(4))
    icp_rel = np.eye(4)
    icp_rel[0, 3] = 0.05
    out = {"icp": be.track(blank, icp_rel, icp_success=True),
           "icp_source": be.source_last,
           "hold": be.track(blank, icp_rel, icp_success=False)}
    out.update(_trace(be))
    assert out["icp_source"] == "icp" and out["source"] == "hold"
    return out


def scene_keyframe_gate(cls):
    """A forged strong keyframe match 5 m off: rejected while tracking is
    healthy, taken right after a tracking loss."""
    class Args:
        orb_useicp = True
        orb_loop_closing = False
    teleport = np.eye(4)
    teleport[0, 3] = 5.0
    icp_rel = np.eye(4)
    icp_rel[0, 3] = 0.05
    out = {}
    for state in ("features", "hold"):
        be = cls(Args())
        blank = _blank()
        be.ingest(blank)
        be.poses.append(np.eye(4))
        be.source_last = state
        real = be.ingest

        def poisoned(frame, icp_pose10=None, be=be, real=real):
            n = real(frame, icp_pose10)
            be.kf_inliers_last = 50
            be.abs_pose = teleport
            return n

        be.ingest = poisoned
        out[state] = (be.track(blank, icp_rel, icp_success=True),
                      be.source_last)
    assert out["features"][1] == "icp" and out["hold"][1] == "keyframe"
    return out


def scene_loop_closing(cls):
    class Args:
        orb_useicp = False
        orb_max_feats = 800
        orb_loop_closing = True
        orb_loop_min_gap = 3
        orb_loop_min_inliers = 15
        orb_loop_every = 1
    W, H, z, fx, max_shift = 320, 240, 2.0, 160.0, 60
    big = _texture(7, W, H, max_shift)
    be = cls(Args())
    shifts = (list(range(0, max_shift + 1, 4))
              + list(range(max_shift, -1, -4)))
    sources = []
    for s in shifts:
        f = _shift_frame(big, s, W, H, z, fx)
        if not be.poses:
            be.ingest(f)
            be.poses.append(np.eye(4))
            be.commit(np.eye(4))
        else:
            be.track(f, None, False)
            sources.append(be.source_last)
    out = {"sources": sources, **_trace(be)}
    assert out["loops"] >= 1
    return out


def scene_local_ba(cls):
    class Args:
        orb_useicp = False
        orb_max_feats = 800
        orb_loop_closing = False
    W, H, z, fx, max_shift = 320, 240, 2.0, 160.0, 64
    big = _texture(11, W, H, max_shift)
    rng = np.random.default_rng(11)
    be = cls(Args())
    for s in range(0, max_shift + 1, 16):
        gt = np.eye(4)
        gt[0, 3] = s * z / fx
        noisy = gt.copy()
        noisy[0, 3] += rng.normal(0, 0.01)
        be.ingest(_shift_frame(big, s, W, H, z, fx))
        be.poses.append(noisy)
        be.commit(noisy)
    before = _trace(be)
    be.local_ba(window=8, sweeps=2)
    out = {"before": before, **_trace(be)}
    assert out["mappoints"] > 100
    return out


SCENES = {f.__name__[6:]: f for f in (
    scene_known_translation, scene_fusion_fallback, scene_keyframe_gate,
    scene_loop_closing, scene_local_ba)}


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("scene", SCENES)
def test_backend_matches_jax(scene):
    _assert_same(SCENES[scene](PoseBackend), SCENES[scene](JPoseBackend))


def test_library_built_into_the_port(monkeypatch, tmp_path):
    """The port builds its own library, keyed by the source's hash, into
    its build directory, and loads it from there."""
    monkeypatch.setattr(pose_backend, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pose_backend, "_LIB", None)
    path = pose_backend.build_library()
    assert path.parent == tmp_path and path.name.startswith("liborb_backend_")
    assert pose_backend.build_library() == path        # cached
    assert pose_backend._load_lib()._name == str(path)


def test_no_fallback_without_compiler(monkeypatch, tmp_path):
    """A missing g++ raises; the tracker does not run ICP alone."""
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.slam.tracker import Tracker
    monkeypatch.setattr(pose_backend, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pose_backend, "_LIB", None)
    monkeypatch.setenv("PATH", "")
    cfg = default_config(use_orb_backend=True)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        Tracker(cfg.tracking, 64, 48, device="cpu")
    assert not list(tmp_path.iterdir())


def test_failed_build_names_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "orb_backend.cc"
    bad.write_text("int ob_create( {\n")
    monkeypatch.setattr(pose_backend, "SOURCE", bad)
    monkeypatch.setattr(pose_backend, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pose_backend, "_LIB", None)
    with pytest.raises(RuntimeError, match="error"):
        PoseBackend(object())
    assert not list((tmp_path / "build").iterdir())


# ---------------------------------------------------------------------------
# the tracker with the backend
# ---------------------------------------------------------------------------

def test_tracker_with_backend_matches_jax():
    """Five textured frames at 320x240 through both packages' Trackers with
    the backend on (priming on frame 0, detection before the readback,
    fusion): the same pose source on every frame, poses to 1e-4."""
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
    from dqo_map_tpu.slam.tracker import Tracker as JTracker
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.tracker import Tracker
    n, W, H = 5, 320, 240
    kw = dict(use_gt_pose=False, min_depth=0.1, max_depth=8.0,
              use_orb_backend=True)
    _, jcams = jsequence(n, width=W, height=H)
    _, pcams = synthetic_sequence(n, width=W, height=H)
    jt = JTracker(jax_default_config(**kw).tracking, W, H)
    pt = Tracker(default_config(**kw).tracking, W, H, device="cpu")
    assert jt.pose_backend is not None and pt.pose_backend is not None
    jt.async_pose = pt.async_pose = True
    sources = []
    for i in range(n):
        jfm = jt.map_preprocess(jcams[i], i)
        jt.tracking(jcams[i], jfm)
        pfm = pt.map_preprocess(pcams[i], i)
        pt.tracking(pcams[i], pfm)
        assert pt.pose_backend.source_last == jt.pose_backend.source_last
        assert pt.pose_backend.n_inliers_last == jt.pose_backend.n_inliers_last
        sources.append(pt.pose_backend.source_last)
        np.testing.assert_allclose(pt.poses_np()[-1],
                                   np.asarray(jt.pose_es[-1], np.float64),
                                   atol=1e-4)
        np.testing.assert_allclose(pfm["vertex_map_w"].numpy(),
                                   np.asarray(jfm["vertex_map_w"]), atol=1e-4)
        # the pose is the host's, fused: no device-side chain
        assert pcams[i].c2w_dev is None
    assert sources[0] == "init" and set(sources[1:]) <= {"features", "keyframe"}
    assert pt.pose_backend.num_keyframes() == jt.pose_backend.num_keyframes()
    assert pt.icp_fail_count == jt.icp_fail_count


# ---------------------------------------------------------------------------
# sync modes
# ---------------------------------------------------------------------------

SYNC_RUN = dict(type="Synthetic", use_object=False, use_gt_pose=False,
                icp_use_model_depth=False, capacity=8192, add_capacity=2048,
                uniform_sample_num=800, gaussian_update_frame=2,
                gaussian_update_iter=6, stable_confidence_thres=6,
                min_depth=0.1, max_depth=8.0, memory_length=3,
                sync_tracker2mapper_frames=2, tracker_max_fps=0)


def _sync_run(tmp_path, method, n=4, **kw):
    """`n` frames of `step` in sync mode `method`; returns the system and
    the frames after which it waited for the device."""
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    cfg = default_config(**dict(SYNC_RUN, save_path=str(tmp_path / method),
                                sync_tracker2mapper_method=method, **kw))
    _, cams = synthetic_sequence(n, width=64, height=48)
    system = SLAMSystem(cfg, cameras=cams, device="cpu")
    synced = []
    system._sync = lambda: synced.append(len(system.tracker.pose_es) - 1)
    for i in range(n):
        system.step(cams[i], i)
        system.mapping.time += 1
    return system, synced


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("sync")
    try:
        yield {m: _sync_run(d, m) for m in ("strict", "loose", "free")}
    finally:
        torch.set_num_threads(n)


def test_free_mode_matches_strict_trajectory(sync_runs):
    (strict, _), (free, _) = sync_runs["strict"], sync_runs["free"]
    a, b = strict.tracker.poses_np(), free.tracker.poses_np()
    assert len(a) == len(b) == 4
    for pa, pb in zip(a, b):
        np.testing.assert_allclose(pb, pa, atol=1e-4)
    u, st = free.mapping.counts()
    assert u + st > 100 and (u, st) == strict.mapping.counts()


def test_sync_points_follow_the_mode(sync_runs):
    """strict waits after tracking and after mapping on every frame; loose
    at the end of every `sync_tracker2mapper_frames`-th frame; free
    never."""
    assert sync_runs["strict"][1] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert sync_runs["loose"][1] == [1, 3]
    assert sync_runs["free"][1] == []


@pytest.mark.parametrize("method", ["strict", "loose", "free"])
def test_tracker_max_fps_sleeps_outside_strict(method, monkeypatch, tmp_path):
    from dqo_map_tpu_torch.slam import system as system_mod
    slept = []
    monkeypatch.setattr(system_mod.time, "sleep", slept.append)
    system, _ = _sync_run(tmp_path, method, n=2, tracker_max_fps=1e-3,
                          gaussian_update_iter=0)
    if method == "strict":
        assert slept == []
    else:
        # 1000 s between frame starts: the second frame waits all of it but
        # the first frame's own time (seconds)
        assert len(slept) == 1 and 900.0 < slept[0] <= 1000.0


def test_unknown_sync_method_raises(tmp_path):
    with pytest.raises(ValueError, match="sync_tracker2mapper_method"):
        _sync_run(tmp_path, "eager", n=1)
