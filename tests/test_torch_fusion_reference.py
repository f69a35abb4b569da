"""The port's feature-backend fusion (`dqo_map_tpu_torch/slam/pose_backend.py`,
`slam/pose_graph.py`) against the benchmark's plain reference
(`slam_bench/reference/fusion.py`), on the CPU.

Both sides compute in float64 from the same inputs, so the only gaps are
the last bits of matrix products done in another order: the source must be
the same on every frame and the poses equal within 1e-9 m and 1e-9 rad
(`TOL`), a thousand times above float64's rounding at these magnitudes and
a hundred times below float32's, whose control must fail (`test_float32_fails`).

- the policy, with the native answers stubbed so that every branch runs,
  over seeded random poses;
- the policy on the native library over textured frames (the scenes of
  `tests/test_pose_backend.py`), recorded by the card check's wrapper
  (`scripts/fusion_card_check.py`), loop closures included;
- `pose_graph.close_loop` on drifted and random chains;
- the reference imports no port or JAX module.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.slam import pose_graph
from dqo_map_tpu_torch.slam.pose_backend import PoseBackend
from slam_bench.reference import fusion
from test_pose_backend import FakeFrame, _shift_frame, _textured_pair

ROOT = Path(__file__).resolve().parent.parent
# float64 on both sides: rounding differences stay below ~1e-13 at poses of
# metres; float32 rounding (~6e-8 at 1 m) lies far above
TOL = 1e-9
TRIALS = 12


def _card_check():
    spec = importlib.util.spec_from_file_location(
        "fusion_card_check", ROOT / "scripts" / "fusion_card_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rand_pose(rng, rot=0.6, trans=1.5):
    xi = np.concatenate([rng.uniform(-rot, rot, 3),
                         rng.uniform(-trans, trans, 3)])
    return pose_graph.exp_se3(xi)


def _small(rng, rot_deg, trans):
    """A pose `rot_deg` degrees about a random axis and `trans` m along a
    random direction from the identity."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    return pose_graph.exp_se3(np.concatenate([np.radians(rot_deg) * axis,
                                              trans * d]))


class Args:
    orb_useicp = True
    orb_loop_closing = False


def _answers(case, rng):
    """(the backend's state and native answers, ICP's pose and success,
    the expected source) of one stubbed frame of `case`."""
    last = _rand_pose(rng)
    rel = _small(rng, rng.uniform(0.1, 3.0), rng.uniform(0.005, 0.05))
    icp = rel @ _small(rng, 0.2, 0.003)
    est = last @ rel
    near = est @ _small(rng, rng.uniform(0.1, 5.0), rng.uniform(0.001, 0.05))
    a = dict(last=last, source_prev="features", n=40, rel=rel, kf=-1,
             abs_pose=np.eye(4), icp=icp, icp_ok=True, use_icp=True,
             kf_gain=1.0)
    if case == "keyframe_after_hold":
        a.update(source_prev="hold", kf=35,
                 abs_pose=est @ _small(rng, 40.0, 2.0))
    elif case == "keyframe_without_estimate":
        a.update(n=3, icp_ok=False, kf=35, abs_pose=near)
    elif case == "keyframe_nudge":
        a.update(kf=35, abs_pose=near)
    elif case == "keyframe_nudge_gain":
        a.update(kf=35, abs_pose=near, kf_gain=float(rng.uniform(0.2, 0.8)))
    elif case == "keyframe_nudge_icp":
        a.update(n=5, kf=35, abs_pose=last @ icp @ _small(rng, 2.0, 0.02))
    elif case == "refused_by_translation":
        a.update(kf=35, abs_pose=est @ _small(rng, 1.0, 0.45))
    elif case == "refused_by_rotation":
        a.update(kf=35, abs_pose=est @ _small(rng, 27.0, 0.01))
    elif case == "refused_by_inliers":
        a.update(kf=19, abs_pose=near)
    elif case == "features":
        pass
    elif case == "icp":
        a.update(n=7)
    elif case == "icp_not_used":
        a.update(n=7, use_icp=False)
    elif case == "hold":
        a.update(n=-1, icp_ok=False)
    else:
        raise ValueError(case)
    return a


EXPECTED = {
    "keyframe_after_hold": "keyframe", "keyframe_without_estimate": "keyframe",
    "keyframe_nudge": "keyframe", "keyframe_nudge_gain": "keyframe",
    "keyframe_nudge_icp": "keyframe", "refused_by_translation": "features",
    "refused_by_rotation": "features", "refused_by_inliers": "features",
    "features": "features", "icp": "icp", "icp_not_used": "hold",
    "hold": "hold"}


def _port_track(a):
    """The port's `track` on one frame, the native answers stubbed."""
    be = PoseBackend(Args())
    be.use_icp, be.KF_GAIN = a["use_icp"], a["kf_gain"]
    be.poses.append(a["last"])
    be.source_last = a["source_prev"]

    def ingest(frame, icp_pose10=None):
        be.rel, be.abs_pose = a["rel"], a["abs_pose"]
        be.n_inliers_last, be.kf_inliers_last = a["n"], a["kf"]
        return a["n"]

    be.ingest = ingest
    be.commit = lambda pose_w: None
    pose = be.track(None, a["icp"], a["icp_ok"])
    return pose, be.source_last, be.source_counts


def _ref(a, dtype=torch.float64):
    return fusion.fuse(a["last"], a["source_prev"], a["n"], a["rel"], a["kf"],
                       a["abs_pose"], a["icp"], a["icp_ok"], a["use_icp"],
                       a["kf_gain"], dtype=dtype)


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_policy_matches_reference(case):
    rng = np.random.default_rng(sorted(EXPECTED).index(case))
    for _ in range(TRIALS):
        a = _answers(case, rng)
        pose, src, counts = _port_track(a)
        ref, ref_src = _ref(a)
        assert src == ref_src == EXPECTED[case]
        assert counts == {s: int(s == src) for s in fusion.SOURCES}
        assert max(fusion.pose_diff(pose, ref)) <= TOL
        if case.startswith("keyframe_nudge"):
            # the nudge moved the estimate: the branch did work
            est = a["last"] @ (a["rel"] if a["n"] >= 12 else a["icp"])
            assert max(fusion.pose_diff(pose, est)) > 1e-4


@pytest.mark.parametrize("case", ["keyframe_nudge_gain", "features", "icp",
                                  "hold"])
def test_float32_fails(case):
    """The same fusion computed in float32 misses the tolerance: the
    comparison tells the precisions apart."""
    rng = np.random.default_rng(99)
    worst = 0.0
    for _ in range(TRIALS):
        a = _answers(case, rng)
        pose, src, _ = _port_track(a)
        ref, ref_src = _ref(a, torch.float32)
        assert src == ref_src
        worst = max(worst, *fusion.pose_diff(pose, ref))
    assert worst > 10 * TOL


def test_nudge_and_pose_gap_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(TRIALS):
        a, b = _rand_pose(rng), _rand_pose(rng)
        g = float(rng.uniform(0.0, 1.0))
        assert max(fusion.pose_diff(PoseBackend._nudge(a, b, g),
                                    fusion.nudge(a, b, g))) <= TOL
        dt, deg = PoseBackend._pose_gap(a, b)
        rdt, rdeg = fusion.pose_gap(a, b)
        assert abs(dt - rdt) <= TOL and abs(deg - rdeg) <= 1e-6
    # no rotation between them: the translation alone moves
    a = _rand_pose(rng)
    b = a.copy()
    b[:3, 3] += 0.1
    assert max(fusion.pose_diff(PoseBackend._nudge(a, b, 0.5),
                                fusion.nudge(a, b, 0.5))) <= TOL


# ---------------------------------------------------------------------------
# the native library, recorded by the card check's wrapper
# ---------------------------------------------------------------------------

def _texture(seed, W, H, max_shift):
    rng = np.random.default_rng(seed)
    big = rng.uniform(0, 1, (H, W + max_shift, 3)).astype(np.float32)
    for _ in range(2):
        big = 0.25 * (np.roll(big, 1, 0) + np.roll(big, -1, 0)
                      + np.roll(big, 1, 1) + np.roll(big, -1, 1))
    return 0.5 * big + 0.5 * (big > big.mean())


def _icp_of(s_prev, s, z, fx, rng):
    """ICP's relative pose from shift s_prev to s, with a little error."""
    rel = np.eye(4)
    rel[0, 3] = (s - s_prev) * z / fx
    return rel @ _small(rng, 0.05, 0.002)


def scene_pair():
    f0, f1, tx = _textured_pair()

    class A(Args):
        orb_max_feats = 800
    be = PoseBackend(A())
    be.ingest(f0)
    be.poses.append(np.eye(4))
    rel = np.eye(4)
    rel[0, 3] = tx
    return be, [(f1, rel, True), (f1, rel, False)]


def scene_losses():
    """A pan with frames that lose the texture: keyframes, then ICP or a
    hold on the blank frames, then the keyframe after the hold."""
    W, H, z, fx, shift = 320, 240, 2.0, 160.0, 40
    big = _texture(3, W, H, shift)
    rng = np.random.default_rng(3)

    class A(Args):
        orb_max_feats = 800
    be = PoseBackend(A())
    f0 = _shift_frame(big, 0, W, H, z, fx)
    be.ingest(f0)
    be.poses.append(np.eye(4))
    be.commit(np.eye(4))
    blank = FakeFrame(np.zeros((H, W, 3), np.float32), f0.depth, f0.K)
    frames, prev = [], 0
    for s, kind in ((4, "tex"), (8, "tex"), (8, "blank_icp"), (8, "blank"),
                    (12, "tex"), (16, "tex"), (16, "blank"), (20, "tex"),
                    (24, "tex"), (36, "tex")):
        f = blank if kind.startswith("blank") else _shift_frame(
            big, s, W, H, z, fx)
        frames.append((f, _icp_of(prev, s, z, fx, rng), kind != "blank"))
        prev = s
    return be, frames


def scene_loop():
    """Out and back over a texture with a loop searched every frame: loop
    closures relax the keyframe chain."""
    W, H, z, fx, max_shift = 320, 240, 2.0, 160.0, 60

    class A:
        orb_useicp = False
        orb_max_feats = 800
        orb_loop_closing = True
        orb_loop_min_gap = 3
        orb_loop_min_inliers = 15
        orb_loop_every = 1
    big = _texture(7, W, H, max_shift)
    be = PoseBackend(A())
    shifts = (list(range(0, max_shift + 1, 4))
              + list(range(max_shift, -1, -4)))
    be.ingest(_shift_frame(big, 0, W, H, z, fx))
    be.poses.append(np.eye(4))
    be.commit(np.eye(4))
    return be, [(_shift_frame(big, s, W, H, z, fx), None, False)
                for s in shifts[1:]]


SCENES = {"pair": scene_pair, "losses": scene_losses, "loop": scene_loop}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_native_backend_matches_reference(scene):
    card = _card_check()
    be, frames = SCENES[scene]()
    records = card.record_track(be)
    try:
        for f, icp, ok in frames:
            be.track(f, icp, ok)
    finally:
        records.undo()
    assert "track" not in vars(be) and "commit" not in vars(be)
    got = card.compare(records)
    assert got["frames"] == len(frames) and got["same_source"]
    assert max(got["pose_gap_m"], got["pose_gap_rad"],
               got["loop_gap"]) <= TOL, got
    sources = [r["source"] for r in records]
    assert be.source_counts == {s: sources.count(s) for s in fusion.SOURCES}
    if scene == "pair":
        # the first frame matches only its predecessor, the second the
        # keyframe the first made
        assert sources == ["features", "keyframe"]
    if scene == "losses":
        assert {"icp", "hold", "keyframe"} <= set(sources), sources
        # the frame after each hold is a keyframe's whole pose
        for a, b in zip(sources, sources[1:]):
            if a == "hold" and b != "hold":
                assert b == "keyframe"
    if scene == "loop":
        assert got["loops"] >= 1 and be.loop_closures == got["loops"]


# ---------------------------------------------------------------------------
# loop closure
# ---------------------------------------------------------------------------

def _square(noise):
    steps = []
    for _ in range(4):
        steps += [np.array([0, 0, 0, 1.0, 0, 0])] * 3
        steps += [np.array([0, np.pi / 2, 0, 0, 0, 0])]
    poses = [np.eye(4)]
    for s in steps:
        poses.append(poses[-1] @ pose_graph.exp_se3(s + noise))
    return np.stack(poses)


def _chains():
    """The drifted square, then random keyframe chains as a camera makes
    them (steps of 2-20 degrees and 5-30 cm, the keyframe thresholds') with
    a loop edge 2 degrees and 5 cm off the chain's own relative pose. The
    relaxation's Jacobians are finite differences over 1e-6, which scale
    rounding by ~1e6: chains of keyframes a radian or more apart, which no
    camera makes, differ by ~1e-8 between any two orders of the same float64
    arithmetic, and chains of these steps by at most ~2e-10 up to 40
    keyframes."""
    gt = _square(np.zeros(6))
    drifted = _square(np.array([0.0, 0.01, 0.0, 0.02, 0.0, 0.0]))
    yield drifted, len(drifted) - 1, 0, np.linalg.solve(gt[0], gt[-1])
    rng = np.random.default_rng(4)
    for n in (6, 12, 24):
        poses = [np.eye(4)]
        for _ in range(n - 1):
            poses.append(poses[-1] @ _small(rng, rng.uniform(2, 20),
                                            rng.uniform(0.05, 0.3)))
        poses = np.stack(poses)
        m = int(rng.integers(0, n - 2))
        rel = _small(rng, 2.0, 0.05) @ np.linalg.solve(poses[m], poses[-1])
        yield poses, n - 1, m, rel


@pytest.mark.parametrize("chain", range(4))
def test_close_loop_matches_reference(chain):
    poses, q, m, rel = list(_chains())[chain]
    new, delta = pose_graph.close_loop(poses, q, m, rel)
    rnew, rdelta = fusion.close_loop(poses, q, m, rel)
    gaps = [fusion.pose_diff(a, b) for a, b in zip(new, rnew)]
    gaps.append(fusion.pose_diff(delta, rdelta))
    assert max(max(g) for g in gaps) <= TOL
    # the relaxation moved the chain
    assert max(fusion.pose_diff(new[q], poses[q])) > 1e-4


def test_se3_matches_reference():
    rng = np.random.default_rng(6)
    for rot in (1e-12, 1e-5, 0.3, 1.2, 3.0):
        xi = np.concatenate([rng.uniform(-rot, rot, 3),
                             rng.uniform(-2, 2, 3)])
        T = pose_graph.exp_se3(xi)
        assert np.abs(T - fusion.exp_se3(xi).numpy()).max() <= TOL
        assert np.abs(pose_graph.log_se3(T)
                      - fusion.log_se3(torch.as_tensor(T)).numpy()).max() <= TOL


def test_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import slam_bench.reference.fusion\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('dqo_map_tpu_torch', 'dqo_map_tpu', 'jax', "
            "'jaxlib'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for line in (ROOT / "slam_bench" / "reference" / "fusion.py").read_text(
            ).splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "dqo_map_tpu" not in s and "jax" not in s, s
