"""The JAX package's helpers that its own pipeline calls little or not at
all, against the port's counterparts on the CPU:

- `SLAMSystem.step`'s promote / error-remove / delete tail
  (`Mapping.finalize_frame`, on the end-of-frame render, tagged
  `finalize(fix+err+del)`): frames 1 and 2 of the synthetic room at
  64x48, off the optimize cadence, over the map of frame 0 promoted
  whole, every new Gaussian promoted at once (a confidence threshold
  below 0) so that stable ones meet the error-remove step, the port fed
  the JAX package's draws. (Both gate the error-remove on the stable
  count read as the frame began, so on the frame of the first promotion
  neither runs it; frame 0 is taken through both `mapping` calls without
  the tail, then promoted, and a case of its own holds the first
  promotion.) Pose to 1e-4,
  counts and statuses exact, positions, SH, rotations and log-scales to
  1e-5 and the other fields exactly, but at a few slots: the renders are ill-conditioned in
  the map (as in `test_torch_slice.py`), so one new Gaussian's initial
  opacity and error count may differ; at most 2 slots, or 0.2% of the
  alive ones, per field and frame (1 of 1,062 at frame 2 here).
- `Mapping.counts()`, the map counts read once a frame (the previous
  frame's snapshot), call by call over the first promotion, a compaction
  and MODE=0's stable delete.
- `ops/knn.py::update_geometry_scales` to 1e-5 on points whose
  neighbours are far from ties (JAX ranks them approximately).
- `Camera.resized` (nearest) exactly, `utils/math3d.py`'s
  `transform_points` and `transform_dirs` to 1e-6.
- `eval_frame(run_pcd=True, gt_mesh_points=...)`: the render metrics and
  `eval_pcd` of the map's alive centres, on the same render and map, to
  1e-5 relative.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu.slam.system import SLAMSystem as JSLAMSystem
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.convert import map_state_to_numpy
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.slam.system import SLAMSystem
from test_torch_rasterize import port_camera
from test_torch_slice import _counts, _jax_draws

W, H, FRAMES = 64, 48, 3
COUNT_FRAMES = 4
SETTINGS = dict(
    type="Synthetic", use_gt_pose=False, use_orb_backend=False,
    use_object=False, capacity=8192, add_capacity=2048,
    uniform_sample_num=1200, gaussian_update_frame=6,
    gaussian_update_iter=2, stable_confidence_thres=-1.0,
    global_keyframe_num=3, min_depth=0.1, max_depth=8.0, memory_length=5,
    initial_bucket=8192)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(tmp_path, **overrides):
    """Both systems on the synthetic room, off the optimize cadence
    (frames 1-5 of a 6-frame cycle), and a function that takes frame `i`
    through both, the port fed the JAX package's draws: through tracking
    and `mapping` (without the tail), or with `step` through
    `SLAMSystem.step` with the object layer `objects` and a detection on
    the frame."""
    settings = {**SETTINGS, **overrides}
    _, cams = synthetic_sequence(settings.pop("frames", FRAMES), width=W,
                                 height=H)
    jsys = JSLAMSystem(jax_default_config(save_path=str(tmp_path), **settings),
                       cameras=[dataclasses.replace(c, c2w=c.c2w.copy())
                                for c in cams])
    psys = SLAMSystem(default_config(save_path=str(tmp_path), **settings),
                      cameras=[port_camera(c) for c in cams], device="cpu")
    jt, jm, pt, pm = jsys.tracker, jsys.mapping, psys.tracker, psys.mapping
    jm.time = pm.time = 1

    def frame(i, objects=None, step=False):
        f, p = jsys.cameras[i], psys.cameras[i]
        draws = _jax_draws(jm.key, W * H)
        if objects is not None:
            f.detections = p.detections = [{}]
        if step:
            jsys.object_layer = psys.object_layer = objects
            jsys.step(f, i)
        else:
            jfm = jt.map_preprocess(f, i)
            jt.tracking(f, jfm)
            jm.mapping(f, jfm, i, objects, defer_finalize=True)
        jm.time += 1
        pm._uniform_draws = lambda n, d=draws: d
        if step:
            psys.step(p, i)
        else:
            pfm = pt.map_preprocess(p, i)
            pt.tracking(p, pfm)
            pm.mapping(p, pfm, i, objects)
        pm.time += 1

    return jsys, psys, frame


def _maps_agree(jsys, psys, i) -> dict:
    """Frame `i`'s poses and maps held as the module's docstring says;
    returns the port's map as numpy."""
    jt, jm, pt, pm = jsys.tracker, jsys.mapping, psys.tracker, psys.mapping
    assert not jm.did_optimize and not pm.did_optimize
    np.testing.assert_allclose(pt.poses_np()[-1],
                               np.asarray(jt.pose_es[-1], np.float64),
                               atol=1e-4)
    pst = map_state_to_numpy(pm.state)
    jst = {k: np.asarray(v) for k, v in jm.state._asdict().items()}
    assert _counts(pst["status"]) == _counts(jst["status"]), i
    assert (pst["status"] == jst["status"]).all(), i
    alive = int((pst["status"] != 0).sum())
    for k in pst:
        if k in ("xyz", "sh", "scaling", "rotation"):
            off = np.abs(pst[k] - jst[k]) > 1e-5
        else:
            off = np.asarray(pst[k] != jst[k])
        slots = off.reshape(off.shape[0], -1).any(-1) if off.ndim else off
        # the renders' ill-conditioning (ROADMAP): a new Gaussian's
        # initial opacity, and its error count, may differ
        assert slots.sum() <= max(2, alive // 500), (i, k, slots.sum())
    return pst


def test_deferred_finalize_matches_jax(tmp_path):
    jsys, psys, frame = _systems(tmp_path)
    jm, pm = jsys.mapping, psys.mapping
    frame(0)
    jm.state = jmapper.gaussians_fix(jm.state, -1.0)
    jm._prefetch_counts()
    pm.state = mapper.gaussians_fix(pm.state, -1.0)
    pm._prefetch_counts()
    jmapper.profile_enable(True)
    mapper.profile_enable(True)
    jmapper.stage_times(reset=True)
    mapper.stage_times(reset=True)
    try:
        for i in range(1, FRAMES):
            frame(i, step=True)
            pst = _maps_agree(jsys, psys, i)
        jtags = jmapper.stage_times(reset=True)
        ptags = mapper.stage_times(reset=True)
    finally:
        jmapper.profile_enable(False)
        mapper.profile_enable(False)
    tag = "finalize(fix+err+del)"
    assert len(ptags[tag]) == len(jtags[tag]) == FRAMES - 1
    # the stable Gaussians met the error-remove step
    assert _counts(pst["status"])[1] > 0


def test_first_promotion_matches_jax(tmp_path, monkeypatch):
    """The frame whose tail promotes the first stable Gaussians. Both
    packages gate the error-remove on the stable count read as the frame
    began (0, the map counts' once-a-frame mirror), so neither runs it,
    and the maps agree."""
    jsys, psys, frame = _systems(tmp_path)
    frame(0)
    ran = []
    for mod in (jmapper, mapper):
        def record(state, *a, _remove=mod.error_remove_from, _mod=mod, **kw):
            ran.append(_mod.__name__)
            return _remove(state, *a, **kw)
        monkeypatch.setattr(mod, "error_remove_from", record)
    frame(1, step=True)
    assert ran == []
    pst = _maps_agree(jsys, psys, 1)
    assert _counts(pst["status"])[1] > 0


class _NoObjects:
    """An object layer in MODE=0 that finds no object: the frame's tail
    still deletes the oversized stable Gaussians after its refinement."""

    def process_frame(self, *args):
        pass

    def obj_id_image(self, W, H):
        return np.full((H, W), -1, np.int32)

    def optimize_objects_render(self, *args):
        pass


def test_counts_match_jax_call_by_call(tmp_path, monkeypatch):
    """Every `counts()` call of both packages over frames 0-3 of the room
    through `SLAMSystem.step` (the tail in `finalize_frame`): the first
    promotion, MODE=0's stable delete before every tail, and at frame 3 a
    compaction of the slots (capacity 560) and its growth. The values agree call by call,
    and the port reads the map live only before its first frame. The
    poses are the ground truth's, so that densification sees the same
    renders in both packages (ROADMAP: the renders are ill-conditioned,
    and ICP's last bits move a few new Gaussians at this size)."""
    jsys, psys, frame = _systems(tmp_path, capacity=560, add_capacity=512,
                                 object_mode=0, use_gt_pose=True,
                                 frames=COUNT_FRAMES)
    jm, pm = jsys.mapping, psys.mapping
    calls = {"jax": [], "port": []}
    for m, tag in ((jm, "jax"), (pm, "port")):
        def record(_m=m, _read=m.counts, _tag=tag):
            calls[_tag].append(tuple(_read()))
            return calls[_tag][-1]
        monkeypatch.setattr(m, "counts", record)

    def start(*a, _mapping=jm.mapping, **kw):
        # JAX reads the frame's counts as `mapping` begins, in
        # `_update_bucket`; the port's first `counts()` call is that read
        calls["jax"].append(tuple(jm._counts3()[:2]))
        return _mapping(*a, **kw)
    monkeypatch.setattr(jm, "mapping", start)
    compacted = []
    for mod in (jmapper.gm, mapper.gm):
        def compact(state, _c=mod.compact):
            compacted.append(True)
            return _c(state)
        monkeypatch.setattr(mod, "compact", compact)
    deletes = []
    for mod in (jmapper, mapper):
        def delete(state, *a, _d=mod.gaussians_delete, **kw):
            deletes.append(kw.get("unstable"))
            return _d(state, *a, **kw)
        monkeypatch.setattr(mod, "gaussians_delete", delete)
    for i in range(COUNT_FRAMES):
        frame(i, _NoObjects(), step=True)
        assert calls["jax"] == calls["port"], i
    assert pm.live_count_reads == 1
    assert len(compacted) == 2 and pm.state.capacity == 1120
    assert deletes.count(False) == 2 * COUNT_FRAMES


def test_update_geometry_scales_matches_jax():
    from dqo_map_tpu.ops.knn import update_geometry_scales as jscales
    from dqo_map_tpu_torch.ops.knn import update_geometry_scales
    i = np.arange(24, dtype=np.float64)
    # neighbours at distances growing by 15%: no ranking tie
    new = np.stack([0.01 * 1.15 ** i, 0.002 * i, 0.001 * i ** 1.5], -1)
    far = np.stack([3.0 + 0.1 * 1.2 ** np.arange(8), np.zeros(8),
                    np.zeros(8)], -1)
    cand = np.concatenate([new, far]).astype(np.float32)
    new = new.astype(np.float32)
    rad = np.concatenate([np.full(24, 1e-4), np.full(8, 0.003)]).astype(
        np.float32)
    valid_new = np.arange(24) != 5
    valid = np.arange(32) != 7
    args = (1.0, (1.0, 1.0, 0.1), 0.001, 0.05)
    jls, jkeep = jscales(jnp.asarray(new), jnp.asarray(valid_new),
                         jnp.asarray(cand), jnp.asarray(rad),
                         jnp.asarray(valid), *args)
    ls, keep = update_geometry_scales(
        torch.as_tensor(new), torch.as_tensor(valid_new),
        torch.as_tensor(cand), torch.as_tensor(rad), torch.as_tensor(valid),
        *args)
    assert (keep.numpy() == np.asarray(jkeep)).all()
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls), atol=1e-5)
    assert np.ptp(ls.numpy()[:, 0]) > 0.5       # not all clipped


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.37, 1.5])
def test_camera_resized_matches_jax(scale):
    _, cams = synthetic_sequence(1, width=W, height=H)
    cam = dataclasses.replace(
        cams[0], semantics=np.random.default_rng(0).uniform(
            size=(H, W, 3)).astype(np.float32))
    ref, got = cam.resized(scale), port_camera(cam)
    got.semantics = cam.semantics
    got = got.resized(scale)
    for f in ("uid", "fx", "fy", "cx", "cy", "width", "height", "timestamp"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("image", "depth", "semantics", "c2w", "pose_gt"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.instance is ref.instance is None
    if scale == 1.0:
        assert ref.resized(1.0) is ref


def test_transform_points_and_dirs_match_jax():
    from dqo_map_tpu.utils import math3d as jm3
    from dqo_map_tpu_torch.utils import math3d as m3
    rng = np.random.default_rng(4)
    q = rng.normal(size=4)
    R = np.asarray(jm3.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q),
                                                  jnp.float32)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, rng.normal(size=3)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    for jf, pf in ((jm3.transform_points, m3.transform_points),
                   (jm3.transform_dirs, m3.transform_dirs)):
        ref = np.asarray(jf(jnp.asarray(T), jnp.asarray(pts)))
        got = pf(torch.as_tensor(T), torch.as_tensor(pts)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


class _Mapping:
    """The surface `eval_frame` reads: a model render at a camera, the map's
    positions and statuses (and the port's device)."""

    def __init__(self, out, xyz, status, wrap):
        self.out, self.device = out, torch.device("cpu")
        self.state = type("S", (), {"xyz": wrap(xyz), "status": wrap(status)})

    def get_render_output(self, cam_inputs):
        return self.out


def test_eval_frame_point_cloud_matches_jax():
    from dqo_map_tpu.eval.evaluate import eval_frame as jeval_frame
    from dqo_map_tpu_torch.eval.evaluate import eval_frame
    rng = np.random.default_rng(6)
    _, cams = synthetic_sequence(1, width=W, height=H)
    cam = cams[0]
    out = {"render": np.clip(cam.image + rng.normal(0, 0.05, cam.image.shape),
                             0, 1).astype(np.float32),
           "depth": (cam.depth + rng.normal(0, 0.01, cam.depth.shape)).astype(
               np.float32),
           "depth_index_map": rng.integers(-1, 9, (H, W)).astype(np.int32)}
    # the ground truth on a 4 cm grid, the map's centres within 1 cm of it
    # (one nearest neighbour each, far from ties)
    g = np.stack(np.meshgrid(*[np.arange(8) * 0.04] * 3), -1).reshape(-1, 3)
    xyz = (g[rng.choice(len(g), 300, replace=False)]
           + rng.uniform(-0.01, 0.01, (300, 3))).astype(np.float32)
    xyz[::7] += 0.3                          # some outside the threshold
    status = rng.integers(0, 3, 300).astype(np.int32)
    ref = jeval_frame(_Mapping({k: jnp.asarray(v) for k, v in out.items()},
                               xyz, status, jnp.asarray), cam,
                      run_pcd=True, gt_mesh_points=g.astype(np.float32))
    pcam = port_camera(cam)
    got = eval_frame(_Mapping({k: torch.as_tensor(v) for k, v in out.items()},
                              xyz, status, torch.as_tensor), pcam,
                     run_pcd=True, gt_mesh_points=g.astype(np.float32))
    assert set(got) == set(ref) and "chamfer_cm" in got
    for k, v in ref.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k
    # without the flag, or without points, no point-cloud keys
    plain = eval_frame(_Mapping({k: torch.as_tensor(v) for k, v in out.items()},
                                xyz, status, torch.as_tensor), pcam,
                       run_pcd=True)
    assert "chamfer_cm" not in plain
