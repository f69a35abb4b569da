"""The port's object layer (`dqo_map_tpu_torch/models/quadrics.py`), its
colour passes and its place in a run, against the JAX package on the CPU.

Tolerances, and why:
- the host half (dual-form algebra, detection filtering, association,
  duplicate removal) is the same numpy code on the same generator stream:
  EXACT, object by object, over 12 frames of detections;
- `refine_objects` is float32 autograd in both packages, summed in other
  orders: the first step's gradients to 1e-4 of each tensor's largest, the
  parameters refined over 60 steps to 1e-5. Adam's first step moves a
  parameter by lr x sign(g) (eps 1e-15), so a gradient near 0 can step
  either way; on this scene none does;
- the layer over 12 frames refines at every frame, each from the last
  result, so those differences compound (to ~3 mm on a centre here): the
  object count, categories, observations and the `obj_id` image EXACT,
  the ellipsoid centres to 1 cm;
- the colour passes are renders of the same map through each package's
  plain blend: colour to 1e-5, the reference's own tolerance.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import _look_at
from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
from dqo_map_tpu.models import quadrics as jq
from dqo_map_tpu.slam import renderer as jrenderer
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.convert import objects_from_jax
from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from dqo_map_tpu_torch.models import quadrics as q
from dqo_map_tpu_torch.ops.rasterize import RenderSettings
from dqo_map_tpu_torch.slam import renderer
from test_compact_opt import _scene
from test_torch_optimize import port_state

N_FRAMES = 12


@pytest.fixture(autouse=True)
def fresh_ids():
    """Both packages number their objects from a class counter, and count
    the capacity receipts in a module dict: start both at 0."""
    saved = (jq.MapObject._next_id, q.MapObject._next_id,
             dict(jq.TRUNCATION), dict(q.TRUNCATION))
    jq.MapObject._next_id = q.MapObject._next_id = 0
    yield
    jq.MapObject._next_id, q.MapObject._next_id = saved[:2]
    jq.TRUNCATION.update(saved[2])
    q.TRUNCATION.update(saved[3])


@pytest.fixture(scope="module")
def sequences():
    """12 frames of detections at 160x120 in both packages' cameras."""
    kw = dict(width=160, height=120, n_objects=3, with_detections=True)
    return jsequence(N_FRAMES, **kw)[1], synthetic_sequence(N_FRAMES, **kw)[1]


def _layers(association="iou"):
    return (jq.ObjectLayer(jax_default_config(use_object=True,
                                              association=association)),
            q.ObjectLayer(default_config(use_object=True,
                                         association=association), "cpu"))


def _state(layer):
    return (layer.state_dict() if isinstance(layer, q.ObjectLayer)
            else objects_from_jax(layer))


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _without_counters(state):
    return {k: v for k, v in state.items() if k not in ("next_id", "truncation")}


# ---------------------------------------------------------------------------
# the host half
# ---------------------------------------------------------------------------

def test_algebra_matches_jax(rng):
    from scipy.spatial.transform import Rotation
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    for _ in range(5):
        args = (rng.uniform(5, 40, 2), rng.uniform(-1, 1), rng.uniform(0, 100, 2))
        a, b = q.Ellipse(*args), jq.Ellipse(*args)
        assert np.array_equal(a.C_, b.C_)
        for x, y in ((q.Ellipse.from_dual(a.C_), jq.Ellipse.from_dual(b.C_)),
                     (a, b)):
            assert np.array_equal(x.compute_bbox(), y.compute_bbox())
            for u, v in zip(x.as_gaussian(), y.as_gaussian()):
                assert np.array_equal(u, v)
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.4).as_matrix()
        e = (rng.uniform(0.1, 0.4, 3), R,
             np.array([*rng.uniform(-0.5, 0.5, 2), rng.uniform(1.5, 3)]))
        Rt = np.eye(4)[:3]
        pa, pb = q.Ellipsoid(*e).project(K @ Rt), jq.Ellipsoid(*e).project(K @ Rt)
        assert np.array_equal(pa.compute_bbox(), pb.compute_bbox())
        assert (q.wasserstein_similarity(a, pa)
                == jq.wasserstein_similarity(b, pb))
    bb1, bb2 = [10, 10, 60, 60], [30, 20, 90, 70]
    assert q.bboxes_iou(bb1, bb2) == jq.bboxes_iou(bb1, bb2)
    assert q.is_cover(bb1, bb2) == jq.is_cover(bb1, bb2)


def test_detections_filter_matches_jax(sequences):
    jcams, pcams = sequences
    for jc, pc in zip(jcams, pcams):
        if not pc.detections:
            continue
        jk, jd = jq.detections_filter(jc.detections, jc.depth, 160, 120,
                                      np.random.default_rng(5))
        pk, pd = q.detections_filter(pc.detections, pc.depth, 160, 120,
                                     np.random.default_rng(5))
        assert np.array_equal(pd, jd)
        _assert_same(pk, jk)


@pytest.mark.parametrize("association", ["iou", "qd", "iou_qd"])
def test_association_matches_jax(sequences, association):
    """Both layers over 12 frames of detections without refinement: the
    objects (ellipsoids, observations, ids), this frame's detections, the
    generator's state and the obj_id image equal after every frame."""
    jl, pl = _layers(association)
    jcams, pcams = sequences
    for i, (jc, pc) in enumerate(zip(jcams, pcams)):
        if not pc.detections:
            continue
        jl.process_frame(jc, {}, i)
        pl.process_frame(pc, i)
        _assert_same(_without_counters(_state(pl)),
                     _without_counters(_state(jl)), f"frame {i}")
        assert np.array_equal(pl.obj_id_image(160, 120),
                              jl.obj_id_image(160, 120))
    assert 1 <= len(pl.objects) <= 5
    assert np.array_equal(pl.categories_table(), jl.categories_table())


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------

def _refine_scene():
    """The scene of `tests/test_quadrics.py::test_refine_objects_improves_iou`:
    one perturbed ellipsoid, 12 observed boxes, 60 steps."""
    rng = np.random.default_rng(1)
    O, CAP = q.MAX_OBJECTS, q.OBS_CAP
    gt_axes = np.array([0.3, 0.2, 0.25])
    gt_center = np.array([0.1, -0.1, 2.0])
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    obs_bbox = np.zeros((O, CAP, 4), np.float32)
    obs_P = np.zeros((O, CAP, 3, 4), np.float32)
    obs_valid = np.zeros((O, CAP), bool)
    n = 12
    for i in range(n):
        ang = 0.15 * i
        eye = gt_center + np.array([1.5 * np.sin(ang), 0.2, -1.8 * np.cos(ang)])
        Rt = np.linalg.inv(_look_at(eye, gt_center))[:3]
        obs_bbox[0, i] = jq.Ellipsoid(gt_axes, np.eye(3),
                                      gt_center).project(K @ Rt).compute_bbox()
        obs_P[0, i] = K @ Rt
        obs_valid[0, i] = True
    axes = np.zeros((O, 3), np.float32)
    axes[0] = gt_axes * np.array([1.4, 0.7, 1.2])
    R = np.tile(np.eye(3, dtype=np.float32), (O, 1, 1))
    center = np.zeros((O, 3), np.float32)
    center[0] = gt_center + np.array([0.06, -0.05, 0.1])
    opt_mask = np.zeros(O, bool)
    opt_mask[0] = True
    rand_idx = rng.integers(0, n, (60, O)).astype(np.int32)
    return (axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask), rand_idx


def test_project_bbox_matches_jax(rng):
    from scipy.spatial.transform import Rotation
    n = 6
    axes = rng.uniform(0.1, 0.4, (n, 3)).astype(np.float32)
    R = Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.4).as_matrix().astype(np.float32)
    center = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                             rng.uniform(1.5, 3, (n, 1))], 1).astype(np.float32)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    P = np.broadcast_to(K @ np.eye(4)[:3], (n, 3, 4)).astype(np.float32)
    ref = np.asarray(jax.vmap(jq._project_bbox)(*map(jnp.asarray,
                                                     (axes, R, center, P))))
    got = q._project_bbox(*map(torch.as_tensor, (axes, R, center, P))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_refine_objects_matches_jax():
    arrays, rand_idx = _refine_scene()
    axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask = arrays
    # the first step's gradients, over the optimized slot (the empty slots'
    # zero axes make 0/0 in both packages, and the masked Adam drops them)
    rows, o = np.arange(q.MAX_OBJECTS), rand_idx[0]

    def jax_total(p):
        def one(a, r, c, bb, P, v):
            iou = jq._bbox_iou_j(bb, jq._project_bbox(a, r, c, P))
            return jnp.where(v & (iou > 1e-6), 1.0 - iou, 0.0)
        losses = jax.vmap(one)(p["axes"], p["R"], p["center"],
                               jnp.asarray(obs_bbox[rows, o]),
                               jnp.asarray(obs_P[rows, o]),
                               jnp.asarray(obs_valid[rows, o]))
        return jnp.sum(jnp.where(jnp.asarray(opt_mask), losses, 0.0))

    ref = jax.grad(jax_total)({"axes": jnp.asarray(axes), "R": jnp.asarray(R),
                               "center": jnp.asarray(center)})
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (axes, R, center)]
    total = q.objects_loss(*leaves, *(torch.as_tensor(a[rows, o]) for a in (
        obs_bbox, obs_P, obs_valid)), torch.as_tensor(opt_mask))
    got = torch.autograd.grad(total, leaves)
    for k, g in zip(("axes", "R", "center"), got):
        r = np.asarray(ref[k])[opt_mask]
        np.testing.assert_allclose(g.numpy()[opt_mask], r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    jout = jq.refine_objects(*map(jnp.asarray, arrays),
                             jnp.asarray(rand_idx), iters=60)
    pout = q.refine_objects(*map(torch.as_tensor, arrays), rand_idx, iters=60)
    for k, a, b in zip(("axes", "R", "center"), pout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5,
                                   err_msg=k)
    # the empty slots are untouched
    assert np.array_equal(pout[0].numpy()[1:], axes[1:])


def test_object_layer_matches_jax(sequences):
    """Both layers over 12 frames, refining at every frame with detections,
    as `tests/test_quadrics.py::test_object_layer_end_to_end` drives the
    JAX one; then the port's layer carried across (`objects_from_jax`)
    from the JAX one's state takes the same next step."""
    jl, pl = _layers()
    jcams, pcams = sequences
    for i, (jc, pc) in enumerate(zip(jcams, pcams)):
        if not pc.detections:
            continue
        jl.process_frame(jc, {}, i)
        jl.optimize_objects(jc, i)
        pl.process_frame(pc, i)
        pl.optimize_objects()
        assert len(pl.objects) == len(jl.objects), f"frame {i}"
        assert np.array_equal(pl.categories_table(), jl.categories_table())
        assert np.array_equal(pl.obj_id_image(160, 120),
                              jl.obj_id_image(160, 120)), f"frame {i}"
        for a, b in zip(pl.objects, jl.objects):
            assert a.id_ == b.id_ and a.category_id_ == b.category_id_
            assert np.array_equal(np.array(a.bboxes_), np.array(b.bboxes_))
            assert np.array_equal(np.array(a.Rts_), np.array(b.Rts_))
            np.testing.assert_allclose(a.ellipsoid_.center_,
                                       b.ellipsoid_.center_, atol=1e-2)
    assert len(pl.objects) >= 1
    ious = pl.record_iou(pcams[0].K.astype(np.float64))
    assert ious.keys() == jl.record_iou(jcams[0].K.astype(np.float64)).keys()
    assert all(0 <= v <= 1 for v in ious.values())

    carried = q.ObjectLayer(default_config(use_object=True), "cpu")
    carried.load_state_dict(objects_from_jax(jl))
    _assert_same(_without_counters(carried.state_dict()),
                 _without_counters(objects_from_jax(jl)))
    assert q.MapObject._next_id == jq.MapObject._next_id
    for k in (3, 7):       # frames with detections, seen again
        carried.process_frame(pcams[k], N_FRAMES + k)
        jl.process_frame(jcams[k], {}, N_FRAMES + k)
        _assert_same(_without_counters(carried.state_dict()),
                     _without_counters(objects_from_jax(jl)), f"again {k}")


def test_object_mode_0_raises():
    """MODE=0 is ported: the layer builds without raising, and its
    frame-end pass refines nothing while it has no object
    (`tests/test_torch_mode0.py` holds the pass against the JAX package)."""
    layer = q.ObjectLayer(default_config(use_object=True, object_mode=0), "cpu")
    assert layer.optimize_objects_render(None, None) == 0
    assert layer.render_receipts == {"clipped_cells": 0, "tile_dropped": 0}


# ---------------------------------------------------------------------------
# the colour passes
# ---------------------------------------------------------------------------

def test_palette_matches_jax():
    ids = np.array([-1, 0, 1, 2, 0, 63, 1000, 2 ** 31 - 1], np.int32)
    ref = np.asarray(jrenderer.palette_color(jnp.asarray(ids)))
    got = renderer.palette_color(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    assert (got[0] == 0).all() and (got[1] == got[4]).all()


def test_color_passes_match_jax(rng):
    """`render_instance` and `render_semantic` of one map (the compact-scan
    scene, its Gaussians given object ids -1..4) in both packages."""
    state, frames, settings, _, _ = _scene()
    n = int(state.count)
    oid = np.full(state.capacity, -1, np.int32)
    oid[:n] = rng.integers(-1, 5, n)
    state = state._replace(obj_id=jnp.asarray(oid))
    cats = np.array([3, 1, 3, 7, 2] + [-1] * (q.MAX_OBJECTS - 5), np.int32)
    jcam = {k: frames[k][0] for k in ("w2c", "full_proj", "cam_pos")}
    jcam.update({k: frames[k] for k in ("K", "tan_fovx", "tan_fovy")})
    pcam = {k: torch.as_tensor(np.array(v)) for k, v in jcam.items()
            if k not in ("tan_fovx", "tan_fovy")}
    pcam.update(tan_fovx=np.float32(jcam["tan_fovx"]),
                tan_fovy=np.float32(jcam["tan_fovy"]))
    ps = port_state(state)
    pset = RenderSettings(width=settings.width, height=settings.height)
    inst = renderer.render_instance(ps, pcam, pset)
    sem = renderer.render_semantic(ps, pcam, pset, torch.as_tensor(cats))
    for got, ref in ((inst, jrenderer.render_instance(state, jcam, settings)),
                     (sem, jrenderer.render_semantic(state, jcam, settings,
                                                     jnp.asarray(cats)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
    assert float(inst.max()) > 0.15       # some Gaussians of an object show
    # the geometry is detached: no gradient reaches the map through a pass
    ps.xyz.requires_grad_(True)
    assert not renderer.render_instance(ps, pcam, pset).requires_grad


# ---------------------------------------------------------------------------
# a run with objects and the feature backend
# ---------------------------------------------------------------------------

OBJ_RUN = dict(type="Synthetic", use_object=True, use_orb_backend=True,
               use_gt_pose=False, capacity=8192, add_capacity=2048,
               uniform_sample_num=1200, gaussian_update_frame=2,
               gaussian_update_iter=6, stable_confidence_thres=6,
               min_depth=0.1, max_depth=8.0, memory_length=3,
               final_global_iter=2)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_writes_objects(tmp_path, one_thread):
    """`run()` on 5 frames at 64x48 with the object layer and the feature
    backend: Gaussians bound to objects, `save_obj/objects.txt` a line an
    object, `iou.txt`, both colour-pass PNGs, and the receipts in the
    result."""
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    _, cams = synthetic_sequence(5, width=64, height=48, with_detections=True)
    system = SLAMSystem(default_config(save_path=str(tmp_path), **OBJ_RUN),
                        cameras=cams, device="cpu")
    assert system.tracker.pose_backend is not None
    result = system.run(verbose=False)
    assert result["n_objects"] == len(system.object_layer.objects) >= 1
    assert result["obj_obs_trimmed"] == 0 and result["obj_over_cap"] == 0
    s = system.mapping.state
    alive = (s.status != 0)[:s.count]
    assert int((s.obj_id[:s.count][alive] >= 0).sum()) > 10
    with open(tmp_path / "save_obj" / "objects.txt") as f:
        assert len(f.read().splitlines()) == result["n_objects"]
    with open(tmp_path / "save_obj" / "iou.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == result["n_objects"]
    assert all(0 <= float(x.split()[1]) <= 1 for x in lines)
    for name in ("instance", "semantic"):
        with open(tmp_path / "eval_render" / f"{name}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    sources = {system.tracker.pose_backend.source_last}
    assert sources <= {"keyframe", "features", "icp", "hold"}


def test_checkpoint_carries_objects(tmp_path, one_thread):
    """Three frames with objects, saved and resumed into a fresh system:
    the object layer equal, and the next frame (ground-truth poses, so the
    resumed tracker's held pose does not differ) gives equal objects and an
    equal render."""
    from dqo_map_tpu_torch.convert import map_state_from_checkpoint
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    _, cams = synthetic_sequence(4, width=64, height=48, with_detections=True)
    cfg = default_config(save_path=str(tmp_path),
                         **dict(OBJ_RUN, use_gt_pose=True,
                                use_orb_backend=False))
    a = SLAMSystem(cfg, cameras=cams, device="cpu")
    for i in range(3):
        a.step(cams[i], i)
        a.mapping.time += 1
    path = a.save_checkpoint()
    assert map_state_from_checkpoint(path, "cpu").count == a.mapping.state.count
    b = SLAMSystem(cfg, cameras=cams, device="cpu")
    assert b.resume(path) == 3
    _assert_same(b.object_layer.state_dict(), a.object_layer.state_dict())
    assert len(a.object_layer.objects) >= 1
    # the id counter is the class's, shared by both systems in this process
    next_id = q.MapObject._next_id
    ra = a.step(cams[3], 3)["render"]
    q.MapObject._next_id = next_id
    rb = b.step(cams[3], 3)["render"]
    _assert_same(b.object_layer.state_dict(), a.object_layer.state_dict())
    for k in ("render", "depth", "depth_index_map", "T_map"):
        assert torch.equal(ra[k], rb[k]), k
    assert torch.equal(a.mapping.state.obj_id, b.mapping.state.obj_id)
    assert os.path.isfile(path)
