"""The port's MODE=0 object refinement (`refine_objects_render`,
`ObjectLayer.optimize_objects_render`, the mapper's frame-end call) against
the JAX package, on the CPU.

Each live ellipsoid is one Gaussian rendered through the rasterizer (the
plain blend here, K1 and K2 on the card) against an object-colour image,
and a masked Adam moves centres, log-axes and quaternions. Tolerances:

- a few steps on one scene in both packages, the JAX side through its
  plain blend: the refined parameters to 1e-4 (float32 renders summed in
  other orders, and Adam's first step is lr x sign(g), so a gradient at
  rounding level could step either way; none does here);
- the convergence check of `tests/test_quadrics.py::
  test_refine_objects_render_mode0` on the port: 80 steps take the centre
  error below half its start, and the slots outside the mask do not move;
- a layer made by the JAX package over frames with detections, carried
  across with `convert.objects_from_jax`, refined by each package's
  `optimize_objects_render`: centres, axes and rotations to 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.models import quadrics as jq
from dqo_map_tpu.models.cameras import Camera as JCamera
from dqo_map_tpu.ops.rasterize import RenderSettings as JSettings
from dqo_map_tpu.ops.rasterize import rasterize as jrasterize
from dqo_map_tpu.utils.math3d import normalize as jnormalize
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.convert import objects_from_jax
from dqo_map_tpu_torch.models import quadrics as q
from dqo_map_tpu_torch.ops.rasterize import RenderSettings
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.slam.system import SLAMSystem
from test_torch_objects import fresh_ids  # noqa: F401  (fixture)
from test_torch_rasterize import port_camera

W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, as `test_torch_run.py` does:
    its runs are many small operations, and beside the other test workers
    the thread pools' waits cost several times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n_live=1):
    """MAX_OBJECTS slots: `n_live` ellipsoids in front of the camera, the
    rest empty (log(1e-4) axes at the origin, which is not in front of the
    camera), and the GT image of the live ones where they should be."""
    cam = JCamera(uid=0, c2w=np.eye(4), fx=50.0, fy=50.0, cx=W / 2, cy=H / 2,
                  width=W, height=H)
    O = q.MAX_OBJECTS
    log_axes = np.full((O, 3), np.log(1e-4), np.float32)
    quat = np.tile(np.array([1, 0, 0, 0], np.float32), (O, 1))
    center = np.zeros((O, 3), np.float32)
    colors = np.zeros((O, 3), np.float32)
    opt_mask = np.zeros((O,), bool)
    live = [([0.1, 0.0, 2.0], [0.4, 0.3, 0.2], [0.9, 0.2, 0.1]),
            ([-0.5, 0.2, 2.6], [0.2, 0.25, 0.3], [0.1, 0.7, 0.8])]
    for i, (c, a, col) in enumerate(live[:n_live]):
        center[i], log_axes[i], colors[i] = c, np.log(a), col
        opt_mask[i] = True
    quat[1] = np.array([0.96, 0.1, -0.2, 0.15], np.float32)
    jset = JSettings(width=W, height=H, impl="ref", max_tiles_per_gaussian=16)
    gt = jrasterize(
        jnp.asarray(center), jnp.exp(jnp.asarray(log_axes)),
        jnormalize(jnp.asarray(quat)), jnp.where(jnp.asarray(opt_mask), 0.99, 0.0),
        jnp.asarray(colors), cam.render_inputs(), jset,
        valid_mask=jnp.asarray(opt_mask), with_normal=False,
        with_n_touched=False)["render"]
    return cam, jset, log_axes, quat, center, colors, opt_mask, np.asarray(gt)


def _port(cam, log_axes, quat, center, colors, opt_mask, gt, **kw):
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return q.refine_objects_render(
        t(log_axes), t(quat), t(center), t(colors), t(opt_mask),
        port_camera(cam).render_inputs("cpu"), t(gt),
        RenderSettings(width=W, height=H, max_tiles_per_gaussian=16), **kw)


def test_refine_objects_render_matches_jax():
    cam, jset, log_axes, quat, center, colors, opt_mask, gt = _scene(2)
    # start both live objects off their GT poses
    center_p = center.copy()
    center_p[0] += [0.05, -0.04, 0.1]
    center_p[1] += [-0.03, 0.05, -0.1]
    la_p = log_axes.copy()
    la_p[:2] += 0.15
    kw = dict(iters=6, object_weight=1.0, lr_center=0.01)
    ref = jq.refine_objects_render(
        jnp.asarray(la_p), jnp.asarray(quat), jnp.asarray(center_p),
        jnp.asarray(colors), jnp.asarray(opt_mask), cam.render_inputs(),
        jnp.asarray(gt), jset, **kw)
    la, qt, c, receipts = _port(cam, la_p, quat, center_p, colors, opt_mask,
                                gt, **kw)
    for got, want, what in ((la, ref[0], "log_axes"), (qt, ref[1], "quat"),
                            (c, ref[2], "center")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=what)
    assert np.abs(c.numpy()[:2] - center_p[:2]).max() > 1e-2     # moved
    assert receipts == {"clipped_cells": receipts["clipped_cells"],
                        "tile_dropped": 0}
    assert receipts["clipped_cells"] >= 0


def test_refine_objects_render_converges():
    """`test_quadrics.py::test_refine_objects_render_mode0` on the port."""
    cam, _, log_axes, quat, center, colors, opt_mask, gt = _scene(1)
    gt_center = center[0].copy()
    center_p = center.copy()
    center_p[0] += [0.15, -0.1, 0.0]
    err0 = np.linalg.norm(center_p[0] - gt_center)
    _, _, new_c, _ = _port(cam, log_axes, quat, center_p, colors, opt_mask, gt,
                           iters=80, object_weight=1.0, lr_center=0.03)
    err1 = float(np.linalg.norm(new_c.numpy()[0] - gt_center))
    assert err1 < 0.5 * err0, (err0, err1)
    assert np.allclose(new_c.numpy()[1:], center[1:])
    assert np.isfinite(new_c.numpy()).all()


def test_optimize_objects_render_on_a_carried_layer():
    """A JAX layer over 4 frames with detections at 64x48, carried into the
    port's layer in MODE=0; both packages' frame-end pass at frame 3."""
    from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    kw = dict(width=W, height=H, n_objects=3, with_detections=True)
    jcams, pcams = jsequence(4, **kw)[1], synthetic_sequence(4, **kw)[1]
    jl = jq.ObjectLayer(jax_default_config(use_object=True, object_mode=0))
    for k in range(4):
        jl.process_frame(jcams[k], {}, k)
    assert len(jl.objects) >= 2
    pl = q.ObjectLayer(default_config(use_object=True, object_mode=0), "cpu")
    before = objects_from_jax(jl)["objects"]
    pl.load_state_dict(objects_from_jax(jl))
    Wc, Hc = pcams[3].width, pcams[3].height
    n_j = jl.optimize_objects_render(
        jcams[3], JSettings(width=Wc, height=Hc, impl="ref",
                            max_tiles_per_gaussian=16))
    n_p = pl.optimize_objects_render(
        pcams[3], RenderSettings(width=Wc, height=Hc,
                                 max_tiles_per_gaussian=16))
    assert n_p == n_j == len(jl.objects)
    moved = 0.0
    for a, b, start in zip(pl.objects, jl.objects, before):
        ea, eb = a.ellipsoid_, b.ellipsoid_
        for f in ("center_", "axes_", "R_"):
            np.testing.assert_allclose(getattr(ea, f), getattr(eb, f),
                                       atol=1e-4, rtol=0, err_msg=f)
        moved = max(moved, float(np.abs(ea.center_ - start["center"]).max()))
    assert moved > 0
    assert pl.render_receipts["tile_dropped"] == 0


def test_mode0_run_refines_at_every_frame_with_detections(tmp_path,
                                                          monkeypatch):
    """A port run in MODE=0 on 4 frames of the synthetic room at 64x48:
    the render refinement runs once per frame with detections, each
    followed by the deletion of the oversized stable Gaussians
    (`gaussians_delete(..., unstable=False)`, JAX `mapper.py:1650-1655`),
    and MODE=1's box refinement never."""
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    _, cams = synthetic_sequence(4, width=W, height=H, with_detections=True)
    cfg = default_config(
        type="Synthetic", save_path=str(tmp_path), use_object=True,
        object_mode=0, use_gt_pose=True, capacity=8192, add_capacity=2048,
        uniform_sample_num=800, gaussian_update_frame=2,
        gaussian_update_iter=2, min_depth=0.1, max_depth=8.0)
    system = SLAMSystem(cfg, cameras=cams, device="cpu")
    calls = {"render": 0, "box": 0}
    layer = system.object_layer
    inner = layer.optimize_objects_render

    def counted(frame, settings):
        calls["render"] += 1
        return inner(frame, settings)

    layer.optimize_objects_render = counted
    layer.optimize_objects = lambda: calls.__setitem__("box", calls["box"] + 1)
    deletes = []
    inner_delete = mapper.gaussians_delete

    def delete(state, time, window, unstable=True):
        deletes.append(unstable)
        return inner_delete(state, time, window, unstable=unstable)

    monkeypatch.setattr(mapper, "gaussians_delete", delete)
    for i in range(4):
        system.step(cams[i], i)
        system.mapping.time += 1
    assert calls["render"] == sum(bool(c.detections) for c in cams) > 0
    assert calls["box"] == 0
    assert deletes.count(False) == calls["render"]
    assert len(layer.objects) >= 1
    assert all(np.isfinite(o.ellipsoid_.center_).all() for o in layer.objects)


def test_checkpoint_round_trips_semantics_and_mode0(tmp_path):
    """A MODE=0 run with semantic and instance images, 3 frames at 64x48,
    saved and resumed into a fresh system: `sem_rgb`, the keyframes' and
    memory frames' semantic and instance images, the object layer and a
    further frame come back exactly. The checkpoint needed nothing new:
    `sem_rgb` is a map field and the frame maps are saved whole."""
    from dqo_map_tpu_torch.convert import map_state_to_numpy
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    _, cams = synthetic_sequence(4, width=W, height=H, with_detections=True)
    for c in cams:
        sem = np.zeros((H, W, 3), np.float32)
        sem[:, : W // 2] = (1.0, 0.0, 0.0)
        c.semantics = c.instance = sem
    cfg = default_config(
        type="Synthetic", save_path=str(tmp_path), use_object=True,
        object_mode=0, use_semantics=True, use_instance=True,
        use_gt_pose=True, capacity=8192, add_capacity=2048,
        uniform_sample_num=800, gaussian_update_frame=2,
        gaussian_update_iter=2, min_depth=0.1, max_depth=8.0)
    a = SLAMSystem(cfg, cameras=cams, device="cpu")
    for i in range(3):
        a.step(cams[i], i)
        a.mapping.time += 1
    assert a.mapping.scan_counts["sem_iters"] > 0
    path = a.save_checkpoint()
    b = SLAMSystem(cfg, cameras=cams, device="cpu")
    assert b.resume(path) == 3
    sa, sb = map_state_to_numpy(a.mapping.state), map_state_to_numpy(b.mapping.state)
    for k in sa:
        assert (sa[k] == sb[k]).all(), k
    assert np.abs(sa["sem_rgb"]).sum() > 0
    for (_, _, ka), (_, _, kb) in zip(a.mapping.keyframes, b.mapping.keyframes):
        assert ka.keys() == kb.keys() >= {"semantics", "instance"}
        for k in ka:
            assert torch.equal(ka[k], kb[k]), k
    for (_, fa), (_, fb) in zip(a.mapping.processed_frames,
                                b.mapping.processed_frames):
        for k in ("semantics", "instance_img"):
            assert torch.equal(fa[k], fb[k]), k
    assert (q.ObjectLayer.state_dict(a.object_layer).keys()
            == b.object_layer.state_dict().keys())
    for oa, ob in zip(a.object_layer.objects, b.object_layer.objects):
        for f in ("center_", "axes_", "R_"):
            assert (getattr(oa.ellipsoid_, f) == getattr(ob.ellipsoid_, f)).all()
    for s in (a, b):
        s.step(cams[3], 3)
    for oa, ob in zip(a.object_layer.objects, b.object_layer.objects):
        assert (oa.ellipsoid_.center_ == ob.ellipsoid_.center_).all()
    assert torch.equal(a.mapping.state.sem_rgb, b.mapping.state.sem_rgb)
