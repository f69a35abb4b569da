"""The port's optimize scans against the JAX package's, on the CPU:
`optimize_scan` (the local scan in `"global"` mode: the unstable rows over
the whole map's render; and the final whole-history pass: the stable rows,
whole frames with no tile mask, SSIM in the loss, no depth term) and
`compact_optimize_scan` with `use_bg=False` (the keyframe scan) and
`use_bg=True` (the default local scan), on `test_compact_opt.py`'s scene,
carried across with `convert.py`; and both packages' final pass as
`Mapping.global_optimization(is_end=True)` runs it, with the depth-L1
each package's own `eval_frame` reads before and after it. The JAX
side blends with its plain `ref` implementation, the port with its plain
versions (`blend_blocks_ref` / `blend_bwd_ref`).

Both packages' Adam steps are wrapped to record every iteration's
gradients. Tolerances, and why:

- iteration 0's gradients, every field, at `test_blend_pallas.py:92-94`'s
  atol 2e-4 of the field's largest magnitude; its loss to 1e-5 relative;
- Adam's first step is lr * sign(g) (eps = 1e-15), so a gradient at
  rounding level steps a full lr either way. In this scene the Gaussians
  are isotropic, so a rotation moves the render only through the hit
  normal's plane depth: the rows with no such term have rotation gradients
  of about 1e-11 in both packages, of either sign, and their rotations
  after the scan agree to nothing. They are the rows whose iteration-0
  rotation gradient is below 1e-4 of the field's largest; the other rows'
  rotations are held to 1e-5;
- those rows' normals move the plane depths a little differently, so the
  loss curves are held to 1% relative and positions, SH and log-scales by
  rows: the median row to 1e-5, at most 5% of the rows beyond 1e-3;
- confidence, the exact-zero test on the SH DC gradient, exactly;
- the two final maps rendered by the port: mean |colour difference| under
  1e-3 and 99.5% of the depth index map equal.

The port's own keyframe scan is also held against its full scan of the
stable subset, as `test_compact_opt.py` holds the JAX package's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.models import gaussian_map as jgm
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu_torch.convert import map_state_from_numpy, map_state_to_numpy
from dqo_map_tpu_torch.models import gaussian_map as gm
from dqo_map_tpu_torch.ops.rasterize import RenderSettings
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.slam.renderer import render_state
from test_compact_opt import _scene
from test_torch_optimize import port_frames, port_state

ITERS = 8
FIELDS = ("xyz", "sh", "scaling", "rotation", "opacity")


@pytest.fixture
def recorded_grads(monkeypatch):
    """Every Adam step's gradients in both packages: {step: {field: array}}
    for the JAX package and for the port."""
    jrec, prec = {}, {}
    jadam, padam = jmapper.adam_update, mapper.adam_update

    def jax_adam(params, grads, st, lrs, mask, **kw):
        jax.debug.callback(lambda s, g: jrec.__setitem__(
            int(s), {k: np.asarray(v) for k, v in g.items()}), st.step, grads)
        return jadam(params, grads, st, lrs, mask, **kw)

    def port_adam(params, grads, st, lrs, mask, **kw):
        prec[st.step] = {k: v.detach().numpy().copy() for k, v in grads.items()}
        return padam(params, grads, st, lrs, mask, **kw)

    scans = (jmapper._optimize_scan, jmapper._compact_optimize_scan)
    for f in scans:          # retrace with the recording step
        f.clear_cache()
    monkeypatch.setattr(jmapper, "adam_update", jax_adam)
    monkeypatch.setattr(mapper, "adam_update", port_adam)
    yield jrec, prec
    for f in scans:
        f.clear_cache()


def _flat_scene():
    """The scene with its Gaussians flattened along their third axis: the
    final pass has no depth term, and an isotropic Gaussian's colour does
    not depend on its rotation, so without this every rotation gradient
    would be rounding noise."""
    state, frames, settings, lrs, weights = _scene()
    flat = np.log(np.array([0.06, 0.06, 0.015], np.float32))
    alive = np.asarray(state.status) != jgm.DEAD
    scaling = np.where(alive[:, None], flat, np.asarray(state.scaling))
    return state._replace(scaling=jnp.asarray(scaling)), frames, settings, lrs, weights


def _run(mode, state, frames, settings, lrs, weights):
    """One scan in both packages. Returns (JAX state, JAX report, port
    state, port report, the optimized rows)."""
    ps, pf = port_state(state), port_frames(frames)
    pset = RenderSettings(width=settings.width, height=settings.height)
    rand_idx = np.random.default_rng(1).integers(0, 2, ITERS).astype(np.int32)
    status = np.asarray(state.status)
    if mode == "full":
        js, jr = jmapper.optimize_scan(state, frames, jnp.asarray(rand_idx), lrs,
                                       weights, settings, ITERS, jgm.UNSTABLE,
                                       0.1, with_tile_mask=True, subset="global")
        pst, pr = mapper.optimize_scan(ps, pf, rand_idx, lrs, weights, pset,
                                       ITERS, gm.UNSTABLE, 0.1, subset="global")
        rows = np.arange(int(state.count))
        opt = status[rows] == jgm.UNSTABLE
    elif mode == "final":
        weights = dict(weights, depth=0.0, ssim=0.2)
        js, jr = jmapper.optimize_scan(state, frames, jnp.asarray(rand_idx), lrs,
                                       weights, settings, ITERS, jgm.STABLE,
                                       0.1, use_ssim=True, with_tile_mask=False,
                                       subset="stable")
        pst, pr = mapper.optimize_scan(ps, pf, rand_idx, lrs, weights, pset,
                                       ITERS, gm.STABLE, 0.1, use_ssim=True,
                                       with_tile_mask=False, subset="stable")
        rows = np.arange(int(state.count))
        opt = status[rows] == jgm.STABLE
    else:
        use_bg = mode == "compact_bg"
        mask = (state.status == jgm.UNSTABLE if use_bg else
                jmapper.touched_rows(state, frames, settings, jgm.STABLE))
        js, jr = jmapper.compact_optimize_scan(
            state, mask, frames, jnp.asarray(rand_idx), lrs, weights, settings,
            settings, ITERS, 0.1, ubucket=256, use_bg=use_bg)
        pst, pr = mapper.compact_optimize_scan(
            ps, torch.as_tensor(np.array(mask)), pf, rand_idx, lrs, weights,
            pset, pset, ITERS, 0.1, use_bg=use_bg)
        rows = np.flatnonzero(np.asarray(mask))
        opt = np.ones(len(rows), bool)
    return js, jr, pst, pr, rows, opt


def _held_as_jax(state, g, r, jrec, rows, opt):
    """The maps after a scan (`g` the port's, `r` the JAX package's, both
    as numpy), held as the module docstring says."""
    n = len(rows)
    assert (g["confidence"] == r["confidence"]).all()
    assert (g["confidence"][rows[opt]] > np.asarray(state.confidence)[rows[opt]]).any()
    assert (g["status"] == r["status"]).all()
    for k in ("xyz", "sh", "scaling"):
        d = np.abs(g[k] - r[k])[rows[opt]].reshape(int(opt.sum()), -1).max(1)
        assert np.median(d) <= 1e-5, k
        assert (d > 1e-3).mean() <= 0.05, (k, int((d > 1e-3).sum()))
    grot = np.abs(jrec[0]["rotation"][:n]).max(1)
    signal = (grot > 1e-4 * grot.max()) & opt
    assert signal.sum() >= 20
    np.testing.assert_allclose(g["rotation"][rows[signal]], r["rotation"][rows[signal]],
                               atol=1e-5, rtol=0)
    untouched = np.setdiff1d(np.arange(len(g["xyz"])), rows[opt])
    for k in FIELDS:
        assert (g[k][untouched] == np.asarray(getattr(state, k))[untouched]).all(), k


def _grads_held_as_jax(jrec, prec, n):
    """Iteration 0's gradients, every field, to 2e-4 of its largest."""
    for k in FIELDS:
        a, b = prec[0][k][:n], jrec[0][k][:n]
        scale = np.abs(b).max()
        if k != "opacity":                   # the scene's opacity lr is 0
            assert scale > 0, k
        np.testing.assert_allclose(a / (scale + 1e-30), b / (scale + 1e-30),
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("mode", ["full", "compact_global", "compact_bg",
                                  "final"])
def test_scan_matches_jax(mode, recorded_grads):
    jrec, prec = recorded_grads
    state, frames, settings, lrs, weights = (_flat_scene() if mode == "final"
                                             else _scene())
    js, jr, pst, pr, rows, opt = _run(mode, state, frames, settings, lrs, weights)
    assert sorted(jrec) == sorted(prec) == list(range(ITERS))

    # iteration 0: the same gradients
    _grads_held_as_jax(jrec, prec, len(rows))
    losses = ("total_loss", "color_loss", "depth_loss", "scale_loss") + (
        ("ssim_loss",) if mode == "final" else ())
    for k in losses:
        got, ref = pr[k].numpy(), np.asarray(jr[k])
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-7, err_msg=k)

    # the maps after the scan
    g = map_state_to_numpy(pst)
    r = {k: np.asarray(v) for k, v in js._asdict().items()}
    _held_as_jax(state, g, r, jrec, rows, opt)

    # ... and as the port renders them
    pset = RenderSettings(width=settings.width, height=settings.height)
    jmap = map_state_from_numpy(r, "cpu")
    pf = port_frames(frames)
    with torch.no_grad():
        a = render_state(pst, mapper._frame_cam(pf, 0), pset, "global")
        b = render_state(jmap, mapper._frame_cam(pf, 0), pset, "global")
    assert float((a["render"] - b["render"]).abs().mean()) < 1e-3
    assert float((a["depth_index_map"] == b["depth_index_map"]).float().mean()) >= 0.995


def test_port_keyframe_scan_matches_its_full_scan():
    """The compact keyframe scan renders the stable rows that touch a
    masked tile alone; that is exact against the full scan over the whole
    stable subset (`test_compact_opt.py:95-115`)."""
    state, frames, settings, lrs, weights = _scene()
    ps, pf = port_state(state), port_frames(frames)
    pset = RenderSettings(width=settings.width, height=settings.height)
    rand_idx = np.random.default_rng(1).integers(0, 2, 6).astype(np.int32)
    s_full, _ = mapper.optimize_scan(ps, pf, rand_idx, lrs, weights, pset, 6,
                                     gm.STABLE, 0.1, subset="stable")
    mask = mapper.touched_rows(ps, pf, pset, gm.STABLE)
    assert int(mask.sum()) > 100
    s_cmp, rep = mapper.compact_optimize_scan(ps, mask, pf, rand_idx, lrs,
                                              weights, pset, pset, 6, 0.1,
                                              use_bg=False)
    for k in ("xyz", "sh"):
        np.testing.assert_allclose(getattr(s_cmp, k).numpy(),
                                   getattr(s_full, k).numpy(), atol=2e-5)
    np.testing.assert_allclose(s_cmp.confidence.numpy(),
                               s_full.confidence.numpy(), atol=1e-5)
    assert rep["iters"] == 6 and rep["bg_renders"] == 0


def test_final_pass_matches_jax(tmp_path, recorded_grads):
    """Both packages' `Mapping.global_optimization(is_end=True)` from the
    same map and keyframes (the scene's two frames), `final_global_iter`
    2: the unstable rows promoted first, the same unpinned schedule drawn,
    4 steps, and the rows held as in `test_scan_matches_jax`."""
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu_torch.config import default_config
    jrec, prec = recorded_grads
    state, frames, settings, _, _ = _flat_scene()
    W, H = settings.width, settings.height
    cfg = dict(save_path=str(tmp_path), final_global_iter=2, capacity=512)
    jm = jmapper.Mapping(jax_default_config(**cfg), W, H)
    pm = mapper.Mapping(default_config(**cfg), W, H, "cpu")
    pf = port_frames(frames)
    for f in range(2):
        jcam = {k: frames[k][f] for k in ("w2c", "full_proj", "cam_pos")}
        jcam.update({k: frames[k] for k in ("K", "tan_fovx", "tan_fovy")})
        jm.keyframes.append((None, jcam, {k: frames[k][f] for k in
                                          ("color", "depth", "normal")}))
        pm.keyframes.append((None, mapper._frame_cam(pf, f),
                             {k: pf[k][f] for k in ("color", "depth", "normal")}))
    jm.state, pm.state = state, port_state(state)
    jm.global_optimization(is_end=True)
    pm.global_optimization(is_end=True)

    iters = 2 * 2
    assert sorted(jrec) == sorted(prec) == list(range(iters))
    assert pm.scan_counts["final"] == 1 and pm.scan_counts["iters"] == iters
    assert pm.scan_counts["range_renders"] == 2
    assert (pm._host_rng.bit_generator.state
            == jm._host_rng.bit_generator.state)
    kind, curve = pm.scan_log[-1]
    assert kind == "final" and curve.shape == (iters,)
    n = int(state.count)
    _grads_held_as_jax(jrec, prec, n)
    g = map_state_to_numpy(pm.state)
    r = {k: np.asarray(v) for k, v in jm.state._asdict().items()}
    assert (g["status"][:n] != jgm.UNSTABLE).all()      # every row promoted
    _held_as_jax(jmapper.gaussians_fix(state, -1.0), g, r, jrec,
                 np.arange(n), g["status"][:n] == jgm.STABLE)


def test_final_pass_depth_l1_moves_as_in_jax(tmp_path):
    """Depth-L1 over the final pass, in both packages from one state: a map
    the port built over 6 frames of the synthetic room at 64x48, carried
    with its keyframes, poses and schedule generator into the JAX
    package's `Mapping`, then each package's
    `global_optimization(is_end=True)` and its own `eval_frame` at the last
    frame before and after. The pass fits colour and SSIM only (no depth
    term, positions fixed), and depth-L1 rises over it in the JAX package
    as in the port, by the same amount: the rise the card showed at frame
    11 is the reference's own behaviour."""
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
    from dqo_map_tpu.eval.evaluate import eval_frame as jeval_frame
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.eval.evaluate import eval_frame
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    W, H, n = 64, 48, 6
    run = dict(type="Synthetic", use_object=False, use_gt_pose=False,
               capacity=16384, add_capacity=4096, uniform_sample_num=1500,
               gaussian_update_frame=3, gaussian_update_iter=10,
               final_global_iter=5, stable_confidence_thres=5, min_depth=0.1,
               max_depth=8.0, memory_length=3, save_path=str(tmp_path))
    _, pcams = synthetic_sequence(n, width=W, height=H)
    _, jcams = jsequence(n, width=W, height=H)
    system = SLAMSystem(default_config(**run), cameras=pcams, device="cpu")
    for i in range(n):
        system.step(pcams[i], i)
        system.mapping.time += 1
    pm = system.mapping
    for jc, pc in zip(jcams, pcams):
        pc.sync_pose()
        jc.c2w = np.array(pc.c2w)
    jm = jmapper.Mapping(jax_default_config(**run), W, H)
    jm.state = jgm.MapState(**{k: jnp.asarray(v) for k, v in
                               map_state_to_numpy(pm.state).items()})
    jm.time = pm.time

    def host(d):
        return {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
                for k, v in d.items()}

    jm.keyframes = [(jcams[pcams.index(c)], host(cin), host(km))
                    for c, cin, km in pm.keyframes]
    jm.keyframe_ids = list(pm.keyframe_ids)
    jm._host_rng.bit_generator.state = pm._host_rng.bit_generator.state
    def depth_l1():
        return (eval_frame(pm, pcams[-1], min_depth=0.1,
                           max_depth=8.0)["depth_l1_cm"],
                jeval_frame(jm, jcams[-1], min_depth=0.1,
                            max_depth=8.0)["depth_l1_cm"])

    p0, j0 = depth_l1()
    pm.global_optimization(is_end=True)
    jm.global_optimization(is_end=True)
    p1, j1 = depth_l1()
    assert pm.scan_counts["final"] == 1
    assert abs(p0 - j0) <= 1e-4
    assert j1 > j0 and p1 > p0            # the reference's own rise
    assert abs((p1 - p0) - (j1 - j0)) <= 0.05 * (j1 - j0)
