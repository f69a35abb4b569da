"""The port's semantic and instance supervision against the JAX package, on
the CPU.

- The tracker's frame map carries the frame's semantic and instance
  images (`semantics`, `instance_img`) as the JAX tracker's does; exactly.
- `compute_loss` with the semantic L1 of the semantic pass and the
  instance term on the render's T: the loss and every reported term to
  1e-5 relative (float32, the same operations in the same order).
- `densify_step` gives each new Gaussian its pixel's semantic colour:
  `sem_rgb` exactly, with the rest of the map held as
  `test_torch_mapping.py` holds it.
- The local (`bg`) scan and the keyframe scan with both terms, on
  `test_compact_opt.py`'s scene with a two-tone semantic image, against
  JAX's `compact_optimize_scan(with_semantics=True)` through its Pallas
  blend (interpret mode), whose T output has no gradient, as the port's
  kernels (`ROADMAP.md` §3: the plain JAX blend differentiates T, so the
  instance term trains the map only there): iteration 0's
  gradients of every field, `sem_rgb` included (the semantic pass feeds
  the geometry too), to 2e-4 of the field's largest; the loss terms at
  iteration 0 to 1e-5 relative and their curves to 1% (away from L1
  kinks, as `test_torch_scans.py` holds them); `sem_rgb` after the scan
  row by row (the median row to 1e-5, at most 5% of the rows beyond 1e-3)
  and the other fields as in `test_torch_scans.py`, but for their medians
  (2e-5: see `_held_as_pallas`).
- The port's run of `tests/test_semantics.py`'s 4-frame scene reaches the
  bound that test sets the JAX package: a semantic render error under
  0.25 on the covered pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
from dqo_map_tpu.models import gaussian_map as jgm
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu.slam.renderer import render_state as jrender_state
from dqo_map_tpu.slam.tracker import Tracker as JTracker
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.convert import map_state_to_numpy
from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from dqo_map_tpu_torch.models import gaussian_map as gm
from dqo_map_tpu_torch.ops.rasterize import RenderSettings
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.slam.renderer import render_state
from dqo_map_tpu_torch.slam.system import SLAMSystem
from dqo_map_tpu_torch.slam.tracker import Tracker
from test_compact_opt import _scene
from test_torch_mapping import (H, W, _densify_both, _np, assert_states_match,
                                scene)  # noqa: F401  (fixture)
from test_torch_optimize import port_frames, port_state
from test_torch_scans import _grads_held_as_jax, recorded_grads  # noqa: F401

ITERS = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, as `test_torch_run.py` does:
    its runs are many small operations, and beside the other test workers
    the thread pools' waits cost several times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_tone(h, w):
    """Left half red, right half black: the instance target is T = 0 on
    the left and T = 1 on the right."""
    sem = np.zeros((h, w, 3), np.float32)
    sem[:, : w // 2] = (1.0, 0.0, 0.0)
    return sem


def test_frame_map_carries_semantics_as_jax():
    _, pcams = synthetic_sequence(1, width=W, height=H)
    _, jcams = jsequence(1, width=W, height=H)
    sem = _two_tone(H, W)
    inst = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    for c in (pcams[0], jcams[0]):
        c.semantics, c.instance = sem, inst
    cfg = dict(min_depth=0.1, max_depth=8.0)
    pfm = Tracker(default_config(**cfg).tracking, W, H, "cpu").map_preprocess(
        pcams[0], 0)
    jfm = JTracker(jax_default_config(**cfg).tracking, W, H).map_preprocess(
        jcams[0], 0)
    for k in ("semantics", "instance_img"):
        assert pfm[k].dtype == torch.float32 and pfm[k].device.type == "cpu"
        assert (pfm[k].numpy() == np.asarray(jfm[k])).all(), k
    # a frame without them: None on both sides
    for c in (pcams[0], jcams[0]):
        c.semantics = c.instance = None
    pfm = Tracker(default_config(**cfg).tracking, W, H, "cpu").map_preprocess(
        pcams[0], 0)
    jfm = JTracker(jax_default_config(**cfg).tracking, W, H).map_preprocess(
        jcams[0], 0)
    for k in ("semantics", "instance_img"):
        assert pfm[k] is None and jfm[k] is None


@pytest.mark.parametrize("space", ["image", "tiles"])
def test_compute_loss_semantic_and_instance_terms_match_jax(rng, space):
    shape = (40, 52) if space == "image" else (12, 256)
    out = {"render": rng.uniform(0, 1, shape + (3,)),
           "depth": rng.uniform(0.5, 3, shape),
           "normal": rng.normal(size=shape + (3,)),
           "depth_index_map": rng.integers(-1, 50, shape).astype(np.int32),
           "T_map": rng.uniform(0, 1, shape)}
    gt = {"color_map": rng.uniform(0, 1, shape + (3,)),
          "depth_map": rng.uniform(0, 3, shape),
          "normal_map": rng.normal(size=shape + (3,)),
          "render_mask": rng.uniform(size=shape) < 0.8,
          "semantics_color": rng.uniform(0, 1, shape + (3,)),
          "instance_img": np.where(rng.uniform(size=shape + (1,)) < 0.4, 0.0,
                                   rng.uniform(0, 1, shape + (3,)))}
    sem = rng.uniform(0, 1, shape + (3,))
    N = 300
    params = {"xyz": rng.normal(size=(N, 3)), "scaling": rng.normal(size=(N, 3)),
              "rotation": rng.normal(size=(N, 4)), "opacity": rng.normal(size=N)}
    init = {k: v + rng.normal(0, 0.01, v.shape) for k, v in params.items()}
    init["opacity"] = np.where(rng.uniform(size=N) < 0.5, -2.2, 2.2)
    mask = rng.uniform(size=N) < 0.7

    def f32(x):
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype == np.float64 else x

    weights = {"color": 0.8, "depth": 1.0, "normal": 0.0, "ssim": 0.0,
               "semantic": 0.1, "instance": 0.8}
    jd = lambda d: {k: jnp.asarray(f32(v)) for k, v in d.items()}  # noqa: E731
    td = lambda d: {k: torch.as_tensor(f32(v)) for k, v in d.items()}  # noqa: E731
    lj, rj = jmapper.compute_loss(jd(out), jd(gt), jd(params), jd(init),
                                  jnp.asarray(mask), weights, 0.1, False,
                                  sem_render=jnp.asarray(f32(sem)))
    lp, rp = mapper.compute_loss(td(out), td(gt), td(params), td(init),
                                 torch.as_tensor(mask), weights, 0.1, False,
                                 sem_render=torch.as_tensor(f32(sem)))
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    assert set(rp) == set(rj)
    for k, v in rp.items():
        np.testing.assert_allclose(float(v), float(rj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(rp["semantic_loss"]) > 0 and float(rp["instance_loss"]) > 0


def test_densify_samples_semantic_colours_as_jax(scene):  # noqa: F811
    cams, fms, dcfg, settings = scene
    sem = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32)
    fm = dict(fms[0], semantics=sem)
    zero = {"T_map": np.ones((H, W), np.float32),
            "depth": np.zeros((H, W), np.float32),
            "render": np.zeros((H, W, 3), np.float32),
            "depth_index_map": np.full((H, W), -1, np.int32),
            "color_index_map": np.full((H, W), -1, np.int32)}
    j, nj, p, n_p = _densify_both(jgm.empty_map(4096), fm, cams[0], zero, True,
                                  jax.random.key(11), 0, dcfg, settings)
    assert n_p == nj > 500
    assert_states_match(p, j)           # `sem_rgb` exactly
    rows = p.sem_rgb[:p.count][p.status[:p.count] != gm.DEAD].numpy()
    assert len(rows) == n_p
    # every row is a colour of the semantic image
    assert (np.abs(rows[:, None, :] - sem.reshape(1, -1, 3)).sum(-1)
            == 0).any(1).all()


def _semantic_scene():
    """`test_compact_opt.py`'s scene with random `sem_rgb` on its rows and
    a two-tone semantic (and instance) image in both frames."""
    state, frames, settings, lrs, weights = _scene()
    F, H_, W_ = frames["color"].shape[:3]
    sem = jnp.asarray(np.broadcast_to(_two_tone(H_, W_), (F, H_, W_, 3)))
    frames = dict(frames, semantics_color=sem, instance_img=sem)
    rng = np.random.default_rng(3)
    sem_rgb = np.where((np.asarray(state.status) != jgm.DEAD)[:, None],
                       rng.uniform(0.2, 0.8, (state.capacity, 3)), 0.0)
    state = state._replace(sem_rgb=jnp.asarray(sem_rgb, jnp.float32))
    lrs = dict(lrs, sem_rgb=0.01)
    weights = dict(weights, semantic=0.5, instance=0.8)
    return state, frames, settings, lrs, weights


def _held_as_pallas(state, g, r, jrec, rows):
    """The maps after a scan, held as `test_torch_scans.py::_held_as_jax`
    holds them against the plain JAX blend, but for the per-row medians of
    positions, SH and log-scales: 2e-5 here. The Pallas blend sums in
    another order than the plain one, and the same scans with the semantic
    and instance terms weighted 0 already sit at a median of 0.9-1.4e-5 in
    the log-scales on this scene. `sem_rgb` is held to the 1e-5 median."""
    n = len(rows)
    assert (g["confidence"] == r["confidence"]).all()
    assert (g["confidence"][rows] > np.asarray(state.confidence)[rows]).any()
    assert (g["status"] == r["status"]).all()
    for k, tol in (("xyz", 2e-5), ("sh", 2e-5), ("scaling", 2e-5),
                   ("sem_rgb", 1e-5)):
        d = np.abs(g[k] - r[k])[rows].reshape(n, -1).max(1)
        assert np.median(d) <= tol, (k, np.median(d))
        assert (d > 1e-3).mean() <= 0.05, (k, int((d > 1e-3).sum()))
    grot = np.abs(jrec[0]["rotation"][:n]).max(1)
    signal = grot > 1e-4 * grot.max()
    assert signal.sum() >= 20
    np.testing.assert_allclose(g["rotation"][rows[signal]],
                               r["rotation"][rows[signal]], atol=1e-5, rtol=0)
    untouched = np.setdiff1d(np.arange(len(g["xyz"])), rows)
    for k in mapper.OPT_FIELDS:
        assert (g[k][untouched] == np.asarray(getattr(state, k))[untouched]).all(), k


@pytest.mark.parametrize("mode", ["local_bg", "keyframe"])
def test_semantic_scan_matches_jax(mode, recorded_grads):  # noqa: F811
    jrec, prec = recorded_grads
    state, frames, settings, lrs, weights = _semantic_scene()
    ps, pf = port_state(state), port_frames(frames)
    pset = RenderSettings(width=settings.width, height=settings.height)
    rand_idx = np.random.default_rng(1).integers(0, 2, ITERS).astype(np.int32)
    use_bg = mode == "local_bg"
    mask = (state.status == jgm.UNSTABLE if use_bg else
            jmapper.touched_rows(state, frames, settings, jgm.STABLE))
    # the Pallas blend (interpret mode on the CPU), whose T output carries
    # no gradient, as the port's kernels: the plain JAX blend
    # differentiates T, so the instance term would move the map there only
    jset = settings._replace(impl="pallas")
    js, jr = jmapper.compact_optimize_scan(
        state, mask, frames, jnp.asarray(rand_idx), lrs, weights, jset,
        jset, ITERS, 0.1, ubucket=256, with_semantics=True, use_bg=use_bg)
    pst, pr = mapper.compact_optimize_scan(
        ps, torch.as_tensor(np.array(mask)), pf, rand_idx, lrs, weights, pset,
        pset, ITERS, 0.1, use_bg=use_bg)
    rows = np.flatnonzero(np.asarray(mask))
    assert sorted(jrec) == sorted(prec) == list(range(ITERS))
    assert pr["sem_iters"] == ITERS
    assert pr["sem_bg_renders"] == (2 if use_bg else 0)

    # iteration 0: the same gradients, the semantic pass's into the
    # geometry included
    _grads_held_as_jax(jrec, prec, len(rows))
    a, b = prec[0]["sem_rgb"][:len(rows)], jrec[0]["sem_rgb"][:len(rows)]
    scale = np.abs(b).max()
    assert scale > 0
    np.testing.assert_allclose(a / scale, b / scale, atol=2e-4)
    for k in ("total_loss", "color_loss", "depth_loss", "scale_loss",
              "semantic_loss", "instance_loss"):
        got, ref = pr[k].numpy(), np.asarray(jr[k])
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-7, err_msg=k)
    assert pr["semantic_loss"][-1] < pr["semantic_loss"][0]

    g = map_state_to_numpy(pst)
    r = {k: np.asarray(v) for k, v in js._asdict().items()}
    _held_as_pallas(state, g, r, jrec, rows)
    moved = np.abs(g["sem_rgb"] - np.asarray(state.sem_rgb))[rows].max(1)
    assert (moved > 1e-3).mean() > 0.5


def test_semantic_pass_keeps_the_geometry_gradient():
    """The semantic pass feeds xyz, scaling, rotation and opacity as well
    as `sem_rgb`: with the colour terms weighted 0 and the semantic term
    on, the geometry's gradients are not 0 in either package."""
    state, frames, settings, lrs, weights = _semantic_scene()
    weights = dict(weights, color=0.0, depth=0.0, instance=0.0)
    ps, pf = port_state(state), port_frames(frames)
    pset = RenderSettings(width=settings.width, height=settings.height)
    p = {k: getattr(ps, k)[:ps.count].clone().requires_grad_(True)
         for k in mapper.OPT_FIELDS}
    st = mapper._substate(ps, slice(0, ps.count)).replace(**p)
    cam = mapper._frame_cam(pf, 0)
    out = render_state(st, cam, pset, "global")
    sem = render_state(st, cam, pset, "global",
                       colors_precomp=p["sem_rgb"])["render"]
    image_input = {"color_map": pf["color"][0], "depth_map": pf["depth"][0],
                   "normal_map": pf["normal"][0],
                   "render_mask": pf["render_mask"][0],
                   "semantics_color": pf["semantics_color"][0]}
    init = {k: getattr(st, k).detach() for k in ("opacity", "scaling", "xyz",
                                                 "rotation")}
    loss, rep = mapper.compute_loss(out, image_input, p, init,
                                    st.status == gm.UNSTABLE, weights, 0.1,
                                    False, sem_render=sem)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)))
    for k in ("xyz", "scaling", "opacity", "sem_rgb"):
        assert grads[k] is not None and float(grads[k].abs().max()) > 0, k
    # the JAX package's render of the same pass agrees
    jsem = jrender_state(state, {k: frames[k][0] for k in ("w2c", "full_proj",
                                                          "cam_pos")}
                         | {k: frames[k] for k in ("K", "tan_fovx", "tan_fovy")},
                         settings, "global", colors_precomp=state.sem_rgb)["render"]
    np.testing.assert_allclose(sem.detach().numpy(), np.asarray(jsem), atol=1e-5)


def test_port_run_trains_semantics_to_the_jax_bound(tmp_path):
    """`tests/test_semantics.py`'s scene through the port's `SLAMSystem` on
    the CPU: 4 frames at 64x48 with a two-tone semantic and instance image,
    10 Adam steps every 2nd frame. The trained `sem_rgb` reproduces the
    semantic image through the semantic pass: mean error on the covered
    pixels under 0.25, JAX's bound there."""
    cfg = default_config(
        type="Synthetic", save_path=str(tmp_path), use_object=False,
        use_gt_pose=True, capacity=8192, add_capacity=2048,
        uniform_sample_num=1200, gaussian_update_frame=2,
        gaussian_update_iter=10, stable_confidence_thres=6,
        min_depth=0.1, max_depth=8.0, memory_length=3,
        use_semantics=True, use_instance=True,
        semantic_color_weight=0.5, semantic_lr=0.05)
    _, cams = synthetic_sequence(4, width=64, height=48)
    for c in cams:
        sem = np.zeros((c.height, c.width, 3), np.float32)
        sem[:, : c.width // 2] = (1.0, 0.0, 0.0)
        sem[:, c.width // 2:] = (0.0, 1.0, 0.0)
        c.semantics = c.instance = sem
    system = SLAMSystem(cfg, cameras=cams, device="cpu")
    for i in range(4):
        system.step(cams[i], i)
        system.mapping.time += 1
    m = system.mapping
    assert m.scan_counts["local"] >= 2
    assert m.scan_counts["sem_iters"] == m.scan_counts["iters"] > 0
    assert m.scan_counts["sem_bg_renders"] == m.scan_counts["bg_renders"]
    with torch.no_grad():
        out = render_state(m.state, cams[3].render_inputs("cpu"), m.settings,
                           "global", colors_precomp=m.state.sem_rgb)
    sem = out["render"].numpy()
    covered = out["depth_index_map"].numpy() >= 0
    err = np.abs(sem - cams[3].semantics).mean(axis=-1)
    assert covered.mean() > 0.5
    assert err[covered].mean() < 0.25, err[covered].mean()
    alive = (m.state.status != gm.DEAD).numpy()
    assert np.isfinite(m.state.sem_rgb.numpy()[alive]).all()
    # the keyframes keep the images for the keyframe scans and final pass
    assert all("semantics" in km and "instance" in km
               for _, _, km in m.keyframes)
