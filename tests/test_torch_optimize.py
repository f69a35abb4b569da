"""The port's optimize-scan pieces against the JAX package, on the CPU:
SSIM / PSNR, slerp, the masked Adam step, the scan loss, the history
merge, the sort-free tile and row selectors, the keyframe range render and
its colour-error tile mask.

Inputs are made from a seed with numpy and go through both packages; maps
are carried across with `convert.py`. Tolerances: masks and counts
exactly; SSIM, PSNR, the losses and Adam's moments to 1e-6 relative
(float32, the same operations in the same order, with the libraries' own
exp / sqrt / pow); parameters after Adam, the merge and slerp to 1e-6
absolute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.models import gaussian_map as jgm
from dqo_map_tpu.ops.projection import preprocess as jpreprocess
from dqo_map_tpu.ops.rasterize import RenderSettings as JSettings
from dqo_map_tpu.ops.rasterize import coverage_tile_mask as jcoverage
from dqo_map_tpu.ops.rasterize import gaussian_tile_overlap as joverlap
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu.utils import image as jim
from dqo_map_tpu.utils import losses as jlosses
from dqo_map_tpu.utils.math3d import slerp as jslerp
from dqo_map_tpu_torch.convert import map_state_from_numpy, map_state_to_numpy
from dqo_map_tpu_torch.models import gaussian_map as gm
from dqo_map_tpu_torch.ops.projection import preprocess
from dqo_map_tpu_torch.ops.rasterize import (RenderSettings, coverage_tile_mask,
                                             gaussian_tile_overlap)
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.utils import image as im
from dqo_map_tpu_torch.utils import losses
from dqo_map_tpu_torch.utils.math3d import slerp
from test_compact_opt import _scene
from test_rasterize import make_scene
from test_torch_rasterize import port_camera, t32


def tt(a):
    return torch.as_tensor(np.array(a))


def port_frames(frames: dict) -> dict:
    """A JAX scan's stacked frames as the port's."""
    out = {k: tt(v) for k, v in frames.items()
           if k not in ("tan_fovx", "tan_fovy")}
    out["tan_fovx"] = np.float32(frames["tan_fovx"])
    out["tan_fovy"] = np.float32(frames["tan_fovy"])
    return out


def port_state(jstate):
    return map_state_from_numpy({k: np.asarray(v) for k, v in
                                 jstate._asdict().items()}, "cpu")


def test_ssim_psnr_match_jax(rng):
    a = rng.uniform(0, 1, (3, 40, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(losses.ssim(tt(a), tt(b))),
                               float(jlosses.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(losses.psnr(tt(a), tt(b))),
                               float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    assert float(losses.ssim(tt(a), tt(a))) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(float(losses.l1_loss(tt(a), tt(b))),
                               float(jlosses.l1_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def test_slerp_matches_jax(rng):
    n = 64
    q0 = rng.normal(size=(n, 4)).astype(np.float32)
    q1 = rng.normal(size=(n, 4)).astype(np.float32)
    q1[:8] = q0[:8] * 1.5 + 1e-4 * rng.normal(size=(8, 4))   # colinear: lerp
    q1[8:12] = -q0[8:12]                                     # antipodal
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    ref = np.asarray(jslerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    got = slerp(tt(q0), tt(q1), tt(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.isfinite(got).all()


def test_adam_update_with_row_mask_matches_jax(rng):
    n = 50
    params = {"xyz": rng.normal(size=(n, 3)), "sh": rng.normal(size=(n, 16, 3)),
              "opacity": rng.normal(size=n)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    sh_lr = np.full((1, 16, 1), 5e-4 / 20, np.float32)
    sh_lr[0, 0] = 5e-4
    lrs_j = {"xyz": 1e-3, "sh": jnp.asarray(sh_lr), "opacity": 0.0}
    lrs_p = {"xyz": 1e-3, "sh": tt(sh_lr), "opacity": 0.0}
    mask = rng.uniform(size=n) < 0.6
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: tt(v) for k, v in params.items()}
    js, ps = jmapper.adam_init(jp), mapper.adam_init(pp)
    for step in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -step
             for k, v in params.items()}
        g["xyz"][3] = 0.0                              # a zero gradient row
        jp, js = jmapper.adam_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                     js, lrs_j, jnp.asarray(mask))
        pp, ps = mapper.adam_update(pp, {k: tt(v) for k, v in g.items()},
                                    ps, lrs_p, tt(mask))
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
            np.testing.assert_allclose(ps.m[k].numpy(), np.asarray(js.m[k]),
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(ps.v[k].numpy(), np.asarray(js.v[k]),
                                       rtol=1e-6, atol=1e-20)
            # masked rows never move
            assert (pp[k].numpy()[~mask] == params[k][~mask]).all()
    assert ps.step == int(js.step) == 4


def test_compute_loss_matches_jax(rng):
    H, W, N = 36, 44, 40
    out = {"render": rng.uniform(0, 1, (H, W, 3)), "depth": rng.uniform(1, 3, (H, W)),
           "normal": rng.normal(size=(H, W, 3)),
           "depth_index_map": rng.integers(-1, 5, (H, W)).astype(np.int32),
           "T_map": rng.uniform(0, 1, (H, W))}
    gt = {"color_map": rng.uniform(0, 1, (H, W, 3)),
          "depth_map": np.where(rng.uniform(size=(H, W)) < 0.1, 0.0,
                                rng.uniform(1, 3, (H, W))),
          "normal_map": rng.normal(size=(H, W, 3)),
          "render_mask": rng.uniform(size=(H, W)) < 0.8}
    gt["normal_map"][:4] = 0.0
    params = {"xyz": rng.normal(size=(N, 3)), "scaling": rng.normal(size=(N, 3)),
              "rotation": rng.normal(size=(N, 4)), "opacity": rng.normal(size=N)}
    init = {k: v + rng.normal(0, 0.01, v.shape) for k, v in params.items()}
    init["opacity"] = np.where(rng.uniform(size=N) < 0.5, -2.2, 2.2)
    mask = rng.uniform(size=N) < 0.7
    cast = lambda d, f: {k: f(np.asarray(v).astype(np.float32) if np.asarray(v).dtype == np.float64  # noqa: E731
                              else v) for k, v in d.items()}
    for weights, use_ssim in (({"color": 0.8, "depth": 1.0, "normal": 0.0, "ssim": 0.2}, False),
                              ({"color": 0.8, "depth": 0.0, "normal": 0.5, "ssim": 0.2}, True)):
        lj, rj = jmapper.compute_loss(cast(out, jnp.asarray), cast(gt, jnp.asarray),
                                      cast(params, jnp.asarray), cast(init, jnp.asarray),
                                      jnp.asarray(mask), weights, 0.1, use_ssim)
        lp, rp = mapper.compute_loss(cast(out, tt), cast(gt, tt), cast(params, tt),
                                     cast(init, tt), tt(mask), weights, 0.1, use_ssim)
        np.testing.assert_allclose(float(lp), float(lj), rtol=1e-6)
        for k, v in rp.items():
            np.testing.assert_allclose(float(v), float(rj[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        assert float(rp["scale_loss"]) > 0
    # the instance term, which the port now computes as the JAX package does
    # (`tests/test_torch_semantics.py` holds the semantic term too)
    inst = dict(cast(gt, jnp.asarray), instance_img=jnp.asarray(
        np.asarray(gt["color_map"], np.float32)))
    lj, rj = jmapper.compute_loss(cast(out, jnp.asarray), inst, cast(params, jnp.asarray),
                                  cast(init, jnp.asarray), jnp.asarray(mask), weights,
                                  0.1, False)
    lp, rp = mapper.compute_loss(cast(out, tt), dict(cast(gt, tt), instance_img=tt(gt["color_map"])),
                                 cast(params, tt), cast(init, tt), tt(mask), weights, 0.1, False)
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-6)
    np.testing.assert_allclose(float(rp["instance_loss"]), float(rj["instance_loss"]),
                               rtol=1e-6)
    assert float(rp["instance_loss"]) > 0


@pytest.fixture
def scan_scene():
    return _scene()


def test_history_merge_matches_jax(scan_scene, rng):
    state = scan_scene[0]
    n = int(state.count)
    conf = np.zeros(state.capacity, np.float32)
    conf[:n] = rng.uniform(0, 30, n)
    moved = state._replace(
        xyz=state.xyz + jnp.asarray(rng.normal(0, 0.01, state.xyz.shape), jnp.float32),
        sh=state.sh + jnp.asarray(rng.normal(0, 0.01, state.sh.shape), jnp.float32),
        rotation=state.rotation + jnp.asarray(rng.normal(0, 0.05, state.rotation.shape),
                                              jnp.float32),
        confidence=jnp.asarray(conf + rng.uniform(0, 10, state.capacity).astype(np.float32)))
    history = {"xyz": state.xyz, "sh": state.sh, "scaling": state.scaling,
               "rotation_act": state.get_rotation()}
    mask = np.asarray(state.status == jgm.UNSTABLE)
    ref = jmapper.history_merge(moved, history, jnp.asarray(conf), jnp.asarray(mask), 0.5)
    got = mapper.history_merge(port_state(moved), {k: tt(v) for k, v in history.items()},
                               tt(conf), tt(mask), 0.5)
    g, r = map_state_to_numpy(got), {k: np.asarray(v) for k, v in ref._asdict().items()}
    for k in ("xyz", "sh", "scaling", "rotation"):
        np.testing.assert_allclose(g[k], r[k], atol=1e-6, rtol=0, err_msg=k)
    assert (g["rotation"][~mask] == np.asarray(moved.rotation)[~mask]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_selectors_match_jax(seed):
    rng = np.random.default_rng(seed)
    W, H = 104, 72                 # 7 x 5 tiles, a few of them covered
    cam, means, scales, q, opac, colors = make_scene(rng, P=12, W=W, H=H)
    valid = rng.uniform(size=12) < 0.7
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    js = JSettings(width=W, height=H, impl="ref")
    ps = RenderSettings(width=W, height=H)
    cin = port_camera(cam).render_inputs("cpu")
    ref = np.asarray(jcoverage(f(means), f(scales), f(q), cam.render_inputs(), js,
                               valid_mask=jnp.asarray(valid)))
    got = coverage_tile_mask(t32(means), t32(scales), t32(q), cin, ps,
                             valid_mask=torch.as_tensor(valid)).numpy()
    assert (got == ref).all() and 0 < got.sum() < got.size
    tm = (rng.uniform(size=(5, 7)) < 0.3).astype(np.int32)
    jpre = jpreprocess(f(means), f(scales), f(q), cam.render_inputs(), 3.0, W, H)
    pre = preprocess(t32(means), t32(scales), t32(q), cin, 3.0, W, H)
    ref = np.asarray(joverlap(jpre, jnp.asarray(tm), 16, 5, 7))
    got = gaussian_tile_overlap(pre, torch.as_tensor(tm), 16, 5, 7).numpy()
    assert (got == ref).all() and 0 < got.sum() < got.size


def test_touched_rows_matches_jax(scan_scene, rng):
    state, frames, settings, _, _ = scan_scene
    tm = (rng.uniform(size=np.asarray(frames["tile_mask"]).shape) < 0.4).astype(np.int32)
    frames = dict(frames, tile_mask=jnp.asarray(tm))
    ref = np.asarray(jmapper.touched_rows(state, frames, settings, jgm.STABLE))
    got = mapper.touched_rows(port_state(state), port_frames(frames),
                              RenderSettings(width=48, height=32), gm.STABLE).numpy()
    assert (got == ref).all()
    assert 0 < got.sum() < int((np.asarray(state.status) == jgm.STABLE).sum())


def test_colorerror_tilemask_breaks_ties_like_lax_top_k():
    """Tiles of equal mean error at the k-th place: the lower tile index is
    taken first, as `lax.top_k` orders them."""
    err = np.zeros((48, 64), np.float32)
    err[0:16, 0:16] = 0.9          # tile 0
    err[16:32, 48:64] = 0.9        # tile 7
    for t in (2, 5, 9, 10, 11):    # a tie at 0.5 across the k-th place
        err[(t // 4) * 16:(t // 4 + 1) * 16, (t % 4) * 16:(t % 4 + 1) * 16] = 0.5
    for ratio in (0.25, 0.4, 0.5):
        ref = np.asarray(jim.colorerror_to_tilemask(jnp.asarray(err), 16, ratio))
        got = im.colorerror_to_tilemask(torch.as_tensor(err), 16, ratio).numpy()
        assert (got == ref).all(), ratio
        assert got.sum() == int(12 * ratio)
    # 0.4 of 12 tiles = 4: tiles 0 and 7, then the tie at 0.5 gives 2 and 5
    got = im.colorerror_to_tilemask(torch.as_tensor(err), 16, 0.4).numpy()
    assert sorted(np.flatnonzero(got)) == [0, 2, 5, 7]


@pytest.mark.parametrize("global_opt", [True, False])
def test_render_range_step_matches_jax(scan_scene, global_opt):
    state, frames, settings, _, _ = scan_scene
    pframes = port_frames(frames)
    jcam = {k: frames[k][0] for k in ("w2c", "full_proj", "cam_pos")}
    jcam.update(K=frames["K"], tan_fovx=frames["tan_fovx"], tan_fovy=frames["tan_fovy"])
    pcam = mapper._frame_cam(pframes, 0)
    rm_j, tm_j = jmapper.render_range_step(state, jcam, settings, global_opt, 0.4,
                                           frames["color"][0], 16)
    rm_p, tm_p = mapper.render_range_step(port_state(state), pcam,
                                          RenderSettings(width=48, height=32),
                                          global_opt, 0.4, pframes["color"][0], 16)
    assert (rm_p.numpy() == np.asarray(rm_j)).all()
    assert (tm_p.numpy() == np.asarray(tm_j)).all()
    assert 0 < int(tm_p.sum()) < tm_p.numel() or not global_opt


def test_eval_sh_gradient_at_the_clamp_matches_jax(rng):
    """A colour exactly at the clamp (a black sample's DC) passes half its
    gradient in both packages; below it none, above it all."""
    from dqo_map_tpu.utils.sh import eval_sh as jeval_sh
    from dqo_map_tpu_torch.utils.sh import eval_sh, rgb_to_sh
    n = 12
    sh = rng.normal(0, 0.05, (n, 16, 3)).astype(np.float32)
    sh[:4, 1:] = 0.0
    sh[:4, 0] = rgb_to_sh(torch.zeros(4, 3)).numpy()       # colour 0: the clamp
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    gj = jax.grad(lambda s: (jeval_sh(3, s, jnp.asarray(dirs)) * w).sum())(jnp.asarray(sh))
    s = tt(sh).requires_grad_(True)
    (eval_sh(3, s, tt(dirs)) * tt(w)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-8)
    assert (eval_sh(3, tt(sh), tt(dirs))[:4] == 0).all()
