"""The port's tracking path (`dqo_map_tpu_torch.slam.tracker`, `.icp`)
against the JAX package, on synthetic RGB-D frames on the CPU: at 64x48,
and at 68x44, whose 3-level pyramid goes odd (68x44, 34x22, 17x11), as
the 1200x680 one does (300x170, then 150x85).

Tolerances: maps and pyramids 1e-5 (the same float32 formulas; the Sobel
and norm sums may round in another order), masks exact; ICP pose 1e-4
(Gauss-Newton sums over every pixel in another order, 15 steps), p2p to
1e-2 relative of a ~1e-6 value and the valid ratio to 1e-3 (one pixel at
the distance or normal gate is 1/3072).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.config import default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence
from dqo_map_tpu.slam import tracker as jtracker
from dqo_map_tpu.slam.icp import IcpConfig as JIcpConfig
from dqo_map_tpu.slam.icp import icp_pyramid as jicp_pyramid
from dqo_map_tpu_torch.slam import tracker
from dqo_map_tpu_torch.slam.icp import IcpConfig, icp_pyramid
from test_torch_rasterize import port_camera

W, H = 64, 48
SIZES = [(64, 48), (68, 44)]
MAP_KEYS = ("depth_map", "color_map", "vertex_map_c", "normal_map_c",
            "confidence_map")


@pytest.fixture(scope="module", params=SIZES, ids=lambda wh: "%dx%d" % wh)
def frames(request):
    width, height = request.param
    _, cams = synthetic_sequence(3, width=width, height=height)
    return cams


def _both_preprocess(cam, depth_filter=False):
    kw = dict(levels=3, min_depth=0.1, max_depth=8.0,
              invalid_confidence_thresh=0.2, depth_filter=depth_filter)
    ref = jtracker.preprocess_frame(jnp.asarray(cam.depth), jnp.asarray(cam.image),
                                    jnp.asarray(cam.K), **kw)
    got = tracker.preprocess_frame(torch.as_tensor(cam.depth),
                                   torch.as_tensor(cam.image),
                                   torch.as_tensor(cam.K), **kw)
    return ref, got


@pytest.mark.parametrize("depth_filter", [False, True])
def test_preprocess_frame_matches_jax(frames, depth_filter):
    ref, got = _both_preprocess(frames[0], depth_filter)
    assert (got["invalid_confidence_mask"].numpy()
            == np.asarray(ref["invalid_confidence_mask"])).all()
    for k in MAP_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    for name in ("vertex_pyr", "normal_pyr"):
        for lvl, (a, b) in enumerate(zip(got[name], ref[name])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0, err_msg=f"{name}[{lvl}]")


def test_icp_pyramid_matches_jax(frames):
    r0, g0 = _both_preprocess(frames[0])
    r1, g1 = _both_preprocess(frames[2])
    K = frames[0].K
    pose_r, p2p_r, vr_r = jicp_pyramid(
        r0["vertex_pyr"], r0["normal_pyr"], r1["vertex_pyr"], r1["normal_pyr"],
        jnp.asarray(K), JIcpConfig())
    pose_g, p2p_g, vr_g = icp_pyramid(
        g0["vertex_pyr"], g0["normal_pyr"], g1["vertex_pyr"], g1["normal_pyr"],
        torch.as_tensor(K), IcpConfig())
    np.testing.assert_allclose(pose_g.numpy(), np.asarray(pose_r), atol=1e-4)
    np.testing.assert_allclose(float(p2p_g), float(p2p_r), rtol=1e-2)
    np.testing.assert_allclose(float(vr_g), float(vr_r), atol=1e-3)
    # the motion between the frames was recovered (against ground truth)
    gt10 = np.linalg.inv(frames[0].c2w) @ frames[2].c2w
    np.testing.assert_allclose(pose_g.numpy()[:3, 3], gt10[:3, 3], atol=2e-3)


def test_tracker_pose_chain_matches_jax(frames):
    """Three frames through both Trackers with the device-side pose chain
    (`async_pose`, as SLAMSystem runs them)."""
    cfg = default_config(use_gt_pose=False, min_depth=0.1, max_depth=8.0)
    width, height = frames[0].width, frames[0].height
    jt = jtracker.Tracker(cfg.tracking, width, height)
    pt = tracker.Tracker(cfg.tracking, width, height, device="cpu")
    jt.async_pose = pt.async_pose = True
    for i, cam in enumerate(frames):
        jc, pc = dataclasses.replace(cam, c2w=cam.c2w.copy()), port_camera(cam)
        jfm = jt.map_preprocess(jc, i)
        jt.tracking(jc, jfm)
        pfm = pt.map_preprocess(pc, i)
        pt.tracking(pc, pfm)
        np.testing.assert_allclose(pt.poses_np()[-1],
                                   np.asarray(jt.pose_es[-1], np.float64),
                                   atol=1e-4)
        for k in ("vertex_map_w", "normal_map_w"):
            np.testing.assert_allclose(pfm[k].numpy(), np.asarray(jfm[k]),
                                       atol=1e-4, rtol=0, err_msg=k)
    assert pt.icp_fail_count == jt.icp_fail_count
    assert abs(pt.eval_ate_series() - jt.eval_ate_series()) < 1e-2


def test_fuse_model_depth_matches_jax(rng):
    ds = [rng.uniform(0.5, 3.0, (H, W)).astype(np.float32) for _ in range(2)]
    ds[1] = np.where(rng.uniform(size=(H, W)) < 0.8,
                     ds[0] + rng.normal(0, 0.003, (H, W)), ds[1]).astype(np.float32)
    ds[1][rng.uniform(size=(H, W)) < 0.1] = 0.0
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n2 = (n + rng.normal(0, 0.01, (H, W, 3))).astype(np.float32)
    ref = jtracker.fuse_model_depth(*(jnp.asarray(a) for a in (ds[0], ds[1], n, n2)))
    got = tracker.fuse_model_depth(*(torch.as_tensor(a) for a in (ds[0], ds[1], n, n2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
