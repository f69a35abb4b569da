"""The benchmark's frozen reference (`slam_bench/reference/`) against the
JAX package, on the CPU: the map render, ICP with the frame's
preprocessing, and the MODE=1 object refinement, on the JAX package's
synthetic frames at 64x48. The reference is a copy of the port's plain
paths as the port's own tests held them to the JAX package; this holds
the copy itself to the JAX package, so that it stays the same semantics
whatever becomes of the port. Skips where JAX is not installed.

Tolerances: as the port's tests hold the port (`tests/test_torch_*.py`):
render colour and depth 1e-4 with at most 0.5% of the pixels hitting
another Gaussian first (ties in depth order between the two sorts), the
frames' vertex and normal pyramids and the ICP pose 1e-4 (the filtered
frame's Sobel sums round in another order), refined objects 1e-5.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from dqo_map_tpu.config import default_config  # noqa: E402
from dqo_map_tpu.data.synthetic import synthetic_sequence  # noqa: E402
from dqo_map_tpu.models import gaussian_map as jgm  # noqa: E402
from dqo_map_tpu.models import quadrics as jq  # noqa: E402
from dqo_map_tpu.slam import tracker as jtracker  # noqa: E402
from dqo_map_tpu.slam.icp import IcpConfig as JIcpConfig  # noqa: E402
from dqo_map_tpu.slam.icp import icp_pyramid as jicp_pyramid  # noqa: E402
from dqo_map_tpu.slam.renderer import Renderer as JRenderer  # noqa: E402
from dqo_map_tpu.slam.renderer import render_state as jrender_state  # noqa: E402
from slam_bench.reference import frame as ref_frame  # noqa: E402
from slam_bench.reference import icp as ref_icp  # noqa: E402
from slam_bench.reference import objects as ref_objects  # noqa: E402
from slam_bench.reference.gaussian_map import FIELDS, MapState  # noqa: E402
from slam_bench.reference.rasterize import RenderSettings  # noqa: E402
from slam_bench.reference.renderer import render_state  # noqa: E402

W, H = 64, 48


@pytest.fixture(scope="module")
def cams():
    return synthetic_sequence(3, width=W, height=H)[1]


def _map_from_frame(cam, n=1500, capacity=2048, seed=0):
    """Gaussians on frame `cam`'s surfaces, in its colours, as numpy
    fields: a map both packages render."""
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(cam.depth > 0)
    pick = rng.choice(len(ys), n, replace=False)
    u, v = xs[pick], ys[pick]
    z = cam.depth[v, u]
    K = cam.K
    pc = np.stack([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z,
                   z, np.ones_like(z)], -1)
    f = {k: None for k in FIELDS}
    f["xyz"] = np.zeros((capacity, 3), np.float32)
    f["xyz"][:n] = (pc @ cam.c2w.T)[:, :3]
    f["sh"] = np.zeros((capacity, 16, 3), np.float32)
    f["sh"][:n, 0] = (cam.image[v, u] - 0.5) / 0.28209479177387814
    f["sh"][:n, 1:] = rng.normal(0, 0.02, (n, 15, 3))
    f["scaling"] = np.full((capacity, 3), math.log(0.03), np.float32)
    f["scaling"][:n] += rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(capacity, 4)).astype(np.float32)
    f["rotation"] = rot
    f["opacity"] = rng.normal(1.0, 0.5, capacity).astype(np.float32)
    f["confidence"] = np.zeros(capacity, np.float32)
    for k in ("add_tick", "depth_err_cnt", "color_err_cnt", "frame_id"):
        f[k] = np.zeros(capacity, np.int32)
    f["obj_id"] = np.full(capacity, -1, np.int32)
    f["sem_rgb"] = np.zeros((capacity, 3), np.float32)
    f["status"] = np.zeros(capacity, np.int32)
    f["status"][:n] = rng.choice([jgm.UNSTABLE, jgm.STABLE], n)
    return f, n


def test_render_matches_jax(cams):
    f, n = _map_from_frame(cams[0])
    a = default_config().map
    jsettings = JRenderer(a, W, H).settings
    ref = jrender_state(
        jgm.MapState(**{k: jnp.asarray(v) for k, v in f.items()},
                     count=jnp.int32(n)),
        cams[1].render_inputs(), jsettings, "global")
    settings = RenderSettings.from_args(W, H, a)
    cam = {k: torch.as_tensor(np.asarray(v))
           for k, v in cams[1].render_inputs().items()}
    got = render_state(
        MapState(**{k: torch.as_tensor(v) for k, v in f.items()}, count=n),
        cam, settings, "global")
    same = got["depth_index_map"].numpy() == np.asarray(ref["depth_index_map"])
    assert same.mean() >= 0.995
    assert (got["depth_index_map"].numpy() >= 0).mean() > 0.5
    np.testing.assert_allclose(got["render"].numpy(), np.asarray(ref["render"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["depth"].numpy()[same],
                               np.asarray(ref["depth"])[same],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("depth_filter", [False, True])
def test_icp_matches_jax(cams, depth_filter):
    kw = dict(levels=3, min_depth=0.1, max_depth=8.0,
              invalid_confidence_thresh=0.2, depth_filter=depth_filter)
    jf = [jtracker.preprocess_frame(jnp.asarray(c.depth), jnp.asarray(c.image),
                                    jnp.asarray(c.K), **kw) for c in cams[::2]]
    rf = [ref_frame.preprocess_frame(torch.as_tensor(c.depth),
                                     torch.as_tensor(c.image),
                                     torch.as_tensor(c.K), **kw)
          for c in cams[::2]]
    for a, b in zip(rf, jf):
        for name in ("vertex_pyr", "normal_pyr"):
            for x, y in zip(a[name], b[name]):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           atol=1e-4, rtol=0, err_msg=name)
    K = cams[0].K
    j = JIcpConfig()
    pose_r, _, _ = jicp_pyramid(jf[0]["vertex_pyr"], jf[0]["normal_pyr"],
                                jf[1]["vertex_pyr"], jf[1]["normal_pyr"],
                                jnp.asarray(K), j)
    cfg = ref_icp.IcpConfig(**{k: getattr(j, k) for k in
                               ref_icp.IcpConfig._fields})
    pose_g, _, _ = ref_icp.icp_pyramid(
        rf[0]["vertex_pyr"], rf[0]["normal_pyr"], rf[1]["vertex_pyr"],
        rf[1]["normal_pyr"], torch.as_tensor(K, dtype=torch.float32), cfg)
    np.testing.assert_allclose(pose_g.numpy(), np.asarray(pose_r), atol=1e-4)


def test_refine_objects_matches_jax():
    rng = np.random.default_rng(1)
    O, CAP = jq.MAX_OBJECTS, jq.OBS_CAP
    gt_axes, gt_center = np.array([0.3, 0.2, 0.25]), np.array([0.1, -0.1, 2.0])
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    obs_bbox = np.zeros((O, CAP, 4), np.float32)
    obs_P = np.zeros((O, CAP, 3, 4), np.float32)
    obs_valid = np.zeros((O, CAP), bool)
    n = 12
    for i in range(n):
        ang = 0.15 * i
        eye = gt_center + np.array([1.5 * np.sin(ang), 0.2,
                                    -1.8 * np.cos(ang)])
        fwd = (gt_center - eye) / np.linalg.norm(gt_center - eye)
        right = np.cross(fwd, [0, -1, 0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
        c2w[:3, 3] = eye
        Rt = np.linalg.inv(c2w)[:3]
        obs_bbox[0, i] = jq.Ellipsoid(gt_axes, np.eye(3), gt_center).project(
            K @ Rt).compute_bbox()
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
    arrays = (axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask)
    jout = jq.refine_objects(*map(jnp.asarray, arrays), jnp.asarray(rand_idx),
                             iters=60)
    gout = ref_objects.refine_objects(*map(torch.as_tensor, arrays), rand_idx,
                                      iters=60)
    for k, a, b in zip(("axes", "R", "center"), gout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert not np.allclose(gout[2].detach().numpy()[0], center[0])
