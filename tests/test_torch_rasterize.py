"""The port's rasterizer (`dqo_map_tpu_torch.ops`) against the JAX package.

Scenes come from `test_rasterize.make_scene`, made from a seed with numpy,
and go through both packages on the CPU. The JAX side renders with its
plain blend (`impl="ref"`) and with its Pallas kernel in interpret mode,
as `test_blend_pallas.py` runs it. Tolerances are the JAX package's own
(`test_blend_pallas.py`): 1e-5 on colour, T and weights, 1e-4 on depth,
exact on index maps, n_touched and the binning. T_final is held to 1e-5
where the JAX T_final is at least T_threshold (no pixel stopped there, so
both sides walked the same entries); below it the port stops a pixel where
it is done and the JAX blends to its block or tile end, so there both are
only held below T_threshold.

One scene, 56x40, is ragged: its last tile row and column lie partly
outside the image, so edge-tile binning and the crop of the tiled maps are
held against the JAX package too.
"""

import os

os.environ["DQO_PALLAS_INTERPRET"] = "1"

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.ops import binning as jbinning
from dqo_map_tpu.ops.projection import preprocess as jpreprocess
from dqo_map_tpu.ops.rasterize import RenderSettings as JSettings
from dqo_map_tpu.ops.rasterize import rasterize as jrasterize
from dqo_map_tpu_torch.models.cameras import Camera
from dqo_map_tpu_torch.ops import binning
from dqo_map_tpu_torch.ops.projection import preprocess
from dqo_map_tpu_torch.ops.rasterize import RenderSettings, rasterize
from oracle_rasterizer import oracle_render
from test_rasterize import make_scene

FLOAT_TOL = {"render": 1e-5, "T_map": 1e-5, "weight_sum": 1e-5,
             "color_hit_weight": 1e-5, "depth_hit_weight": 1e-5,
             "depth": 1e-4, "normal": 1e-5, "T_final": 1e-5}
T_THRESHOLD = 1e-4    # RenderSettings.T_threshold of both packages
EXACT = ("depth_index_map", "color_index_map", "n_touched")
RECEIPTS = ("tile_dropped", "clipped_cells", "num_entries", "entry_demand")

SCENES = {
    "48x32": dict(P=80, W=48, H=32),
    "64x48": dict(P=160, W=64, H=48),
    "56x40": dict(P=120, W=56, H=40),
}


def port_camera(cam) -> Camera:
    """The port's Camera of a JAX-package camera."""
    return Camera(uid=cam.uid, c2w=np.array(cam.c2w), fx=cam.fx, fy=cam.fy,
                  cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height,
                  image=cam.image, depth=cam.depth, pose_gt=cam.pose_gt,
                  timestamp=cam.timestamp)


def t32(a, device="cpu"):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def assert_maps_match(port: dict, ref: dict, keys=None):
    """Port render maps against the JAX package's at the tolerances above."""
    for k in keys or (*FLOAT_TOL, *EXACT):
        a = port[k].cpu().numpy() if torch.is_tensor(port[k]) else port[k]
        b = np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k in EXACT:
            assert (a == b).all(), f"{k}: {(a != b).sum()} differ"
        elif k == "T_final":
            walked = b >= T_THRESHOLD
            np.testing.assert_allclose(a[walked], b[walked], atol=FLOAT_TOL[k],
                                       rtol=0, err_msg=k)
            assert (a[~walked] < T_THRESHOLD).all(), k
        else:
            np.testing.assert_allclose(a, b, atol=FLOAT_TOL[k], rtol=0, err_msg=k)


def jax_render(scene, impl, tile_mask=None):
    cam, means, scales, q, opac, colors = scene
    s = JSettings(width=cam.width, height=cam.height, impl=impl,
                  max_tiles_per_gaussian=16)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    out = jrasterize(f(means), f(scales), f(q), f(opac), f(colors),
                     cam.render_inputs(), s,
                     tile_mask=None if tile_mask is None else jnp.asarray(tile_mask))
    return {k: np.asarray(v) for k, v in out.items()}


def port_render(scene, tile_mask=None):
    cam, means, scales, q, opac, colors = scene
    s = RenderSettings(width=cam.width, height=cam.height,
                       max_tiles_per_gaussian=16)
    return rasterize(t32(means), t32(scales), t32(q), t32(opac), t32(colors),
                     port_camera(cam).render_inputs("cpu"), s,
                     tile_mask=None if tile_mask is None else torch.as_tensor(tile_mask))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_preprocess_matches_jax(rng, name):
    cam, means, scales, q, opac, colors = make_scene(rng, **SCENES[name])
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = jpreprocess(f(means), f(scales), f(q), cam.render_inputs(), 3.0,
                      cam.width, cam.height)
    got = preprocess(t32(means), t32(scales), t32(q),
                     port_camera(cam).render_inputs("cpu"), 3.0,
                     cam.width, cam.height)
    assert (got.valid.numpy() == np.asarray(ref.valid)).all()
    for field in ("xy", "conic", "depth", "radius", "mean_c", "normal_c",
                  "scale_max", "ext"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("name,masked", [("48x32", False), ("64x48", False),
                                         ("56x40", False), ("48x32", True),
                                         ("56x40", True)])
def test_binning_matches_jax(rng, name, masked):
    cam, means, scales, q, opac, colors = make_scene(rng, **SCENES[name])
    TH, TW = binning.tile_grid_size(cam.width, cam.height, 16)
    tile_mask = (rng.uniform(size=(TH, TW)) < 0.5).astype(np.int32) if masked else None
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    jpre = jpreprocess(f(means), f(scales), f(q), cam.render_inputs(), 3.0,
                       cam.width, cam.height)
    ref = jbinning.bin_gaussians(
        jpre, cam.width, cam.height, 16, 16,
        None if tile_mask is None else jnp.asarray(tile_mask),
        align=256, entry_cap=1 << 14, max_chunks=32)
    pre = preprocess(t32(means), t32(scales), t32(q),
                     port_camera(cam).render_inputs("cpu"), 3.0,
                     cam.width, cam.height)
    got = binning.bin_gaussians(
        pre, cam.width, cam.height, 16, 16,
        None if tile_mask is None else torch.as_tensor(tile_mask),
        align=256, max_chunks=32)
    L = got.demand
    assert L == int(ref.demand) and L % 256 == 0
    assert int(ref.dropped) == got.dropped == 0
    for field in ("num_entries", "tile_dropped", "clipped"):
        assert getattr(got, field) == int(getattr(ref, field)), field
    assert (got.tile_offsets.numpy() == np.asarray(ref.tile_offsets)).all()
    for field in ("point_list", "entry_tile", "entry_valid"):
        assert (getattr(got, field).numpy()
                == np.asarray(getattr(ref, field))[:L]).all(), field
    # the JAX layout's tail past `demand` is unused
    assert not np.asarray(ref.entry_valid)[L:].any()
    assert (got.block_tile.numpy() == np.asarray(ref.block_tile)[:L // 256]).all()
    assert (np.asarray(ref.block_tile)[L // 256:] == -1).all()


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax(rng, name, impl):
    scene = make_scene(rng, **SCENES[name])
    ref = jax_render(scene, impl)
    got = port_render(scene)
    assert_maps_match(got, ref)
    assert int(np.asarray(ref["n_touched"]).sum()) > 0
    for k in RECEIPTS:
        assert got[k] == int(ref[k]), k
    assert got["dropped_entries"] == int(ref["dropped_entries"]) == 0


TILE_MASKS = {
    "48x32": np.array([[1, 0, 1], [0, 1, 0]], np.int32),
    "56x40": np.array([[1, 0, 1, 1], [0, 1, 0, 1], [1, 1, 0, 1]], np.int32),
}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_render_with_tile_mask_matches_jax(rng, name, impl):
    W, H = SCENES[name]["W"], SCENES[name]["H"]
    scene = make_scene(rng, P=60, W=W, H=H)
    tm = TILE_MASKS[name]
    ref = jax_render(scene, impl, tile_mask=tm)
    got = port_render(scene, tile_mask=tm)
    assert_maps_match(got, ref)
    # masked-off tiles render nothing
    assert got["render"][:16, 16:32].abs().max() == 0.0


def test_render_matches_oracle(rng):
    """float32 port against the sequential float64 oracle, at the loose
    tolerance of `test_rasterize.test_forward_f32_close`."""
    scene = make_scene(rng)
    cam, means, scales, q, opac, colors = scene
    got = port_render(scene)
    ref = oracle_render(
        means, scales, q, opac, colors, cam.w2c.astype(np.float64),
        cam.full_proj.astype(np.float64), cam.K.astype(np.float64),
        cam.width, cam.height, max_tiles_per_gaussian=16)
    np.testing.assert_allclose(got["render"].numpy(), ref["render"], atol=0.05)
    np.testing.assert_allclose(got["T_map"].numpy(), ref["T_map"], atol=0.05)
    assert (got["depth_index_map"].numpy() == ref["depth_index_map"]).mean() > 0.98
