"""The port's blend with the one-surface background (K1's `with_bg`
variant) and its backward (K2) against the JAX package, on the CPU.

Both run their plain versions here: the port's `BlendFunction` takes
`blend_blocks_ref` forward and `blend_bwd_ref` backward for CPU tensors;
the JAX side runs its Pallas kernels in interpret mode, as
`test_blend_pallas.py` does. The scenes, losses and tolerances are those of
`test_blend_pallas.py`:

- the background forward: colour and T to 1e-5, depth to 1e-4, index maps
  exactly; T_final as in `test_torch_rasterize.py` (where the JAX value is
  at least T_threshold, below it both are);
- the colour + depth loss and the normal loss: gradients at atol 2e-4 of
  each field's largest magnitude (`test_blend_pallas.py:92-94`), the loss
  to 1e-5 relative;
- the background loss: gradients at atol 2e-5, rtol 1e-3
  (`test_blend_pallas.py:190-191`).

`blend_bwd_ref` is also held against central finite differences of the
plain forward on a one-tile scene, with and without the background.
"""

import os

os.environ["DQO_PALLAS_INTERPRET"] = "1"

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.ops.rasterize import RenderSettings as JSettings
from dqo_map_tpu.ops.rasterize import rasterize as jrasterize
from dqo_map_tpu_torch.ops.blend import (BlendParams, blend_blocks_ref,
                                         blend_bwd_ref, tile_map,
                                         tile_px_maps)
from dqo_map_tpu_torch.ops.blend_cuda import blend_tiles
from dqo_map_tpu_torch.ops.rasterize import RenderSettings, rasterize
from test_rasterize import make_scene
from test_torch_rasterize import assert_maps_match, port_camera, t32

BG_KEYS = ("render", "T_map", "weight_sum", "color_hit_weight",
           "depth_hit_weight", "depth", "normal", "T_final",
           "depth_index_map", "color_index_map", "n_touched")


def _bg_maps(H, W):
    bgr = np.random.default_rng(5)
    return {"S": bgr.uniform(0, 1, (H, W, 3)).astype(np.float32),
            "D": bgr.uniform(1.5, 3.5, (H, W)).astype(np.float32),
            "tau": bgr.uniform(0.0, 1.0, (H, W)).astype(np.float32)}


def _jax_fn(cam, bg_maps=None, **fixed):
    """A JAX Pallas render of the scene as a function of the five
    per-gaussian arrays (those in `fixed` held)."""
    s = JSettings(width=cam.width, height=cam.height, impl="pallas",
                  max_tiles_per_gaussian=16)
    jbg = None if bg_maps is None else {k: jnp.asarray(v) for k, v in bg_maps.items()}

    def f(means, scales, q, opac, colors):
        return jrasterize(means, scales, q, opac, colors, cam.render_inputs(),
                          s, normal_w=jnp.zeros_like(means), bg_maps=jbg)
    return f


def _port_fn(cam, bg_maps=None):
    s = RenderSettings(width=cam.width, height=cam.height,
                       max_tiles_per_gaussian=16)
    bgt = None
    if bg_maps is not None:
        bgt = tile_px_maps([t32(bg_maps["S"]), t32(bg_maps["D"]),
                            t32(bg_maps["tau"])], 16, cam.width, cam.height)
    cin = port_camera(cam).render_inputs("cpu")

    def f(means, scales, q, opac, colors):
        return rasterize(means, scales, q, opac, colors, cin, s, bg_tiled=bgt)
    return f


def _leaves(scene, cls):
    _, means, scales, q, opac, colors = scene
    if cls is torch:
        return [t32(a).requires_grad_(True) for a in (means, scales, q, opac, colors)]
    return [jnp.asarray(a, jnp.float32) for a in (means, scales, q, opac, colors)]


def test_bg_forward_matches_jax_pallas(rng):
    scene = make_scene(rng, P=80, W=48, H=32)
    cam = scene[0]
    bg = _bg_maps(cam.height, cam.width)
    ref = {k: np.asarray(v) for k, v in
           _jax_fn(cam, bg)(*_leaves(scene, jnp)).items()}
    with torch.no_grad():
        got = _port_fn(cam, bg)(*(x.detach() for x in _leaves(scene, torch)))
    assert_maps_match(got, ref, BG_KEYS)
    # the surface shows: some pixels crossed it, some never did
    plain = _port_fn(cam)(*(x.detach() for x in _leaves(scene, torch)))
    assert (got["render"] - plain["render"]).abs().max() > 0.1


def test_bg_low_tau_is_cut_either_way(rng):
    """The local scans feed the stable render's T_final as tau; the port's
    T_final differs from the JAX package's only below T_threshold (it stops
    a pixel there). Any tau below T_threshold cuts every entry behind the
    surface, so such a difference leaves the render unchanged."""
    scene = make_scene(rng, P=80, W=48, H=32)
    cam = scene[0]
    bg = _bg_maps(cam.height, cam.width)
    low = bg["tau"] < 0.5
    bg["tau"] = np.where(low, 5e-5, bg["tau"]).astype(np.float32)
    other = dict(bg, tau=np.where(low, 2e-6, bg["tau"]).astype(np.float32))
    leaves = [x.detach() for x in _leaves(scene, torch)]
    a = _port_fn(cam, bg)(*leaves)
    b = _port_fn(cam, other)(*leaves)
    assert low.mean() > 0.3
    for k in ("render", "weight_sum", "depth", "depth_index_map"):
        assert torch.equal(a[k], b[k]), k


def _color_depth_loss(out, target, tdepth, lib):
    m = out["depth_index_map"] >= 0
    if lib is torch:
        return ((out["render"] - target).abs().mean()
                + 0.5 * torch.where(m, (out["depth"] - tdepth).abs(), 0.0).mean())
    return (jnp.abs(out["render"] - target).mean()
            + 0.5 * jnp.where(m, jnp.abs(out["depth"] - tdepth), 0.0).mean())


def _assert_normalized(got, ref, names):
    for name, a, b in zip(names, got, ref):
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4, err_msg=name)


def test_color_depth_gradients_match_jax_pallas(rng):
    scene = make_scene(rng, P=50, W=48, H=32)
    cam = scene[0]
    target = rng.uniform(0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    tdepth = np.full((cam.height, cam.width), 2.0, np.float32)
    jf = _jax_fn(cam)
    lj, gj = jax.value_and_grad(
        lambda *a: _color_depth_loss(jf(*a), jnp.asarray(target),
                                     jnp.asarray(tdepth), jnp),
        argnums=(0, 1, 2, 3, 4))(*_leaves(scene, jnp))
    leaves = _leaves(scene, torch)
    lp = _color_depth_loss(_port_fn(cam)(*leaves), t32(target), t32(tdepth), torch)
    gp = torch.autograd.grad(lp, leaves)
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=1e-5)
    _assert_normalized([g.numpy() for g in gp], [np.asarray(g) for g in gj],
                       ["means", "scales", "quats", "opac", "colors"])


def test_normal_gradients_match_jax_pallas(rng):
    scene = make_scene(rng, P=60, W=48, H=32)
    cam = scene[0]
    gtn = rng.normal(size=(cam.height, cam.width, 3)).astype(np.float32)
    gtn /= np.linalg.norm(gtn, axis=-1, keepdims=True)

    def loss(out, lib):
        n, m = out["normal"], out["depth_index_map"] >= 0
        norm = (torch.linalg.norm(n, dim=-1) if lib is torch
                else jnp.linalg.norm(n, axis=-1))
        cos = 1.0 - (n * lib.as_tensor(gtn) if lib is torch
                     else n * jnp.asarray(gtn)).sum(-1) / (norm + 1e-8)
        return lib.where(m, cos, 0.0).mean()

    jf = _jax_fn(cam)
    jl = _leaves(scene, jnp)
    lj, gj = jax.value_and_grad(
        lambda q: loss(jf(jl[0], jl[1], q, jl[3], jl[4]), jnp))(jl[2])
    leaves = _leaves(scene, torch)
    lp = loss(_port_fn(cam)(*leaves), torch)
    (gp,) = torch.autograd.grad(lp, [leaves[2]])
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=1e-5)
    assert np.abs(np.asarray(gj)).max() > 0
    _assert_normalized([gp.numpy()], [np.asarray(gj)], ["quats"])


def test_bg_gradients_match_jax_pallas(rng):
    scene = make_scene(rng, P=80, W=48, H=32)
    cam = scene[0]
    bg = _bg_maps(cam.height, cam.width)
    jf = _jax_fn(cam, bg)
    jl = _leaves(scene, jnp)
    gj = jax.grad(lambda m, c: jnp.abs(jf(m, jl[1], jl[2], jl[3], c)["render"]).mean(),
                  argnums=(0, 1))(jl[0], jl[4])
    leaves = _leaves(scene, torch)
    lp = _port_fn(cam, bg)(*leaves)["render"].abs().mean()
    gp = torch.autograd.grad(lp, [leaves[0], leaves[4]])
    for a, b in zip(gp, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-3)
        assert np.abs(np.asarray(b)).max() > 1e-4


# ---------------------------------------------------------------------------
# finite differences of the plain forward
# ---------------------------------------------------------------------------

PARAMS = BlendParams(0.6, 1.0, 0.5, 1e-4)


def _one_tile_entries(seed):
    """Six depth-sorted entries over one 16x16 tile, wide enough that
    every pixel of the tile sees each above the 1/255 cut: five faint ones
    and, last, an opaque one that is every pixel's hit, facing the camera
    (plane branch). No alpha cut, hit switch or T_threshold cut lies near
    the inputs, so the blend is smooth there. feats (16, 8), the last two
    slots padding."""
    r = np.random.default_rng(seed)
    n = 6
    f = np.zeros((16, n), np.float32)
    f[0] = r.uniform(4, 12, n)
    f[1] = r.uniform(4, 12, n)
    a = r.uniform(0.002, 0.006, n)
    c = r.uniform(0.002, 0.006, n)
    f[2], f[3], f[4] = a, r.uniform(-0.3, 0.3, n) * np.sqrt(a * c), c
    f[5] = np.append(r.uniform(0.2, 0.45, n - 1), 0.95)
    f[2:5, -1] = (0.001, 0.0, 0.001)
    f[6:9] = r.uniform(0, 1, (3, n))
    f[9] = np.sort(r.uniform(1.0, 3.0, n))
    nrm = np.stack([r.uniform(-0.1, 0.1, n), r.uniform(-0.1, 0.1, n),
                    -np.ones(n)])
    f[10:13] = nrm / np.linalg.norm(nrm, axis=0)
    f[13] = 0.3
    f[14] = np.arange(n)
    f[15] = f[12] * f[9]
    f = np.concatenate([f, np.zeros((16, 2), np.float32)], axis=1)
    return torch.as_tensor(f), n


@pytest.mark.parametrize("with_bg", [False, True])
def test_blend_bwd_ref_matches_finite_differences(with_bg):
    feats, n = _one_tile_entries(3)
    offs = torch.tensor([0, 8])
    counts = torch.tensor([n])
    K = torch.tensor([[12.0, 0, 8.0], [0, 12.0, 8.0], [0, 0, 1.0]])
    r = np.random.default_rng(4)
    bgt = None
    if with_bg:
        # the surface halfway between two entries' depths, per pixel
        z = feats[9, :n].numpy()
        mids = (z[:-1] + z[1:]) / 2
        bgt = torch.zeros((1, 256, 8))
        bgt[..., 0:3] = torch.as_tensor(r.uniform(0, 1, (256, 3)), dtype=torch.float32)
        bgt[..., 3] = torch.as_tensor(np.append(mids, 5.0)[r.integers(0, n, 256)])
        bgt[..., 4] = torch.as_tensor(r.uniform(0.2, 1.0, 256), dtype=torch.float32)
    weight = torch.as_tensor(r.normal(size=(1, 256, 8)), dtype=torch.float32)
    weight[..., 7] = 0.0
    bg = (0.1, 0.2, 0.3)

    def loss(f):
        color, _, _ = blend_blocks_ref(f, offs, counts, 1, 16, 16, K, PARAMS,
                                       bg, bgt)
        return float((color.double() * weight.double()).sum())

    color, aux, _ = blend_blocks_ref(feats, offs, counts, 1, 16, 16, K,
                                     PARAMS, bg, bgt)
    assert (aux[0, :, 0] == n - 1).all()          # every pixel hits the last
    got = blend_bwd_ref(feats, offs, counts, 1, 16, 16, K, PARAMS, bg, color,
                        aux, weight, bgt).numpy()
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15]
    eps = 1e-3
    fd = np.zeros_like(got)
    for row in rows:
        for e in range(n):
            up, dn = feats.clone(), feats.clone()
            up[row, e] += eps
            dn[row, e] -= eps
            fd[row, e] = (loss(up) - loss(dn)) / (2 * eps)
    assert (got[:, n:] == 0).all() and (got[13:15] == 0).all()
    # alpha terms for every entry; depth / normal terms for the hit only,
    # through the plane branch (row 9, the splat z, gets none)
    assert (got[0:9, :n] != 0).all()
    assert (got[[10, 11, 12, 15], n - 1] != 0).all()
    assert (got[9:13, :n - 1] == 0).all() and (got[15, :n - 1] == 0).all()
    np.testing.assert_allclose(got, fd, atol=3e-3 * np.abs(fd).max(),
                               rtol=2e-2)


def test_blend_function_on_cpu_runs_the_plain_versions(rng):
    """The autograd Function on CPU tensors: forward = blend_blocks_ref,
    backward = blend_bwd_ref, tiled maps = the image maps tiled."""
    scene = make_scene(rng, P=40, W=48, H=32)
    cam = scene[0]
    leaves = _leaves(scene, torch)
    out = _port_fn(cam)(*leaves)
    s = RenderSettings(width=48, height=32, max_tiles_per_gaussian=16)
    tiled = rasterize(*leaves, port_camera(cam).render_inputs("cpu"), s,
                      tiled=True)
    for k in ("render", "depth", "T_map", "depth_index_map"):
        assert torch.equal(tile_map(out[k], 16, 48, 32), tiled[k]), k
    g1 = torch.autograd.grad(out["render"].sum(), leaves[4])[0]
    g2 = torch.autograd.grad(tiled["render"].sum(), leaves[4])[0]
    assert torch.equal(g1, g2) and g1.abs().max() > 0
    assert blend_tiles.__module__.endswith("blend_cuda")


def test_blend_bwd_ref_routes_a_hit_past_the_T_cut():
    """Nineteen wide entries of alpha ~0.5, none opaque enough to be a hit,
    take every pixel's T below T_threshold; the opaque entry after them is
    the hit all the same (the pixel walks on until it has one), and the
    depth and normal cotangents reach it there (JAX `blend_pallas.py:389-
    397`). Held against finite differences of the plain forward's depth and
    normal channels."""
    feats, _ = _one_tile_entries(5)
    n = 20
    r = np.random.default_rng(6)
    f = np.zeros((16, n + 4), np.float32)
    last = feats[:, 5].numpy()
    f[:, n - 1] = last
    f[0, :n - 1] = r.uniform(6, 10, n - 1)
    f[1, :n - 1] = r.uniform(6, 10, n - 1)
    f[2, :n - 1], f[4, :n - 1] = 0.001, 0.001
    f[5, :n - 1] = 0.55
    f[6:9, :n - 1] = r.uniform(0, 1, (3, n - 1))
    f[9, :n - 1] = np.linspace(1.0, 1.9, n - 1)
    f[10:13, :n - 1] = np.array([0.0, 0.0, -1.0])[:, None]
    f[13, :n - 1] = 0.3
    f[14, :n] = np.arange(n)
    f[15, :n - 1] = -f[9, :n - 1]
    f[9, n - 1], f[15, n - 1] = 2.5, f[12, n - 1] * 2.5
    feats = torch.as_tensor(f)
    offs, counts = torch.tensor([0, n + 4]), torch.tensor([n])
    K = torch.tensor([[12.0, 0, 8.0], [0, 12.0, 8.0], [0, 0, 1.0]])
    bg = (0.1, 0.2, 0.3)
    color, aux, _ = blend_blocks_ref(feats, offs, counts, 1, 16, 16, K, PARAMS, bg)
    assert (aux[0, :, 0] == n - 1).all()                # every hit is the last
    assert (aux[0, :, 4] < 1e-3).all()                  # end_T: cut before it
    weight = torch.zeros((1, 256, 8))
    weight[..., 3:7] = torch.as_tensor(r.normal(size=(256, 4)), dtype=torch.float32)
    got = blend_bwd_ref(feats, offs, counts, 1, 16, 16, K, PARAMS, bg, color,
                        aux, weight).numpy()

    def loss(x):
        c, _, _ = blend_blocks_ref(x, offs, counts, 1, 16, 16, K, PARAMS, bg)
        return float((c.double() * weight.double()).sum())

    eps = 1e-3
    for row in (9, 10, 11, 12, 15):
        up, dn = feats.clone(), feats.clone()
        up[row, n - 1] += eps
        dn[row, n - 1] -= eps
        fd = (loss(up) - loss(dn)) / (2 * eps)
        assert got[row, n - 1] == pytest.approx(fd, rel=2e-2, abs=1e-3), row
    assert (got[[10, 11, 12, 15], n - 1] != 0).all()
    assert (got[9:13, :n - 1] == 0).all()
