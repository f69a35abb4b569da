"""K4, the render's per-Gaussian chain on the card (`ops/project_cuda.py`,
`csrc/project.cu`), and its plain backward `projection.project_bwd_ref`.

On the CPU:
- `project_bwd_ref` against `torch.autograd` of the plain chain (the
  activations, `eval_colors`, `preprocess` and the entry gather of
  `pack_entries`), with the SH colours and with colours given, the leaves
  as stored and activated: in float64 to 1e-9 (the derivation), in
  float32 over the edge cases (rows outside the frustum and behind the
  camera, at the view clamp's bounds and past them, at `tz == 0`, at
  `det == 0`, with a colour exactly 0, rows with no entry, padding
  entries, entries of a real binning);
- the binning's `cell_entry` holds each live entry's Gaussian once;
- the wrapper's argument checks raise;
- `rasterize` on the CPU with the leaves as stored (`activate=True`, SH
  colours) gives the maps and gradients of the activated inputs bit for
  bit, and launches nothing of K4; `render_state` over several renders
  gives the stored leaves the plain chain's gradients bit for bit.

On a card (marker `cuda`): K4's geometry `torch.equal` to the plain
`preprocess_ref`, its colours within rounding, its backward against
`project_bwd_ref` and the plain chain's autograd in float64, a graphed
forward and backward equal to the eager one, and one eager optimize step
within 200 kernels.

This file imports neither JAX nor the JAX package; on the card, run it
without the JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_project.py -q
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.ops import project_cuda
from dqo_map_tpu_torch.ops.blend import gather_entry_feats
from dqo_map_tpu_torch.ops.projection import preprocess_ref, project_bwd_ref
from dqo_map_tpu_torch.ops.rasterize import (RenderSettings, _activated,
                                             compute_binning, rasterize)

W_, H_ = 160, 120
LEAVES = ("means3d", "scales", "rots", "opacities", "colors")


def _cam(dtype=torch.float32, device="cpu", yaw=0.3, shift=True):
    """A pinhole camera near the origin turned by `yaw` about y, looking
    down +z (at the origin itself without `shift`), with
    Camera.render_inputs()'s keys."""
    fx = fy = 140.0
    K = np.array([[fx, 0, W_ / 2], [0, fy, H_ / 2], [0, 0, 1]])
    c, s = math.cos(yaw), math.sin(yaw)
    w2c = np.eye(4)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    if shift:
        w2c[:3, 3] = [0.05, -0.1, 0.2]
    tanx, tany = W_ / (2 * fx), H_ / (2 * fy)
    zn, zf = 0.01, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1 / tanx, 1 / tany
    proj[2, 2], proj[2, 3] = zf / (zf - zn), -zf * zn / (zf - zn)
    proj[3, 2] = 1.0
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    c2w = np.linalg.inv(w2c)
    return {"w2c": t(w2c), "full_proj": t(proj @ w2c), "K": t(K),
            "cam_pos": t(c2w[:3, 3]), "tan_fovx": np.float32(tanx),
            "tan_fovy": np.float32(tany)}


def _leaves(P, seed, dtype=torch.float32, activate=True, sh=True,
            device="cpu"):
    """Random Gaussians in front of `_cam`, as stored (log-scales, raw
    quaternions, opacity logits) or activated."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)  # noqa
    n = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa
    z = 0.5 + 4.0 * r(P)
    xyz = torch.stack([(r(P) - 0.5) * 1.6 * z, (r(P) - 0.5) * 1.2 * z, z], -1)
    scales = -4.0 + 1.5 * n(P, 3)
    rots = n(P, 4)
    opac = n(P)
    colors = 0.3 * n(P, 16, 3) if sh else r(P, 3)
    if not activate:
        scales, rots, opac = (torch.exp(scales), rots / rots.norm(
            dim=-1, keepdim=True), torch.sigmoid(opac))
    out = dict(means3d=xyz, scales=scales, rots=rots, opacities=opac,
               colors=colors)
    return {k: v.to(dtype=dtype, device=device) for k, v in out.items()}


def _settings(sh_degree=3):
    return RenderSettings(width=W_, height=H_, sh_degree=sh_degree)


def _plain_feats(lv, cam, settings, point_list, entry_valid, activate):
    """The plain chain from the leaves to the (16, L) entry features."""
    scales, rots, opac, colors = _activated(
        lv["means3d"], lv["scales"], lv["rots"], lv["opacities"],
        lv["colors"], cam, settings, activate)
    pre = preprocess_ref(lv["means3d"], scales, rots, cam,
                         settings.color_sigma, settings.width,
                         settings.height, settings.scale_modifier)
    return gather_entry_feats(point_list, entry_valid, pre.xy, pre.conic,
                              opac, colors, pre.depth, pre.mean_c,
                              pre.normal_c, pre.scale_max)


def _layout(P, R, seed, empty_rows=()):
    """A synthetic entry layout: each row 0-R entries in random cells,
    shuffled among padding entries. Returns (point_list, entry_valid,
    cell_entry)."""
    rng = np.random.default_rng(seed)
    cells = []
    for gi in range(P):
        if gi in empty_rows:
            continue
        for j in rng.choice(R, size=rng.integers(1, R + 1), replace=False):
            cells.append((j, gi))
    n_pad = len(cells) // 3 + 1
    L = len(cells) + n_pad
    slots = rng.permutation(L)
    point_list = np.array(rng.integers(0, P, size=L))
    entry_valid = np.zeros(L, bool)
    cell_entry = -np.ones((R, P), np.int32)
    for (j, gi), e in zip(cells, slots[:len(cells)]):
        point_list[e], entry_valid[e] = gi, True
        cell_entry[j, gi] = e
    return (torch.as_tensor(point_list), torch.as_tensor(entry_valid),
            torch.as_tensor(cell_entry))


def _dfeats(L, entry_valid, seed, dtype):
    """A cotangent as K2 writes one: rows 13 and 14 and padding 0."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(16, L, generator=g, dtype=torch.float64).to(dtype)
    d[13] = 0.0
    d[14] = 0.0
    return torch.where(entry_valid[None, :], d, 0.0)


def _autograd(lv, cam, settings, point_list, entry_valid, dfeats, activate):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in lv.items()}
    feats = _plain_feats(leaves, cam, settings, point_list, entry_valid,
                         activate)
    grads = torch.autograd.grad(torch.sum(feats * dfeats),
                                [leaves[k] for k in LEAVES],
                                allow_unused=True)
    return [torch.zeros_like(lv[k]) if gr is None else gr
            for k, gr in zip(LEAVES, grads)]


def _ref(lv, cam, settings, cell_entry, dfeats, activate):
    sh_degree = settings.sh_degree if lv["colors"].dim() == 3 else -1
    return project_bwd_ref(dfeats, cell_entry, *(lv[k] for k in LEAVES), cam,
                           settings.width, settings.height,
                           settings.scale_modifier, activate, sh_degree)


def _assert_close(got, want, rtol, what):
    for k, a, b in zip(LEAVES, got, want):
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        assert err <= rtol * max(scale, 1e-30), (what, k, err, scale)


@pytest.mark.parametrize("sh_degree", [3, 2, 1, 0, -1])
@pytest.mark.parametrize("activate", [True, False])
def test_bwd_ref_matches_autograd_float64(sh_degree, activate):
    """The derivation: `project_bwd_ref` is the plain chain's gradient."""
    P, R = 64, 6
    settings = _settings(max(sh_degree, 0))
    cam = _cam(torch.float64)
    lv = _leaves(P, 1 + sh_degree, torch.float64, activate, sh_degree >= 0)
    pl, ev, ce = _layout(P, R, 7, empty_rows=(3, 17))
    d = _dfeats(pl.shape[0], ev, 11, torch.float64)
    want = _autograd(lv, cam, settings, pl, ev, d, activate)
    got = _ref(lv, cam, settings, ce, d, activate)
    _assert_close(got, want, 1e-9, "float64")
    for g in got:
        assert not torch.any(g[3]) and not torch.any(g[17])


def _edge_rows(settings, cam):
    """Activated float32 leaves whose camera-frame centres sit on the
    edges of the chain: behind the camera, at tz == 0, below the near
    plane, at the view clamp's bounds and past them. The camera is `_cam`
    at the origin, so that camera and world coordinates are one."""
    limx = float(np.float32(1.3) * np.float32(cam["tan_fovx"]))
    limy = float(np.float32(1.3) * np.float32(cam["tan_fovy"]))
    pc = [[0.1, 0.1, -1.0], [0.3, -0.2, 0.0], [0.0, 0.0, 0.1],
          [limx * 2.0, 0.0, 2.0], [limx * 2.0, -limy * 2.0, 2.0],
          [-limx * 3.0, limy * 3.0, 3.0], [0.2, 0.1, 1.0],
          [-0.4, 0.3, 2.5]]
    pc = torch.tensor(pc, dtype=torch.float64)
    # the rows at the bounds: tx / tz exactly +-lim in float32
    bounds = torch.tensor([[limx, 0.25, 1.0], [-limx, -limy, 1.0],
                           [0.1, limy, 1.0]], dtype=torch.float64)
    return torch.cat([pc, bounds]).float()


def test_bwd_ref_edge_cases_float32():
    settings = _settings(3)
    cam = _cam(yaw=0.0, shift=False)
    pts = _edge_rows(settings, cam)
    P = pts.shape[0]
    lv = _leaves(P, 5, activate=True)
    lv["means3d"] = pts
    # the camera-frame x / z at the bound rows is exactly the clamp's bound
    tx, tz = pts[:, 0], pts[:, 2]
    limx = float(np.float32(1.3) * np.float32(cam["tan_fovx"]))
    assert torch.any(tx / torch.where(tz == 0, 1e-6, tz) == limx)
    assert torch.any(tz == 0)
    # a colour exactly at 0: the DC alone, C0 * dc + 0.5 == 0 in float32
    from dqo_map_tpu_torch.utils.sh import C0
    c0 = torch.tensor(C0, dtype=torch.float32)
    dc = torch.tensor(-0.5 / C0, dtype=torch.float32)
    near = [dc]
    for toward in (0.0, -1.0):
        x = dc
        for _ in range(8):
            x = torch.nextafter(x, torch.tensor(toward))
            near.append(x)
    dc = next(x for x in near if float(c0 * x + 0.5) == 0.0)
    lv["colors"][0] = 0.0
    lv["colors"][0, 0, 1] = dc
    pl, ev, ce = _layout(P, 4, 3)
    d = _dfeats(pl.shape[0], ev, 13, torch.float32)
    want = _autograd(lv, cam, settings, pl, ev, d, True)
    got = _ref(lv, cam, settings, ce, d, True)
    _assert_close(got, want, 2e-4, "edges")
    # the colour at 0 passes half its gradient to the DC
    g_dc = sum(float(d[7, e]) for e in range(pl.shape[0])
               if ev[e] and int(pl[e]) == 0)
    assert float(got[4][0, 0, 1]) == pytest.approx(float(c0) * g_dc * 0.5,
                                                   rel=1e-5)


def _degenerate_rows(n=4096, seed=0):
    """Needle-like Gaussians (one axis long, two flat) seen side-on, whose
    2D covariance is nearly rank one: in float32 some reach `det == 0`
    exactly."""
    g = torch.Generator().manual_seed(seed)
    z = 1.0 + 2.0 * torch.rand(n, generator=g)
    xyz = torch.stack([0.2 * torch.randn(n, generator=g),
                       0.2 * torch.randn(n, generator=g), z], -1)
    scales = torch.stack([torch.full((n,), 6.0), torch.full((n,), -30.0),
                          torch.full((n,), -30.0)], -1)
    scales[:, 0] += torch.rand(n, generator=g)
    rots = torch.randn(n, 4, generator=g)
    return dict(means3d=xyz, scales=scales, rots=rots,
                opacities=torch.randn(n, generator=g),
                colors=torch.rand(n, 3, generator=g))


def test_bwd_ref_at_det_zero():
    settings = _settings(3)
    cam = _cam(yaw=0.0, shift=False)
    lv = _degenerate_rows()
    scales, rots, _, _ = _activated(lv["means3d"], lv["scales"], lv["rots"],
                                    None, None, cam, settings, True)
    pre = preprocess_ref(lv["means3d"], scales, rots, cam,
                         settings.color_sigma, W_, H_)
    # det == 0 leaves the conic as (c, -b, a), whose own det is then 0
    c, nb, a = pre.conic[:, 0], pre.conic[:, 1], pre.conic[:, 2]
    zero = torch.nonzero((c * a - nb * nb == 0) & (a > 1.0) & (c > 1.0)
                         & (pre.depth > 0.2) & ~pre.valid)[:, 0]
    assert zero.numel() > 0
    rows = zero[:8]
    sub = {k: v[rows].clone() for k, v in lv.items()}
    pl, ev, ce = _layout(rows.numel(), 3, 5)
    d = _dfeats(pl.shape[0], ev, 17, torch.float32)
    want = _autograd(sub, cam, settings, pl, ev, d, True)
    got = _ref(sub, cam, settings, ce, d, True)
    _assert_close(got, want, 2e-4, "det == 0")
    assert torch.all(a[zero] > 0) and torch.all(c[zero] > 0)


def _scene_binning(P=400, seed=2):
    settings = _settings(3)
    cam = _cam()
    lv = _leaves(P, seed)
    lv["scales"] = lv["scales"] + 1.0
    b = compute_binning(lv["means3d"], lv["scales"], lv["rots"], cam,
                        settings, activate=True)
    return settings, cam, lv, b


def test_cell_entry_inverts_the_layout():
    settings, cam, lv, b = _scene_binning()
    ce = b.cell_entry
    R, P = ce.shape
    assert (R, P) == (settings.max_tiles_per_gaussian, lv["means3d"].shape[0])
    assert ce.dtype == torch.int32
    live = torch.nonzero(b.entry_valid)[:, 0]
    got = ce[ce >= 0].long()
    assert sorted(got.tolist()) == live.tolist()      # each live entry once
    cols = torch.nonzero(ce >= 0)[:, 1]
    assert torch.equal(b.point_list[got], cols)       # in its gaussian's row


def test_bwd_ref_matches_autograd_on_a_binning():
    settings, cam, lv, b = _scene_binning()
    assert b.num_entries > 100
    d = _dfeats(b.demand, b.entry_valid, 19, torch.float32)
    want = _autograd(lv, cam, settings, b.point_list, b.entry_valid, d, True)
    got = _ref(lv, cam, settings, b.cell_entry, d, True)
    _assert_close(got, want, 2e-4, "binning")


# ---------------------------------------------------------------------------
# the wrapper's checks
# ---------------------------------------------------------------------------

def _spec(sh_degree=3):
    return project_cuda.make_spec(_cam(), _settings(max(sh_degree, 0)),
                                  torch.zeros(1, 16, 3) if sh_degree >= 0
                                  else None, True)


BAD = {
    "cpu tensors": ({}, "runs on the card"),
    "float64 means": ({"means3d": lambda lv: lv["means3d"].double()},
                      "float32"),
    "short scales": ({"scales": lambda lv: lv["scales"][:-1]}, "scales"),
    "quaternion of 3": ({"rots": lambda lv: lv["rots"][:, :3]}, "rots"),
    "colours of 4": ({"colors": lambda lv: torch.zeros(8, 16, 4)}, "sh"),
    "strided scales": ({"scales": lambda lv: torch.zeros(8, 6)[:, ::2]},
                       "contiguous"),
    "flat means": ({"means3d": lambda lv: lv["means3d"].reshape(-1)},
                   "means3d"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_checks_raise(case):
    lv = _leaves(8, 0)
    change, match = BAD[case]
    for k, f in change.items():
        lv[k] = f(lv)
    with pytest.raises(ValueError, match=match):
        project_cuda.project_fwd(*(lv[k] for k in LEAVES), _cam(), _spec())


def test_wrapper_checks_sh_degree_and_mask():
    lv = _leaves(8, 0)
    with pytest.raises(ValueError, match="degree 0-3"):
        project_cuda._check_leaves(*(lv[k] for k in LEAVES), None,
                                   _spec()._replace(sh_degree=4))
    with pytest.raises(ValueError, match="valid_mask"):
        project_cuda._check_leaves(*(lv[k] for k in LEAVES),
                                   torch.ones(8, dtype=torch.uint8), _spec())
    with pytest.raises(ValueError, match="colors"):
        project_cuda._check_leaves(*(lv[k] for k in LEAVES), None,
                                   _spec(-1))


def test_pack_and_bwd_checks_raise():
    table = torch.zeros(project_cuda.TABLE_ROWS, 5)
    with pytest.raises(ValueError, match="runs on the card"):
        project_cuda.project_pack(table, torch.zeros(3, dtype=torch.int64),
                                  torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="table"):
        project_cuda.project_pack(table[:16],
                                  torch.zeros(3, dtype=torch.int64),
                                  torch.ones(3, dtype=torch.bool))
    lv = _leaves(5, 0)
    with pytest.raises(ValueError, match="runs on the card"):
        project_cuda.project_bwd(torch.zeros(16, 3),
                                 torch.zeros(4, 5, dtype=torch.int32),
                                 *(lv[k] for k in LEAVES), _cam(), _spec())


# ---------------------------------------------------------------------------
# the CPU path as it was
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("colors", ["sh", "precomp"])
def test_cpu_rasterize_of_stored_leaves_is_bit_for_bit(colors):
    """`rasterize` of the leaves as stored equals `rasterize` of the leaves
    activated by the plain chain, maps and gradients bit for bit, and
    launches nothing of K4."""
    settings, cam, lv, b = _scene_binning()
    if colors == "precomp":
        lv["colors"] = torch.rand(lv["means3d"].shape[0], 3,
                                  generator=torch.Generator().manual_seed(4))
    mask = torch.ones(lv["means3d"].shape[0], dtype=torch.bool)
    mask[::7] = False
    launches = dict(project_cuda.LAUNCHES)

    def render(activate):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in lv.items()}
        args = dict(leaves)
        if not activate:
            args["scales"], args["rots"], args["opacities"], args["colors"] = (
                _activated(args["means3d"], args["scales"], args["rots"],
                           args["opacities"], args["colors"], cam, settings,
                           True))
        out = rasterize(cam=cam, settings=settings, valid_mask=mask,
                        activate=activate, **args)
        loss = (out["render"].sum() + out["depth"].sum()
                + out["normal"].sum())
        grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES])
        return out, grads

    new, g_new = render(True)
    old, g_old = render(False)
    for k, v in old.items():
        if torch.is_tensor(v):
            assert torch.equal(new[k], v), k
        else:
            assert new[k] == v, k
    for k, a, c in zip(LEAVES, g_new, g_old):
        assert torch.equal(a, c), k
    assert project_cuda.LAUNCHES == launches


def test_cpu_binning_of_stored_leaves_is_bit_for_bit():
    settings, cam, lv, b = _scene_binning()
    scales, rots, _, _ = _activated(lv["means3d"], lv["scales"], lv["rots"],
                                    None, None, cam, settings, True)
    old = compute_binning(lv["means3d"], scales, rots, cam, settings)
    for k, v in old._asdict().items():
        if torch.is_tensor(v):
            assert torch.equal(getattr(b, k), v), k
        else:
            assert getattr(b, k) == v, k


@pytest.mark.parametrize("spare", [0, 9])
def test_cpu_render_state_gradients_over_renders_are_bit_for_bit(spare):
    """Three renders of one MapState through `render_state` (the leaves as
    stored) give the stored leaves the plain chain's gradients bit for
    bit: the alive prefix sliced, activated and its SH evaluated before
    `rasterize`, as `state_render_args` did before K4. With the map full
    (`spare` 0) too: there the slice's backward still sums each render's
    gradients before they reach the leaf, whose order a multi-frame scan's
    sum depends on."""
    from dqo_map_tpu_torch.models.gaussian_map import (STABLE, MapState,
                                                       empty_map)
    from dqo_map_tpu_torch.ops.rasterize import eval_colors
    from dqo_map_tpu_torch.slam.renderer import render_state, subset_mask
    from dqo_map_tpu_torch.utils.math3d import normalize

    settings = _settings(3)
    lv = _leaves(300, 5)
    P = lv["means3d"].shape[0]
    base = empty_map(P + spare, device="cpu")
    stored = {"xyz": "means3d", "sh": "colors", "scaling": "scales",
              "rotation": "rots", "opacity": "opacities"}
    cams = [_cam(yaw=y) for y in (0.3, 0.1, -0.2)]

    def grads(plain):
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(MapState)}
        for f, k in stored.items():
            v = fields[f].clone()
            v[:P] = lv[k] + (1.0 if f == "scaling" else 0.0)
            fields[f] = v.requires_grad_(True)
        status = fields["status"].clone()
        status[:P] = STABLE
        fields["status"], fields["count"] = status, P
        state = MapState(**fields)
        loss = 0.0
        for cam in cams:
            if plain:
                B = state.count
                xyz = state.xyz[:B]
                scales = torch.exp(state.scaling[:B])
                rots = normalize(state.rotation[:B])
                colors = eval_colors(state.sh[:B], xyz, cam["cam_pos"],
                                     settings.sh_degree)
                out = rasterize(xyz, scales, rots,
                                torch.sigmoid(state.opacity[:B]), colors,
                                cam, settings,
                                valid_mask=subset_mask(state, "global")[:B])
            else:
                out = render_state(state, cam, settings)
            loss = loss + out["render"].sum() + out["depth"].sum()
        return torch.autograd.grad(loss, [fields[f] for f in stored])

    for f, a, b in zip(stored, grads(False), grads(True)):
        assert torch.equal(a, b), f


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("K4 runs on a CUDA card")
    return torch.device("cuda")


def _explore_like(device, P=60000, seed=22):
    """A map like explore's at its quality frame: ~60k Gaussians, most in
    view, at 1200x680."""
    settings = RenderSettings(width=1200, height=680, sh_degree=3)
    fx = 600.0
    K = torch.tensor([[fx, 0, 599.5], [0, fx, 339.5], [0, 0, 1]])
    cam = _cam()
    tanx, tany = 1200 / (2 * fx), 680 / (2 * fx)
    proj = torch.zeros(4, 4, dtype=torch.float64)
    proj[0, 0], proj[1, 1] = 1 / tanx, 1 / tany
    proj[2, 2], proj[2, 3], proj[3, 2] = 100 / 99.99, -1 / 99.99, 1.0
    cam = {"w2c": cam["w2c"].to(device), "K": K.to(device),
           "full_proj": (proj @ cam["w2c"].double()).float().to(device),
           "cam_pos": cam["cam_pos"].to(device),
           "tan_fovx": np.float32(tanx), "tan_fovy": np.float32(tany)}
    lv = _leaves(P, seed, device=device)
    lv["means3d"][:, 0] *= 1.6
    lv["scales"] = lv["scales"] + 1.0
    return settings, cam, lv


@pytest.mark.cuda
@pytest.mark.parametrize("activate", [False, True])
def test_card_geometry_equals_plain_preprocess(card, activate):
    settings, cam, lv = _explore_like(card)
    if not activate:
        lv["scales"], lv["rots"], lv["opacities"], _ = _activated(
            lv["means3d"], lv["scales"], lv["rots"], lv["opacities"], None,
            cam, settings, True)
    mask = torch.rand(lv["means3d"].shape[0], device=card) < 0.9
    table, valid = project_cuda.project_fwd(
        *(lv[k] for k in LEAVES), cam,
        project_cuda.make_spec(cam, settings, lv["colors"], activate), mask)
    got = project_cuda.preprocessed(table, valid)
    scales, rots, opac, colors = _activated(
        lv["means3d"], lv["scales"], lv["rots"], lv["opacities"],
        lv["colors"], cam, settings, activate)
    want = preprocess_ref(lv["means3d"], scales, rots, cam,
                          settings.color_sigma, settings.width,
                          settings.height)
    want = want._replace(valid=want.valid & mask,
                         radius=torch.where(mask, want.radius, 0.0))
    torch.cuda.synchronize()
    for k, v in want._asdict().items():
        assert torch.equal(getattr(got, k), v), k
    assert torch.equal(table[5], opac)
    ndm = (want.mean_c[:, 0] * want.normal_c[:, 0]
           + want.mean_c[:, 1] * want.normal_c[:, 1]
           + want.mean_c[:, 2] * want.normal_c[:, 2])
    assert torch.equal(table[15], ndm)
    # the colours: the SH terms in order, torch.sum's own order otherwise
    assert torch.allclose(table[6:9].T, colors, rtol=0, atol=2e-6)


def _rel_errors(grads, truth):
    """Each leaf's relative L2 error against `truth`."""
    return [float((g.double() - t).norm()) / max(float(t.norm()), 1e-300)
            for g, t in zip(grads, truth)]


@pytest.mark.cuda
@pytest.mark.parametrize("colors", ["sh", "precomp"])
def test_card_backward_against_ref_and_autograd(card, colors):
    """K4's backward against `project_bwd_ref` on the same card (the same
    operations, rounded alike but for the sums' order: 1e-5 of each
    leaf's largest gradient), and against the plain chain's autograd in
    float64: no further from it than twice the float32 autograd's own
    distance, plus 1e-6, by each leaf's relative L2 error. Flat Gaussians
    make the covariance's gradient ill-conditioned: there both float32
    paths stray from float64 by up to a few tenths of a percent."""
    settings, cam, lv = _explore_like(card, P=20000)
    if colors == "precomp":
        lv["colors"] = torch.rand(lv["means3d"].shape[0], 3, device=card)
    b = compute_binning(lv["means3d"], lv["scales"], lv["rots"], cam,
                        settings, activate=True)
    d = _dfeats(b.demand, b.entry_valid.cpu(), 23, torch.float32).to(card)
    spec = project_cuda.make_spec(cam, settings, lv["colors"], True)
    got = project_cuda.project_bwd(d, b.cell_entry, *(lv[k] for k in LEAVES),
                                   cam, spec)
    ref = _ref(lv, cam, settings, b.cell_entry, d, True)
    _assert_close(got, ref, 1e-5, "ref")
    auto32 = _autograd(lv, cam, settings, b.point_list, b.entry_valid, d,
                       True)
    cam64 = {k: v.double() if torch.is_tensor(v) else v
             for k, v in cam.items()}
    truth = _autograd({k: v.double() for k, v in lv.items()}, cam64,
                      settings, b.point_list, b.entry_valid, d.double(), True)
    for k, e, e32 in zip(LEAVES, _rel_errors(got, truth),
                         _rel_errors(auto32, truth)):
        assert e <= 2.0 * e32 + 1e-6, (k, e, e32)


def _step(lv, cam, settings, b, d):
    """K4 forward (fwd, pack) and backward through `rasterize`'s route."""
    leaves = [lv[k].detach().requires_grad_(True) for k in LEAVES]
    _, _, feats = project_cuda.blend_inputs(*leaves, cam, settings, None,
                                            True, lambda pre: b)
    return [feats] + list(torch.autograd.grad(torch.sum(feats * d), leaves))


@pytest.mark.cuda
def test_card_graphed_step_equals_eager(card):
    settings, cam, lv = _explore_like(card, P=20000)
    b = compute_binning(lv["means3d"], lv["scales"], lv["rots"], cam,
                        settings, activate=True)
    d = _dfeats(b.demand, b.entry_valid.cpu(), 29, torch.float32).to(card)
    static = {k: v.clone() for k, v in lv.items()}
    eager = _step(lv, cam, settings, b, d)
    launches = dict(project_cuda.LAUNCHES)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        g.capture_begin()
        outs = _step(static, cam, settings, b, d)
        g.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    assert project_cuda.LAUNCHES == {k: v + 1 for k, v in launches.items()}
    # a replay at other parameters, then at the first ones again
    for k in static:
        static[k].copy_(lv[k] * 1.01)
    g.replay()
    first = [o.clone() for o in outs]
    moved = _step({k: v * 1.01 for k, v in lv.items()}, cam, settings, b, d)
    for k in static:
        static[k].copy_(lv[k])
    g.replay()
    torch.cuda.synchronize()
    for a, c in zip(first, moved):
        assert torch.equal(a, c)
    for a, c in zip(outs, eager):
        assert torch.equal(a, c)
    assert not torch.equal(moved[1], eager[1])


@pytest.mark.cuda
def test_card_eager_scan_step_launches_at_most_200(card, tmp_path,
                                                   monkeypatch):
    """One eager `_grads` step of a local scan (its forward through K4 and
    K1, the loss and its backward through K2 and K4), counted by the
    profiler: at most 200 kernels, memsets and copies."""
    from torch.profiler import ProfilerActivity, profile

    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam import mapper
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    run = dict(type="Synthetic", use_gt_pose=False, use_orb_backend=False,
               use_object=False, capacity=16384, add_capacity=4096,
               uniform_sample_num=1000, gaussian_update_frame=2,
               gaussian_update_iter=4, stable_confidence_thres=2,
               global_keyframe_num=3, min_depth=0.1, max_depth=8.0,
               memory_length=5, keyframe_theta_thes=1.0,
               keyframe_trans_thes=10.0, sync_tracker2mapper_method="strict")
    _, cams = synthetic_sequence(4, width=160, height=120)
    system = SLAMSystem(default_config(save_path=str(tmp_path), **run),
                        cameras=cams, device=card)
    grads, counts = mapper._grads, []

    def profiled(*a, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = grads(*a, **kw)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type.name == "CUDA"))
        return out

    monkeypatch.setattr(mapper, "capture_plan",
                        lambda idx: [mapper.EAGER] * len(idx))
    monkeypatch.setattr(mapper, "_grads", profiled)
    for i, cam in enumerate(cams):
        system.step(cam, i)
        system.mapping.time += 1
    assert len(counts) >= 4, counts
    assert max(counts[1:]) <= 200, counts
