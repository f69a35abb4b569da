"""The port's hand-written kernels against their plain PyTorch versions:
K1, the forward blend (`csrc/blend_fwd.cu`), with and without the
one-surface background, and K2, its backward (`csrc/blend_bwd.cu`), both
variants.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; on the card, run it alone and without the
JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The comparisons need a CUDA card (marker `cuda`) and skip without one.

- K1: the plain version repeats the kernel's float operations in its order
  (the library is built without FMA contraction), so colour, T and weights
  agree to 1e-5, depth to 1e-4 (the JAX package's tolerances) and the index
  maps and n_touched exactly.
- K2: each thread's terms are the plain version's, in its order, but the
  CTA sums an entry's terms over the tile's 256 pixels in another order (a
  shuffle tree per warp, then the eight warp sums) than the plain version's
  `torch.sum`. So the zero structure must match exactly, and each gradient
  row to 1e-4 of that row's largest magnitude: 256 float32 terms summed in
  two orders differ by at most about 256 x 6e-8 = 1.5e-5 of the largest
  term.
"""

import math

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.models.cameras import Camera
from dqo_map_tpu_torch.ops import binning
from dqo_map_tpu_torch.ops.blend import (GRAD_ROWS, BlendParams,
                                         blend_blocks_ref, blend_bwd_ref,
                                         blend_tiles_ref)
from dqo_map_tpu_torch.ops.blend_cuda import (LAUNCHES, blend_bwd, blend_fwd,
                                              blend_tiles, pack_entries,
                                              unpack_blocks)
from dqo_map_tpu_torch.ops.projection import preprocess

TOL = {"render": 1e-5, "T_map": 1e-5, "weight_sum": 1e-5,
       "color_hit_weight": 1e-5, "depth_hit_weight": 1e-5, "depth": 1e-4,
       "normal_c": 1e-5, "T_final": 1e-5}
EXACT = ("depth_index_map", "color_index_map", "n_touched_entries")
PARAMS = BlendParams(0.6, 1.0, 0.5, 1e-4)


def scene_entries(device, P=3000, W=200, H=136, seed=5, masked=False):
    """Binned, packed entries of a random scene of flat splats; with
    `masked`, a random half of the tiles is masked off and left empty."""
    rng = np.random.default_rng(seed)
    cam = Camera(uid=0, c2w=np.eye(4), fx=0.75 * W, fy=0.75 * W, cx=W / 2,
                 cy=H / 2, width=W, height=H)
    means = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.8, 0.8, P),
                      rng.uniform(1.0, 4.0, P)], -1)
    scales = np.exp(rng.uniform(math.log(0.01), math.log(0.08), (P, 3)))
    scales[:, 2] *= 0.1
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    cin = cam.render_inputs(device)
    pre = preprocess(t(means), t(scales), t(q), cin, 3.0, W, H)
    tile_mask = None
    if masked:
        tile_mask = torch.as_tensor(
            rng.uniform(size=binning.tile_grid_size(W, H, 16)) < 0.5,
            device=device)
    b = binning.bin_gaussians(pre, W, H, 16, 16, tile_mask)
    feats = pack_entries(pre, b, t(rng.uniform(0, 1, (P, 3))),
                         t(rng.uniform(0.2, 0.99, P)))
    return feats, b, cin["K"], W, H


def test_blend_fwd_refuses_cpu_tensors():
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    with pytest.raises(ValueError):
        blend_fwd(feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
                  (0.0, 0.0, 0.0))
    # CPU tensors take the plain version, through the same entry point
    out = blend_tiles(feats, b.tile_offsets, b.tile_counts, T, 16, W, H, K,
                      PARAMS, (0.0, 0.0, 0.0))
    assert out["render"].shape == (H, W, 3)
    assert int(out["n_touched_entries"].sum()) > 0


def test_blend_skips_padding_exactly():
    """Walking only each tile's live entries gives the same maps, bit for
    bit, as walking its padding too (opacity 0: skipped, T unchanged); the
    padding's n_touched is 0."""
    feats, b, K, W, H = scene_entries("cpu", P=400, W=64, H=48)
    T = b.tile_offsets.shape[0] - 1
    padded = b.tile_offsets[1:] - b.tile_offsets[:-1]
    assert int(padded.sum()) > b.num_entries == int(b.tile_counts.sum())
    live = blend_tiles_ref(feats, b.tile_offsets, b.tile_counts, T, 16, W, H,
                           K, PARAMS, (0.2, 0.3, 0.4))
    full = blend_tiles_ref(feats, b.tile_offsets, padded, T, 16, W, H, K,
                           PARAMS, (0.2, 0.3, 0.4))
    for k, v in full.items():
        assert torch.equal(live[k], v), k
    assert int(live["n_touched_entries"][~b.entry_valid].abs().sum()) == 0


def bg_operand(n_tiles: int, device, seed=7):
    """A one-surface background (T, 256, 8): colour S, depth D inside the
    scene's depth range (so entries lie on both sides), tau in [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    bgt = torch.zeros((n_tiles, 256, 8))
    bgt[..., 0:3] = torch.rand((n_tiles, 256, 3), generator=g)
    bgt[..., 3] = 1.0 + 3.0 * torch.rand((n_tiles, 256), generator=g)
    bgt[..., 4] = torch.rand((n_tiles, 256), generator=g)
    return bgt.to(device)


def test_blend_bwd_refuses_cpu_tensors():
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    color, aux, _ = blend_blocks_ref(feats, b.tile_offsets, b.tile_counts, T,
                                     16, W, K, PARAMS, (0.0, 0.0, 0.0))
    with pytest.raises(ValueError):
        blend_bwd(feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
                  (0.0, 0.0, 0.0), color, aux, torch.ones_like(color))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the blend kernel runs only on a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_blend_kernel_matches_plain_version(cuda_device, masked):
    feats, b, K, W, H = scene_entries(cuda_device, masked=masked)
    T = b.tile_offsets.shape[0] - 1
    bg = (0.2, 0.3, 0.4)
    launches = LAUNCHES["blend_fwd"]
    got = unpack_blocks(*blend_fwd(feats, b.tile_offsets, b.tile_counts, T,
                                   16, W, K, PARAMS, bg), 16, W, H)
    torch.cuda.synchronize()
    assert LAUNCHES["blend_fwd"] == launches + 1
    ref = blend_tiles_ref(feats, b.tile_offsets, b.tile_counts, T, 16, W, H,
                          K, PARAMS, bg)
    # masked-off tiles have no entries: the kernel writes their init values
    assert int((b.tile_counts == 0).sum()) > 0 or not masked
    assert int(ref["n_touched_entries"].sum()) > 0
    for k, v in ref.items():
        a, r = got[k].cpu().numpy(), v.cpu().numpy()
        assert a.shape == r.shape, k
        if k in EXACT:
            assert (a == r).all(), f"{k}: {(a != r).sum()} differ"
        else:
            np.testing.assert_allclose(a, r, atol=TOL[k], rtol=0, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_blend_bg_kernel_matches_plain_version(cuda_device, masked):
    feats, b, K, W, H = scene_entries(cuda_device, masked=masked)
    T = b.tile_offsets.shape[0] - 1
    bg = (0.2, 0.3, 0.4)
    bgt = bg_operand(T, cuda_device)
    launches = dict(LAUNCHES)
    got = unpack_blocks(*blend_fwd(feats, b.tile_offsets, b.tile_counts, T,
                                   16, W, K, PARAMS, bg, bgt), 16, W, H)
    torch.cuda.synchronize()
    assert LAUNCHES["blend_fwd_bg"] == launches["blend_fwd_bg"] + 1
    assert LAUNCHES["blend_fwd"] == launches["blend_fwd"]
    ref = blend_tiles_ref(feats, b.tile_offsets, b.tile_counts, T, 16, W, H,
                          K, PARAMS, bg, bgt)
    plain = blend_tiles_ref(feats, b.tile_offsets, b.tile_counts, T, 16, W, H,
                            K, PARAMS, bg)
    # the surface shows through
    assert float((ref["render"] - plain["render"]).abs().max()) > 0.1
    for k, v in ref.items():
        a, r = got[k].cpu().numpy(), v.cpu().numpy()
        assert a.shape == r.shape, k
        if k in EXACT:
            assert (a == r).all(), f"{k}: {(a != r).sum()} differ"
        else:
            np.testing.assert_allclose(a, r, atol=TOL[k], rtol=0, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bg", [False, True])
def test_blend_bwd_kernel_matches_plain_version(cuda_device, with_bg):
    feats, b, K, W, H = scene_entries(cuda_device)
    T = b.tile_offsets.shape[0] - 1
    bg = (0.2, 0.3, 0.4)
    bgt = bg_operand(T, cuda_device) if with_bg else None
    color, aux, _ = blend_fwd(feats, b.tile_offsets, b.tile_counts, T, 16, W,
                              K, PARAMS, bg, bgt)
    g = torch.Generator().manual_seed(11)
    dcolor = torch.randn((T, 256, 8), generator=g).to(cuda_device)
    dcolor[..., 7] = 0.0
    args = (feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS, bg,
            color, aux, dcolor)
    name = "blend_bwd_bg" if with_bg else "blend_bwd"
    launches = LAUNCHES[name]
    got = blend_bwd(*args, bgt=bgt)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == launches + 1
    ref = blend_bwd_ref(*args, bgt=bgt)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert ((got != 0) == (ref != 0)).all(), int(((got != 0) != (ref != 0)).sum())
    assert (got[[13, 14]] == 0).all() and (got[:, ~b.entry_valid.cpu().numpy()] == 0).all()
    for r in GRAD_ROWS:
        scale = np.abs(ref[r]).max()
        assert scale > 0, r
        np.testing.assert_allclose(got[r], ref[r], atol=1e-4 * scale, rtol=0,
                                   err_msg=f"row {r}")


@pytest.mark.cuda
def test_blend_bwd_kernel_routes_a_hit_past_the_T_cut(cuda_device):
    """One tile: nineteen wide entries of alpha ~0.5 take T below
    T_threshold before the opaque entry that is every pixel's hit; K2 must
    route the depth and normal cotangents to it there, as its plain
    version does."""
    n = 20
    r = np.random.default_rng(6)
    f = np.zeros((16, n + 4), np.float32)
    f[0, :n], f[1, :n] = r.uniform(6, 10, n), r.uniform(6, 10, n)
    f[2, :n], f[4, :n] = 0.001, 0.001
    f[5, :n] = 0.55
    f[5, n - 1] = 0.95
    f[6:9, :n] = r.uniform(0, 1, (3, n))
    f[9, :n] = np.linspace(1.0, 2.5, n)
    f[10:13, :n] = np.array([0.05, -0.05, -1.0])[:, None] / np.sqrt(1.005)
    f[13, :n] = 0.3
    f[14, :n] = np.arange(n)
    f[15, :n] = f[12, :n] * f[9, :n]
    feats = torch.as_tensor(f, device=cuda_device)
    offs = torch.tensor([0, n + 4], device=cuda_device)
    counts = torch.tensor([n], device=cuda_device)
    K = torch.tensor([[12.0, 0, 8.0], [0, 12.0, 8.0], [0, 0, 1.0]])
    args = (feats, offs, counts, 1, 16, 16, K, PARAMS, (0.1, 0.2, 0.3))
    color, aux, _ = blend_fwd(*args)
    assert (aux[0, :, 0] == n - 1).all() and (aux[0, :, 4] < 1e-3).all()
    dcolor = torch.randn((1, 256, 8), generator=torch.Generator().manual_seed(3))
    dcolor[..., 7] = 0.0
    dcolor = dcolor.to(cuda_device)
    got = blend_bwd(*args, color, aux, dcolor).cpu().numpy()
    ref = blend_bwd_ref(*args, color, aux, dcolor).cpu().numpy()
    assert (got[[10, 11, 12, 15], n - 1] != 0).all()
    assert (got[9:13, :n - 1] == 0).all()
    for row in GRAD_ROWS:
        np.testing.assert_allclose(got[row], ref[row],
                                   atol=1e-4 * np.abs(ref[row]).max(), rtol=0)
