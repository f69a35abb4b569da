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
  maps and n_touched exactly. K1 runs one CTA per tile, in the binning's
  `tile_order`, walking the tile's entries in staged batches, each warp of
  pixels leaving once its pixels are all done and the CTA once all are; a
  tile's result does not depend on the order or on the other tiles, so
  K1 under another order, or with one tile live, gives the same bits.
- K2: each thread's terms are the plain version's, in its order, but the
  CTA sums an entry's terms over the tile's 256 pixels in another order (a
  warp's lanes over their pixels, then a reduce-scatter across the warp)
  than the plain version's `torch.sum`. So the zero structure must match
  exactly, and each gradient row to 1e-4 of that row's largest magnitude:
  256 float32 terms summed in two orders differ by at most about 256 x
  6e-8 = 1.5e-5 of the largest term. K2 runs one CTA per tile, which walks
  the tile's entries in staged batches; the hand-made tiles below are
  longer than the main path's scenes make them.

The two kernels' launch order, the binning's `tile_order`, is held
against a numpy construction on the CPU, and so are the wrappers' checks
of their arguments.
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


def scene_entries(device, P=3000, W=200, H=136, seed=5, masked=False,
                  align=256, max_chunks=32):
    """Binned, packed entries of a random scene of flat splats, in
    `align`-sized blocks of at most `max_chunks` a tile; with `masked`, a
    random half of the tiles is masked off and left empty."""
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
    b = binning.bin_gaussians(pre, W, H, 16, 16, tile_mask, align=align,
                              max_chunks=max_chunks)
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


@pytest.mark.parametrize("align", [128, 256])
def test_bwd_tile_order_puts_crowded_tiles_first(align):
    """K2's CTA i walks tile `tile_order[i]`: every tile once, by live
    entries, most first, ties in tile order; so a tile at the per-tile cap
    launches first and masked-off tiles, with no entries, last."""
    max_chunks = 1 if align == 128 else 2
    feats, b, K, W, H = scene_entries("cpu", P=6000, W=96, H=64, masked=True,
                                      align=align, max_chunks=max_chunks)
    counts = b.tile_counts.numpy()
    order = b.tile_order.numpy()
    assert order.dtype == np.int64
    assert (order == sorted(range(len(counts)),
                            key=lambda t: (-counts[t], t))).all()
    capped = np.nonzero(counts == align * max_chunks)[0]
    empty = np.nonzero(counts == 0)[0]
    assert len(capped) and len(empty) and b.tile_dropped > 0
    assert set(order[:len(capped)]) == set(capped)
    assert set(order[len(order) - len(empty):]) == set(empty)


@pytest.mark.parametrize("case", ["no tiles", "one tile more",
                                  "one tile less", "int32", "2-D", "float"])
def test_blend_bwd_refuses_a_tile_order_that_does_not_fit(case):
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    o = b.tile_order
    bad = {"no tiles": o[:0], "one tile more": torch.cat([o, o[:1]]),
           "one tile less": o[1:], "int32": o.int(), "2-D": o[None, :],
           "float": o.float()}[case]
    color, aux, _ = blend_blocks_ref(feats, b.tile_offsets, b.tile_counts, T,
                                     16, W, K, PARAMS, (0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="tile_order"):
        blend_bwd(feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
                  (0.0, 0.0, 0.0), color, aux, torch.ones_like(color),
                  tile_order=bad)


@pytest.mark.parametrize("case", ["no tiles", "one tile more",
                                  "one tile less", "int32", "2-D", "float"])
def test_blend_fwd_refuses_a_tile_order_that_does_not_fit(case):
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    o = b.tile_order
    bad = {"no tiles": o[:0], "one tile more": torch.cat([o, o[:1]]),
           "one tile less": o[1:], "int32": o.int(), "2-D": o[None, :],
           "float": o.float()}[case]
    with pytest.raises(ValueError, match="tile_order"):
        blend_fwd(feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
                  (0.0, 0.0, 0.0), tile_order=bad)


@pytest.mark.parametrize("kernel", ["blend_fwd", "blend_bwd"])
def test_blend_kernels_refuse_a_tile_order_on_another_device(kernel):
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    elsewhere = torch.empty(T, dtype=torch.int64, device="meta")
    args = (feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
            (0.0, 0.0, 0.0))
    if kernel == "blend_bwd":
        color, aux, _ = blend_blocks_ref(*args)
        args = args + (color, aux, torch.ones_like(color))
    fn = blend_fwd if kernel == "blend_fwd" else blend_bwd
    with pytest.raises(ValueError, match="tile_order must be on cpu"):
        fn(*args, tile_order=elsewhere)


def test_blend_fwd_refuses_a_background_off_16_bytes():
    """K1 reads each pixel's background channels as a float4."""
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    bgt = torch.zeros(T * 256 * 8 + 1)[1:].view(T, 256, 8)
    assert bgt.is_contiguous() and bgt.data_ptr() % 16
    with pytest.raises(ValueError, match="bgt must start on 16 bytes"):
        blend_fwd(feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
                  (0.0, 0.0, 0.0), bgt)


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


def check_bwd_kernel(args, bgt, tile_order):
    """K2 on the card against its plain version, its CTAs on the tiles in
    `tile_order` (in tile order where None): one launch of the right
    variant, the zero structure exactly, each gradient row to 1e-4 of its
    largest magnitude. Returns both results and the plain version's
    stats."""
    name = "blend_bwd_bg" if bgt is not None else "blend_bwd"
    launches = dict(LAUNCHES)
    got = blend_bwd(*args, bgt=bgt, tile_order=tile_order)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == launches[name] + 1
    assert sum(LAUNCHES.values()) == sum(launches.values()) + 1
    stats = {}
    ref = blend_bwd_ref(*args, bgt=bgt, stats=stats)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    flip = (got != 0) != (ref != 0)
    assert not flip.any(), int(flip.sum())
    assert (got[[13, 14]] == 0).all()
    for r in GRAD_ROWS:
        np.testing.assert_allclose(got[r], ref[r],
                                   atol=1e-4 * np.abs(ref[r]).max(), rtol=0,
                                   err_msg=f"row {r}")
    return got, ref, stats


def random_cotangent(T, device, seed):
    dcolor = torch.randn((T, 256, 8), generator=torch.Generator().manual_seed(seed))
    dcolor[..., 7] = 0.0
    return dcolor.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("align", [256, 128])
@pytest.mark.parametrize("with_bg", [False, True])
def test_blend_bwd_kernel_matches_plain_version(cuda_device, with_bg, align):
    """At the keyframe scan's layout (align 256) and the local scans' (128)."""
    feats, b, K, W, H = scene_entries(cuda_device, align=align)
    T = b.tile_offsets.shape[0] - 1
    bg = (0.2, 0.3, 0.4)
    bgt = bg_operand(T, cuda_device) if with_bg else None
    color, aux, _ = blend_fwd(feats, b.tile_offsets, b.tile_counts, T, 16, W,
                              K, PARAMS, bg, bgt)
    args = (feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS, bg,
            color, aux, random_cotangent(T, cuda_device, 11))
    got, ref, _ = check_bwd_kernel(args, bgt, b.tile_order)
    assert (got[:, ~b.entry_valid.cpu().numpy()] == 0).all()
    for r in GRAD_ROWS:
        assert np.abs(ref[r]).max() > 0, r


def hand_tiles(counts, align, device, seed, opacity, hit_at=None):
    """Tiles side by side in one tile row, with `counts` live entries of
    wide splats (G ~ 1 over the tile) of opacity in `opacity`, depth rising,
    laid out in `align`-sized blocks as the binning lays them; with
    `hit_at`, tile 0's entry there is an opaque small splat at the tile's
    centre, the hit of the pixels around it. Returns the blend's first
    seven arguments."""
    r = np.random.default_rng(seed)
    padded = [-(-c // align) * align for c in counts]
    offs = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)
    f = np.zeros((16, int(offs[-1])), np.float32)
    for t, c in enumerate(counts):
        e = slice(offs[t], offs[t] + c)
        f[0, e] = 16 * t + r.uniform(4, 12, c)
        f[1, e] = r.uniform(4, 12, c)
        f[2, e] = f[4, e] = r.uniform(1e-4, 1e-3, c)
        f[3, e] = r.uniform(-5e-5, 5e-5, c)
        f[5, e] = r.uniform(*opacity, c)
        f[6:9, e] = r.uniform(0, 1, (3, c))
        f[9, e] = np.linspace(1.0, 3.0, c)
        f[10:13, e] = (np.array([0.05, -0.05, -1.0]) / np.sqrt(1.005))[:, None]
        f[13, e] = 0.3
        f[14, e] = np.arange(c)
        f[15, e] = f[12, e] * f[9, e]
    if hit_at is not None:
        f[0:6, hit_at] = (8.0, 8.0, 0.05, 0.0, 0.05, 0.95)
    K = torch.tensor([[12.0, 0, 8.0 * len(counts)], [0, 12.0, 8.0],
                      [0, 0, 1.0]])
    to = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    args = (to(f), to(offs), to(np.array(counts, np.int64)), len(counts), 16,
            16 * len(counts), K)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long walk", "whole batches",
                                  "surface at a batch boundary"])
def test_blend_bwd_kernel_walks_long_tiles(cuda_device, case):
    """Tiles longer than the main path's scenes make them, each walked by
    one CTA in staged batches of entries: a tile of 1,500 low-alpha entries
    whose pixels walk past entry 1,024, with a hit in a later batch than
    the one where T fell below T_threshold; two tiles whose live counts
    (512 and 256) are whole numbers of batches and of align blocks,
    launched last tile first; with the background, a surface that every
    pixel crosses at the first entry of a batch (entry 128)."""
    bgt, order = None, None
    if case == "long walk":
        base = hand_tiles([1500], 256, cuda_device, 21, (0.006, 0.009),
                          hit_at=1400)
    elif case == "whole batches":
        base = hand_tiles([512, 256], 256, cuda_device, 22, (0.02, 0.04))
        order = torch.tensor([1, 0], device=cuda_device)
    else:
        base = hand_tiles([384], 128, cuda_device, 23, (0.006, 0.009))
        depth = base[0][9].cpu().numpy()
        g = torch.Generator().manual_seed(24)
        bgt = torch.zeros((1, 256, 8))
        bgt[..., 0:3] = torch.rand((1, 256, 3), generator=g)
        bgt[..., 3] = float((depth[127] + depth[128]) / 2)
        bgt[..., 4] = 0.3 + 0.7 * torch.rand((1, 256), generator=g)
        bgt = bgt.to(cuda_device)
    args = base + (PARAMS, (0.1, 0.2, 0.3))
    color, aux, _ = blend_fwd(*args, bgt=bgt)
    T = base[3]
    got, ref, stats = check_bwd_kernel(
        args + (color, aux, random_cotangent(T, cuda_device, 25)), bgt, order)
    if case == "long walk":
        # T falls below T_threshold past entry 1,024, before the hit
        assert stats["pairs"] > 256 * 4 * 256
        hit = aux[0, :, 0].cpu().numpy()
        assert (hit == 1400).sum() > 0 and (got[[10, 11, 12, 15], 1400] != 0).all()
    elif case == "surface at a batch boundary":
        assert (got[6:9, 128:] != 0).any() and stats["pairs"] == 256 * 384


@pytest.mark.cuda
def test_blend_bwd_kernel_routes_a_hit_past_the_T_cut(cuda_device):
    """One tile: nineteen wide entries of alpha ~0.5 take T below
    T_threshold before the opaque entry that is every pixel's hit; K2 must
    route the depth and normal cotangents to it there, as its plain
    version does, from a later batch of entries than the one where T
    fell."""
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
    got, _, stats = check_bwd_kernel(
        args + (color, aux, random_cotangent(1, cuda_device, 3)), None, None)
    # every pixel's T fell below T_threshold within entries 8..15, the
    # kernel's second batch of 8; its hit, entry 19, is in the third
    assert 8 * 256 < stats["pairs"] < 16 * 256
    assert (got[[10, 11, 12, 15], n - 1] != 0).all()
    assert (got[9:13, :n - 1] == 0).all()


def check_fwd_kernel(args, bgt, tile_order):
    """K1 on the card against its plain version, CTA i on tile
    `tile_order[i]` (tile i where None): one launch of the right variant;
    the index maps and n_touched exactly, colour, normal, T and weights to
    1e-5, depth to 1e-4. Returns the kernel's blocks and the plain
    version's stats."""
    name = "blend_fwd_bg" if bgt is not None else "blend_fwd"
    launches = dict(LAUNCHES)
    got = blend_fwd(*args, bgt=bgt, tile_order=tile_order)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == launches[name] + 1
    assert sum(LAUNCHES.values()) == sum(launches.values()) + 1
    stats = {}
    ref = blend_blocks_ref(*args, bgt=bgt, stats=stats)
    (color, aux, nt), (rcolor, raux, rnt) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in ref])
    assert (aux[..., 0:2] == raux[..., 0:2]).all()
    assert (nt == rnt).all(), int((nt != rnt).sum())
    for what, a, r, tol in (
            ("colour and normal", color[..., [0, 1, 2, 4, 5, 6, 7]],
             rcolor[..., [0, 1, 2, 4, 5, 6, 7]], 1e-5),
            ("weights and T", aux[..., 2:7], raux[..., 2:7], 1e-5),
            ("depth", np.stack([color[..., 3], aux[..., 7]]),
             np.stack([rcolor[..., 3], raux[..., 7]]), 1e-4)):
        np.testing.assert_allclose(a, r, atol=tol, rtol=0, err_msg=what)
    return got, stats


@pytest.mark.cuda
@pytest.mark.parametrize("with_bg", [False, True])
def test_blend_fwd_kernel_gives_the_same_bits_in_any_launch_order(
        cuda_device, with_bg):
    """The binning's order, a random permutation and tile order give the
    same blocks bit for bit; masked-off tiles, with no entries, among
    them."""
    feats, b, K, W, H = scene_entries(cuda_device, masked=True, align=128)
    T = b.tile_offsets.shape[0] - 1
    bgt = bg_operand(T, cuda_device) if with_bg else None
    args = (feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
            (0.2, 0.3, 0.4))
    want, _ = check_fwd_kernel(args, bgt, b.tile_order)
    assert int((b.tile_counts == 0).sum()) > 0
    shuffled = torch.randperm(T, generator=torch.Generator().manual_seed(8))
    for order in (shuffled.to(cuda_device), None):
        got = blend_fwd(*args, bgt=bgt, tile_order=order)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long walk", "whole batches",
                                  "surface at a batch boundary"])
def test_blend_fwd_kernel_walks_long_tiles(cuda_device, case):
    """Tiles longer than the main path's scenes make them, at align 128: a
    tile of 1,500 low-alpha entries whose pixels walk past entry 1,024 to
    a hit at entry 1,400; three tiles whose live counts (512, 256, 64) are
    whole numbers of K1's batches of 32, launched last tile first; with the
    background, a surface that every pixel crosses at the first entry of a
    batch (entry 128)."""
    bgt, order = None, None
    if case == "long walk":
        base = hand_tiles([1500], 128, cuda_device, 31, (0.006, 0.009),
                          hit_at=1400)
    elif case == "whole batches":
        base = hand_tiles([512, 256, 64], 128, cuda_device, 32, (0.02, 0.04))
        order = torch.tensor([2, 1, 0], device=cuda_device)
    else:
        base = hand_tiles([384], 128, cuda_device, 33, (0.006, 0.009))
        depth = base[0][9].cpu().numpy()
        g = torch.Generator().manual_seed(34)
        bgt = torch.zeros((1, 256, 8))
        bgt[..., 0:3] = torch.rand((1, 256, 3), generator=g)
        bgt[..., 3] = float((depth[127] + depth[128]) / 2)
        bgt[..., 4] = 0.3 + 0.7 * torch.rand((1, 256), generator=g)
        bgt = bgt.to(cuda_device)
    args = base + (PARAMS, (0.1, 0.2, 0.3))
    (color, aux, nt), stats = check_fwd_kernel(args, bgt, order)
    if case == "long walk":
        assert stats["pairs"] > 256 * 1024
        assert (aux[0, :, 0] == 1400).sum() > 0
    elif case == "whole batches":
        assert (nt[:512] > 0).any() and (nt[512:768] > 0).any()
        assert (nt[768:768 + 64] > 0).any()
    else:
        # the surface lands at entry 128 on every pixel
        assert stats["pairs"] == 256 * 384


@pytest.mark.cuda
@pytest.mark.parametrize("with_bg", [False, True])
def test_blend_fwd_crowded_tile_alone_gives_its_rows(cuda_device, with_bg):
    """The first tile of `tile_order` with the others' counts 0 (how
    chip_smoke.py times the crowded tile alone) gives that tile's rows and
    n_touched of the full call bit for bit, and the other tiles the init
    values."""
    feats, b, K, W, H = scene_entries(cuda_device, align=128)
    T = b.tile_offsets.shape[0] - 1
    bgt = bg_operand(T, cuda_device) if with_bg else None
    args = (feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
            (0.2, 0.3, 0.4))
    color, aux, nt = blend_fwd(*args, bgt=bgt, tile_order=b.tile_order)
    first = int(b.tile_order[0])
    assert int(b.tile_counts[first]) == int(b.tile_counts.max())
    tiles = torch.arange(T, device=cuda_device)
    counts = torch.where(tiles == first, b.tile_counts, 0)
    alone = args[:2] + (counts,) + args[3:]
    (c1, a1, n1), _ = check_fwd_kernel(alone, bgt, b.tile_order)
    assert torch.equal(c1[first], color[first])
    assert torch.equal(a1[first], aux[first])
    beg = int(b.tile_offsets[first])
    live = slice(beg, beg + int(b.tile_counts[first]))
    assert torch.equal(n1[live], nt[live]) and int(n1[live].sum()) > 0
    assert int(n1.sum()) == int(n1[live].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("with_bg", [False, True])
def test_blend_fwd_kernel_leaves_saturated_pixels(cuda_device, with_bg):
    """Two tiles of 160 entries (ten batches): in tile 0 near-opaque wide
    splats saturate every pixel within a few entries, so the whole CTA
    leaves after its first batch; in tile 1 twelve opaque walls cover only
    its left eight columns, whose warps leave early while the right half,
    which never finds a hit, walks on to the end."""
    base = list(hand_tiles([160, 160], 128, cuda_device, 41, (0.006, 0.009)))
    f = base[0].cpu().numpy()
    r = np.random.default_rng(42)
    f[5, 0:160] = r.uniform(0.9, 0.99, 160)
    walls = slice(256, 256 + 12)
    f[0, walls], f[1, walls] = 16.0, 8.0
    f[2, walls], f[3, walls], f[4, walls] = 0.018, 0.0, 1e-6
    f[5, walls] = 0.99
    base[0] = torch.as_tensor(f, device=cuda_device)
    bgt = None
    if with_bg:
        g = torch.Generator().manual_seed(43)
        bgt = torch.zeros((2, 256, 8))
        bgt[..., 0:3] = torch.rand((2, 256, 3), generator=g)
        bgt[..., 3] = float((f[9, 2] + f[9, 3]) / 2)
        bgt[..., 4] = 0.5
        bgt = bgt.to(cuda_device)
    args = tuple(base) + (PARAMS, (0.1, 0.2, 0.3))
    (color, aux, nt), stats = check_fwd_kernel(args, bgt, None)
    left = torch.arange(256, device=cuda_device) % 16 < 8
    hit = aux[..., 0]
    assert (hit[0] >= 0).all() and (aux[0, :, 6] < PARAMS.T_threshold).all()
    assert (hit[1][left] >= 0).all() and (hit[1][~left] == -1).all()
    assert (aux[1, left, 6] < PARAMS.T_threshold).all()
    assert stats["pairs"] < 0.35 * 256 * 320


@pytest.mark.parametrize("kernel", ["blend_fwd", "blend_bwd"])
@pytest.mark.parametrize("which", ["tile_offsets", "tile_counts"])
def test_blend_kernels_refuse_tile_lists_on_another_device(kernel, which):
    """Each kernel reads its tile lists by pointer on `feats`' device, so a
    list on any other device is refused, not copied."""
    feats, b, K, W, H = scene_entries("cpu", P=200, W=48, H=32)
    T = b.tile_offsets.shape[0] - 1
    lists = {"tile_offsets": b.tile_offsets, "tile_counts": b.tile_counts}
    lists[which] = torch.empty_like(lists[which], device="meta")
    args = (feats, lists["tile_offsets"], lists["tile_counts"], T, 16, W, K,
            PARAMS, (0.0, 0.0, 0.0))
    if kernel == "blend_bwd":
        color, aux, _ = blend_blocks_ref(feats, b.tile_offsets, b.tile_counts,
                                         *args[3:])
        args = args + (color, aux, torch.ones_like(color))
    fn = blend_fwd if kernel == "blend_fwd" else blend_bwd
    with pytest.raises(ValueError, match=f"{which} must be on feats' device"):
        fn(*args)


@pytest.mark.cuda
def test_blend_kernels_launch_on_their_tensors_device(cuda_device):
    """With another card current (where there is one), each kernel runs on
    its tensors' card and gives what it gives there with that card
    current: K1's maps bit for bit, K2's gradient rows bit for bit."""
    n = torch.cuda.device_count()
    for d in range(n):
        dev = torch.device("cuda", d)
        feats, b, K, W, H = scene_entries(dev)
        T = b.tile_offsets.shape[0] - 1
        args = (feats, b.tile_offsets, b.tile_counts, T, 16, W, K, PARAMS,
                (0.2, 0.3, 0.4))
        dcolor = random_cotangent(T, dev, 5)
        results = []
        for current in (d, (d + 1) % n):
            with torch.cuda.device(current):
                color, aux, nt = blend_fwd(*args, tile_order=b.tile_order)
                dfeats = blend_bwd(*args, color, aux, dcolor,
                                   tile_order=b.tile_order)
            torch.cuda.synchronize(dev)
            assert color.device == aux.device == dfeats.device == dev
            results.append((color, aux, nt, dfeats))
        for a, r in zip(*results):
            assert torch.equal(a, r)
