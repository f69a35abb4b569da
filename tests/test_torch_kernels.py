"""The port's hand-written kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; on the card, run it alone and without the
JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The comparisons need a CUDA card (marker `cuda`) and skip without one. The
plain version repeats the kernel's float operations in its order (the
library is built without FMA contraction), so colour, T and weights agree
to 1e-5, depth to 1e-4 (the JAX package's tolerances) and the index maps
and n_touched exactly.
"""

import math

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.models.cameras import Camera
from dqo_map_tpu_torch.ops import binning
from dqo_map_tpu_torch.ops.blend import BlendParams, blend_tiles_ref
from dqo_map_tpu_torch.ops.blend_cuda import (blend_fwd, blend_tiles,
                                              pack_entries, unpack_blocks)
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
    launches = blend_fwd.launches
    got = unpack_blocks(*blend_fwd(feats, b.tile_offsets, b.tile_counts, T,
                                   16, W, K, PARAMS, bg), 16, W, H)
    torch.cuda.synchronize()
    assert blend_fwd.launches == launches + 1
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
