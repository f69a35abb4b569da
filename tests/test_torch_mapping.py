"""The port's mapping pieces (`dqo_map_tpu_torch.slam.mapper`,
`models.gaussian_map`, `ops.knn`, `ops.error_accum`, `utils.image`)
against the JAX package, on the CPU.

Both sides start from the same map, carried across with `convert.py`, and
the same frame maps. The port's densification is fed the JAX package's
uniform draws for the same key chain, through the `sample_pixels` seam.
Tolerances: counts, statuses, ticks and counters exact; positions, SH and
rotations to 1e-6; log-scales to 1e-5 (they pass through a log, whose last
bit differs between the two libraries); KNN indices exact and squared
distances to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.config import default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence
from dqo_map_tpu.models import gaussian_map as jgm
from dqo_map_tpu.ops.knn import knn2 as jknn2
from dqo_map_tpu.ops.knn import scales_from_knn as jscales_from_knn
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu.slam.renderer import Renderer as JRenderer
from dqo_map_tpu.slam.renderer import render_state as jrender_state
from dqo_map_tpu.slam.tracker import preprocess_frame as jpreprocess_frame
from dqo_map_tpu.utils import image as jim
from dqo_map_tpu_torch.convert import map_state_from_numpy, map_state_to_numpy
from dqo_map_tpu_torch.models import gaussian_map as gm
from dqo_map_tpu_torch.ops.knn import knn2, scales_from_knn
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.utils import image as im
from test_torch_rasterize import port_camera

W, H = 64, 48
CAPACITY, MAX_ADD = 4096, 2048
TOL = {"xyz": 1e-6, "sh": 1e-6, "rotation": 1e-6, "scaling": 1e-5,
       "opacity": 1e-6, "confidence": 1e-6, "sem_rgb": 0.0}


def _np(d: dict) -> dict:
    return {k: np.array(v) for k, v in d.items()}


def _torch(d: dict) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def jax_state(d: dict):
    return jgm.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_states_match(port, ref):
    a, b = map_state_to_numpy(port), _np(ref._asdict())
    assert a["count"] == b["count"]
    for k in a:
        if k in TOL:
            np.testing.assert_allclose(a[k], b[k], atol=TOL[k], rtol=0, err_msg=k)
        else:
            assert (a[k] == b[k]).all(), f"{k}: {(a[k] != b[k]).sum()} differ"


def _draws(key, n):
    k1, k2 = jax.random.split(key)
    return [torch.as_tensor(np.array(jax.random.uniform(kk, (n,))))
            for kk in (k1, k2)]


@pytest.fixture(scope="module")
def scene():
    """Two frames' maps with ground-truth poses and their cameras."""
    _, cams = synthetic_sequence(2, width=W, height=H)
    fms = []
    for cam in cams:
        fm = jpreprocess_frame(jnp.asarray(cam.depth), jnp.asarray(cam.image),
                               jnp.asarray(cam.K), levels=3, min_depth=0.1,
                               max_depth=8.0)
        c2w = jnp.asarray(cam.c2w, jnp.float32)
        fm = {k: fm[k] for k in ("depth_map", "color_map", "vertex_map_c",
                                 "normal_map_c")}
        fm["vertex_map_w"] = jim.transform_map(fm["vertex_map_c"], c2w)
        fm["normal_map_w"] = jim.rotate_map(fm["normal_map_c"], c2w)
        fms.append(_np(fm))
    cfg = default_config(min_depth=0.1, max_depth=8.0, uniform_sample_num=1200)
    a = cfg.map
    dcfg = (a.uniform_sample_num, a.add_transmission_thres,
            a.transmission_sample_ratio, a.add_depth_thres, a.add_color_thres,
            a.error_sample_ratio, a.init_opacity,
            *[float(x) for x in a.xyz_factor], a.scale_factor, a.min_radius,
            a.max_radius)
    settings = JRenderer(a, W, H).settings._replace(entry_cap=1 << 16)
    return cams, fms, dcfg, settings


def _densify_both(jstate, fm, cam, model_map, is_first, key, time, dcfg, settings):
    ref, n_ref = jmapper.densify_step(
        jstate, {k: jnp.asarray(v) for k, v in fm.items()}, cam.render_inputs(),
        {k: jnp.asarray(v) for k, v in model_map.items()}, jnp.asarray(is_first),
        key, jnp.int32(time), jnp.int32(time), settings, MAX_ADD, dcfg)
    port, n_port = mapper.densify_step(
        map_state_from_numpy(_np(jstate._asdict()), "cpu"), _torch(fm),
        port_camera(cam).render_inputs("cpu"), _torch(model_map), is_first,
        _draws(key, H * W), time, time,
        MAX_ADD, dcfg)
    return ref, int(n_ref), port, n_port


def test_densify_matches_jax(scene):
    cams, fms, dcfg, settings = scene
    key = jax.random.key(11)
    zero = {"T_map": np.ones((H, W), np.float32),
            "depth": np.zeros((H, W), np.float32),
            "render": np.zeros((H, W, 3), np.float32),
            "depth_index_map": np.full((H, W), -1, np.int32),
            "color_index_map": np.full((H, W), -1, np.int32)}
    j0, n0, p0, m0 = _densify_both(jgm.empty_map(CAPACITY), fms[0], cams[0],
                                   zero, True, key, 0, dcfg, settings)
    assert n0 == m0 > 500
    assert_states_match(p0, j0)

    # a second frame over a map that is half stable: exercises the coverage
    # filter and the attach to stable surfaces
    stable = np.arange(CAPACITY) % 2 == 0
    j0 = j0._replace(status=jnp.where(jnp.asarray(stable) & (j0.status == 1),
                                      2, j0.status))
    model_map = _np(jrender_state(j0, cams[1].render_inputs(), settings, "global"))
    j1, n1, p1, m1 = _densify_both(j0, fms[1], cams[1], model_map, False,
                                   jax.random.key(12), 1, dcfg, settings)
    assert n1 == m1 > 0
    assert_states_match(p1, j1)


def test_sample_pixels_matches_jax(rng):
    mask = rng.uniform(size=(H, W)) < 0.3
    key = jax.random.key(3)
    ridx, rval = jim.sample_pixels(key, jnp.asarray(mask), 512, jnp.int32(400))
    draws = torch.as_tensor(np.array(jax.random.uniform(key, (H * W,))))
    idx, val = im.sample_pixels(draws, torch.as_tensor(mask), 512,
                                torch.tensor(400))
    assert (idx.numpy() == np.asarray(ridx)).all()
    assert (val.numpy() == np.asarray(rval)).all()


@pytest.fixture
def random_map(rng):
    """A map with a random mix of statuses, confidences, counters, ages."""
    n, cap = 900, 1024
    d = _np(jgm.empty_map(cap)._asdict())
    d["xyz"][:n] = rng.uniform(-1, 1, (n, 3))
    d["scaling"][:n] = rng.uniform(np.log(0.005), np.log(0.05), (n, 3))
    d["scaling"][:5] = np.log(2.0)          # a few giants
    d["rotation"][:n] = rng.normal(size=(n, 4))
    d["opacity"][:n] = rng.normal(size=n)
    d["sh"][:n] = rng.normal(size=(n, 16, 3)) * 0.1
    d["confidence"][:n] = rng.uniform(0, 40, n)
    d["add_tick"][:n] = rng.integers(0, 200, n)
    d["depth_err_cnt"][:n] = rng.integers(0, 12, n)
    d["color_err_cnt"][:n] = rng.integers(0, 12, n)
    d["status"][:n] = rng.integers(0, 3, n)
    d["count"] = np.int32(n)
    for k in d:
        d[k] = d[k].astype(np.asarray(jgm.empty_map(1)._asdict()[k]).dtype)
    return d


def test_map_lifecycle_matches_jax(random_map, rng):
    ref = jax_state(random_map)
    port = map_state_from_numpy(random_map, "cpu")
    assert_states_match(port, ref)
    mask = rng.uniform(size=ref.capacity) < 0.3
    jm, pm = jnp.asarray(mask), torch.as_tensor(mask)
    steps = [
        (lambda s: jgm.delete_points(s, jm), lambda s: gm.delete_points(s, pm)),
        (lambda s: jgm.promote_points(s, jm, 20.0),
         lambda s: gm.promote_points(s, pm, 20.0)),
        (lambda s: jgm.release_points(s, jm, jnp.int32(7)),
         lambda s: gm.release_points(s, pm, 7)),
        (lambda s: jmapper.gaussians_fix(s, 20.0),
         lambda s: mapper.gaussians_fix(s, 20.0)),
        (lambda s: jmapper.gaussians_delete(s, jnp.int32(150), 120),
         lambda s: mapper.gaussians_delete(s, 150, 120)),
        (lambda s: jmapper.gaussians_delete(s, jnp.int32(150), 120, unstable=False),
         lambda s: mapper.gaussians_delete(s, 150, 120, unstable=False)),
        (jgm.compact, gm.compact),
        (lambda s: jgm.grow(s, 2048), lambda s: gm.grow(s, 2048)),
    ]
    for jf, pf in steps:
        ref, port = jf(ref), pf(port)
        assert_states_match(port, ref)
    assert int(ref.count) < random_map["count"]   # compaction freed slots


def test_error_remove_and_prune_match_jax(random_map, rng, scene):
    cams, fms, dcfg, settings = scene
    ref = jax_state(random_map)
    port = map_state_from_numpy(random_map, "cpu")
    out = _np(jrender_state(ref, cams[0].render_inputs(), settings, "global"))
    # index maps that hit stable gaussians, so that counters move
    ids = rng.integers(-1, random_map["count"], (H, W)).astype(np.int32)
    out["depth_index_map"], out["color_index_map"] = ids, np.roll(ids, 3)
    out["depth"] = out["depth"] + rng.normal(0, 0.3, (H, W)).astype(np.float32)
    jr = jmapper.error_remove_from(ref, {k: jnp.asarray(v) for k, v in out.items()},
                                   {k: jnp.asarray(v) for k, v in fms[0].items()},
                                   0.1, 0.1, 1000.0, jnp.int32(9))
    pr = mapper.error_remove_from(port, _torch(out), _torch(fms[0]),
                                  0.1, 0.1, 1000.0, 9)
    assert_states_match(pr, jr)
    assert (np.asarray(jr.status) != np.asarray(ref.status)).any()

    nt = (rng.uniform(size=ref.capacity) < 0.5).astype(np.int32)
    cin = cams[0].render_inputs()
    jp = jmapper.prune_untouched(ref, jnp.asarray(nt), cin["w2c"], cin["K"],
                                 W, H, jnp.int32(100), 60)
    pcin = port_camera(cams[0]).render_inputs("cpu")
    pp = mapper.prune_untouched(port, torch.as_tensor(nt), pcin["w2c"],
                                pcin["K"], W, H, 100, 60)
    assert_states_match(pp, jp)


@pytest.mark.parametrize("select", [-1, 3])
def test_global_optimization_without_keyframes_matches_jax(random_map,
                                                           tmp_path, select):
    """`global_optimization` before any keyframe: the final pass (-1)
    still promotes every unstable Gaussian first, as the JAX package's
    final pass does; the keyframe scan (a keyframe count) leaves the map
    as it was. Neither runs a scan."""
    from dqo_map_tpu_torch.config import default_config as port_config
    cfg = dict(save_path=str(tmp_path), capacity=1024)
    jm = jmapper.Mapping(default_config(**cfg), W, H)
    pm = mapper.Mapping(port_config(**cfg), W, H, "cpu")
    jm.state = jax_state(random_map)
    pm.state = map_state_from_numpy(random_map, "cpu")
    if select == -1:
        jm.global_optimization(is_end=True)
        pm.global_optimization()
    else:
        jm.global_optimization(select)
        pm.global_optimization(select)
    assert_states_match(pm.state, jm.state)
    assert (random_map["status"] == gm.UNSTABLE).any()
    status = map_state_to_numpy(pm.state)["status"]
    assert (status == gm.UNSTABLE).any() == (select != -1)
    assert pm.scan_counts["final"] == pm.scan_counts["global"] == 0


def test_knn_matches_exact_jax(rng):
    M, N = 300, 2000
    q = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    c = np.concatenate([q, rng.uniform(-1, 1, (N - M, 3))]).astype(np.float32)
    ma = rng.uniform(size=N) < 0.4
    mb = rng.uniform(size=N) < 0.9
    (rda, ria), (rdb, rib) = jknn2(jnp.asarray(q), jnp.asarray(c),
                                   jnp.asarray(ma), jnp.asarray(mb), k=8,
                                   col_chunk=512, exact=True)
    (gda, gia), (gdb, gib) = knn2(torch.as_tensor(q), torch.as_tensor(c),
                                  torch.as_tensor(ma), torch.as_tensor(mb),
                                  k=8, col_chunk=512)
    for rd, ri, gd, gi in ((rda, ria, gda, gia), (rdb, rib, gdb, gib)):
        assert (gi.numpy() == np.asarray(ri)).all()
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-6, rtol=0)

    rad = rng.uniform(0.001, 0.02, N).astype(np.float32)
    valid = rng.uniform(size=M) < 0.9
    excl = rng.uniform(size=N) < 0.1
    args = (0.9, (1.0, 1.0, 0.1), 0.001, 0.05)
    rs, rk = jscales_from_knn(rdb, rib, jnp.asarray(valid), jnp.asarray(rad),
                              jnp.asarray(excl), *args)
    gs, gk = scales_from_knn(gdb, gib, torch.as_tensor(valid),
                             torch.as_tensor(rad), torch.as_tensor(excl), *args)
    assert (gk.numpy() == np.asarray(rk)).all()
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=1e-5, rtol=0)


@pytest.mark.parametrize("check_max", [True, False])
def test_accumulate_gaussian_error_matches_jax(rng, check_max):
    from dqo_map_tpu.ops.error_accum import accumulate_gaussian_error as jacc
    from dqo_map_tpu_torch.ops.error_accum import accumulate_gaussian_error
    P = 500
    maps = [rng.uniform(0, 0.3, (H, W)).astype(np.float32) for _ in range(3)]
    ci = rng.integers(-1, P, (H, W)).astype(np.int32)
    di = rng.integers(-1, P, (H, W)).astype(np.int32)
    args = (0.1, 0.1, 0.2, check_max)
    ref = jacc(P, *(jnp.asarray(a) for a in (*maps, ci, di)), *args)
    got = accumulate_gaussian_error(P, *(torch.as_tensor(a) for a in (*maps, ci, di)),
                                    *args)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_tile_masks_match_jax(rng):
    err = rng.uniform(0, 1, (H, W)).astype(np.float32)
    pix = err > 0.7
    for jf, pf, arg in ((jim.pixelmask_to_tilemask, im.pixelmask_to_tilemask, pix),
                        (jim.transmission_to_tilemask, im.transmission_to_tilemask, pix)):
        ref = np.asarray(jf(jnp.asarray(arg), 16))
        got = pf(torch.as_tensor(arg), 16).numpy()
        assert (got == ref).all()
        back = im.tilemask_to_pixelmask(torch.as_tensor(got), 16, H, W).numpy()
        assert (back == np.asarray(jim.tilemask_to_pixelmask(jnp.asarray(ref), 16, H, W))).all()
