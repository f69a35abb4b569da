"""The port's multi-device mapping (`dqo_map_tpu_torch/parallel/dp.py`)
against the JAX package's (`dqo_map_tpu/parallel/dp.py`) and against
itself on one device, on the CPU: the port's mesh lists the CPU four
times (virtual devices), the JAX package's runs on four of conftest's
eight virtual host devices.

- `dp_optimize_scan` on `test_compact_opt.py`'s scene with three frames
  padded to four by a weight-0 repeat, the keyframe scan's form (stable
  subset, tile masks) and the final pass's (whole frames, SSIM, no depth
  term, on the flattened scene): against JAX's to `test_torch_scans.py`'s
  tolerances (iteration 0's gradients to 2e-4 of each field's largest,
  the loss to 1e-5 relative and its curve to 1%, rows by median and
  share), and the port's four devices against its one to the same row
  tolerances and the loss curve to 1e-5 relative: the same step up to the
  order of the shards' sums;
- `dp_optimize_step`, one step, four devices against one and against JAX's;
- the keyframe batch's slots, weights and zero-weight padding
  (`dp_slots`) against the batch JAX's `Mapping.global_optimization`
  hands its `dp_optimize_scan` (`dqo_map_tpu/slam/mapper.py:1514-1527`),
  for a keyframe scan and a final pass whose batch does not divide by
  the mesh;
- `shard_objects_refine` against the port's unsharded `refine_objects`
  and against JAX's sharded refinement (1e-5, as
  `tests/test_parallel.py:115-146`), on turned ellipsoids fitting boxes
  off the centre: there every parameter's gradient is well above
  rounding (`tests/test_parallel.py`'s upright ellipsoids in centred
  boxes have rotation gradients at rounding level, where Adam's first
  steps are lr x sign(g) and the two batch sizes' CPU products round to
  either sign);
- a `parallel_enabled` `SLAMSystem.run()` of 5 frames at 64x48 on four
  devices against one, to `tests/test_parallel.py:176-186`'s bounds
  (poses 1e-5, positions 1e-4, PSNR within 0.1 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from dqo_map_tpu.models import gaussian_map as jgm
from dqo_map_tpu.parallel import dp as jdp
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu_torch.convert import map_state_to_numpy
from dqo_map_tpu_torch.models import gaussian_map as gm
from dqo_map_tpu_torch.ops.rasterize import RenderSettings
from dqo_map_tpu_torch.parallel import dp
from dqo_map_tpu_torch.slam import mapper
from test_compact_opt import _scene
from test_torch_optimize import port_frames, port_state
from test_torch_scans import _grads_held_as_jax, _held_as_jax

ITERS = 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorded_grads(monkeypatch):
    """Every Adam step's gradients: {step: {field: array}}, the JAX
    package's data-parallel scan's and the port's (any scan)."""
    jrec, prec = {}, {}
    jadam, padam = jdp.adam_update, mapper.adam_update

    def jax_adam(params, grads, st, lrs, mask, **kw):
        jax.debug.callback(lambda s, g: jrec.__setitem__(
            int(s), {k: np.asarray(v) for k, v in g.items()}), st.step, grads)
        return jadam(params, grads, st, lrs, mask, **kw)

    def port_adam(params, grads, st, lrs, mask, **kw):
        prec[st.step] = {k: v.detach().numpy().copy() for k, v in grads.items()}
        return padam(params, grads, st, lrs, mask, **kw)

    jdp._dp_scan_factory.cache_clear()       # retrace with the recording step
    monkeypatch.setattr(jdp, "adam_update", jax_adam)
    monkeypatch.setattr(mapper, "adam_update", port_adam)
    yield jrec, prec
    jdp._dp_scan_factory.cache_clear()


def _padded(frames):
    """The scene's three frames and a weight-0 repeat of the last."""
    out = {k: (jnp.concatenate([v, v[-1:]]) if k in dp.BATCHED else v)
           for k, v in frames.items()}
    return out, [1.0 / 3] * 3 + [0.0]


def _scan_args(mode):
    """The scene's three frames padded to four. For the final pass's form
    its Gaussians flattened, as `test_torch_scans.py::_flat_scene` does:
    without a depth term an isotropic Gaussian's rotation gradient is
    rounding noise."""
    state, frames, settings, lrs, weights = _scene(F=3)
    if mode == "final":
        flat = np.log(np.array([0.06, 0.06, 0.015], np.float32))
        alive = np.asarray(state.status)[:, None] != jgm.DEAD
        state = state._replace(scaling=jnp.asarray(
            np.where(alive, flat, np.asarray(state.scaling))))
        weights = dict(weights, depth=0.0, ssim=0.2)
    frames, fweight = _padded(frames)
    kw = dict(subset="stable", with_tile_mask=mode != "final",
              use_ssim=mode == "final")
    return state, frames, fweight, settings, lrs, weights, kw


def _port_scan(n_dev, state, frames, fweight, settings, lrs, weights, kw):
    pset = RenderSettings(width=settings.width, height=settings.height)
    return dp.dp_optimize_scan(dp.make_mesh(n_dev, "cpu"), port_state(state),
                               port_frames(frames), fweight, lrs, weights,
                               pset, ITERS, gm.STABLE, 0.1, **kw)


@pytest.mark.parametrize("mode", ["keyframe", "final"])
def test_dp_optimize_scan_matches_jax(mode, recorded_grads):
    jrec, prec = recorded_grads
    state, frames, fweight, settings, lrs, weights, kw = _scan_args(mode)
    js, jr = jdp.dp_optimize_scan(jdp.make_mesh(4), state, frames, fweight,
                                  lrs, weights, settings, ITERS, jgm.STABLE,
                                  0.1, **kw)
    jax.effects_barrier()            # the recording callbacks have run
    ps, pr = _port_scan(4, state, frames, fweight, settings, lrs, weights, kw)
    assert sorted(jrec) == sorted(prec) == list(range(ITERS))
    n = int(state.count)
    _grads_held_as_jax(jrec, prec, n)
    got = (pr["total_loss"] + pr["scale_loss"]).numpy()
    ref = np.asarray(jr["loss"])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    g = map_state_to_numpy(ps)
    r = {k: np.asarray(v) for k, v in js._asdict().items()}
    status = np.asarray(state.status)[:n]
    _held_as_jax(state, g, r, jrec, np.arange(n), status == jgm.STABLE)
    # three live slots on four devices: the fourth renders nothing
    assert pr["iters"] == ITERS and pr["blends"] == 3 * ITERS


@pytest.mark.parametrize("mode", ["keyframe", "final"])
def test_dp_optimize_scan_4_devices_matches_1(mode, recorded_grads):
    _, prec = recorded_grads
    state, frames, fweight, settings, lrs, weights, kw = _scan_args(mode)
    s4, r4 = _port_scan(4, state, frames, fweight, settings, lrs, weights, kw)
    grads4 = dict(prec)
    s1, r1 = _port_scan(1, state, frames, fweight, settings, lrs, weights, kw)
    for k in ("total_loss", "scale_loss"):
        np.testing.assert_allclose(r4[k].numpy(), r1[k].numpy(), rtol=1e-5)
    n = int(state.count)
    status = np.asarray(state.status)[:n]
    _held_as_jax(state, map_state_to_numpy(s4), map_state_to_numpy(s1),
                 prec, np.arange(n), status == jgm.STABLE)
    for k in grads4[0]:
        scale = np.abs(prec[0][k]).max() + 1e-30
        np.testing.assert_allclose(grads4[0][k] / scale, prec[0][k] / scale,
                                   atol=1e-6, err_msg=k)


def test_dp_optimize_step_matches_jax_and_one_device():
    state, frames, settings, lrs, weights = _scene(F=4)
    n = int(state.count)
    js, _, jloss = jdp.dp_optimize_step(
        jdp.make_mesh(4), state, frames,
        jmapper.adam_init(jmapper.get_params(state)), lrs, weights, settings,
        0.1)
    pset = RenderSettings(width=settings.width, height=settings.height)
    ps, pf = port_state(state), port_frames(frames)
    out = {}
    for n_dev in (4, 1):
        opt = mapper.adam_init({k: getattr(ps, k)[:n] for k in mapper.OPT_FIELDS})
        out[n_dev] = dp.dp_optimize_step(dp.make_mesh(n_dev, "cpu"), ps, pf,
                                         opt, lrs, weights, pset, 0.1)
    (s4, o4, l4), (s1, _, l1) = out[4], out[1]
    np.testing.assert_allclose(float(l4), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    assert o4.step == 1
    for k in ("xyz", "sh"):
        # one Adam step moves a row by lr x sign(g): held where the JAX
        # package's own 8-device test holds it (1e-5)
        a = getattr(s4, k)[:n].numpy()
        np.testing.assert_allclose(a, getattr(s1, k)[:n].numpy(), atol=1e-5)
        d = np.abs(a - np.asarray(getattr(js, k))[:n]).reshape(n, -1).max(1)
        assert np.median(d) <= 1e-5 and (d > 1e-3).mean() <= 0.05, k


def _mappings(tmp_path, n_keyframes):
    """A JAX and a port `Mapping` over the scene's map, with its frames as
    keyframes and a four-device mesh each; their `dp_optimize_scan`
    replaced by a recorder of the batch it is handed."""
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu_torch.config import default_config
    state, frames, settings, _, _ = _scene(F=n_keyframes)
    W, H = settings.width, settings.height
    cfg = dict(save_path=str(tmp_path), final_global_iter=1, capacity=512,
               gaussian_update_iter=2)
    jm = jmapper.Mapping(jax_default_config(**cfg), W, H)
    pm = mapper.Mapping(default_config(**cfg), W, H, "cpu")
    pf = port_frames(frames)
    for f in range(n_keyframes):
        jcam = {k: frames[k][f] for k in ("w2c", "full_proj", "cam_pos")}
        jcam.update({k: frames[k] for k in ("K", "tan_fovx", "tan_fovy")})
        jm.keyframes.append((None, jcam, {k: frames[k][f] for k in
                                          ("color", "depth", "normal")}))
        pm.keyframes.append((None, mapper._frame_cam(pf, f),
                             {k: pf[k][f] for k in ("color", "depth", "normal")}))
    jm.state, pm.state = state, port_state(state)
    jm.mesh, pm.mesh = jdp.make_mesh(4), dp.make_mesh(4, "cpu")
    return jm, pm


def test_dp_slots_match_jax(tmp_path, monkeypatch):
    seen = {}

    def recorder(pkg):
        def scan(mesh, state, frames, fweight, *a, **kw):
            seen[pkg] = ({k: np.asarray(v) for k, v in frames.items()
                          if k in dp.BATCHED}, list(fweight), kw)
            zero = jnp.zeros(1) if pkg == "jax" else 0
            return state, {k: zero for k in (
                "dropped_entries", "clipped_cells", "num_entries",
                "tile_dropped", "iters", "total_loss", "scale_loss")}
        return scan

    monkeypatch.setattr(jdp, "dp_optimize_scan", recorder("jax"))
    monkeypatch.setattr(dp, "dp_optimize_scan", recorder("port"))
    # a keyframe scan over 2 keyframes: 3 slots (the older repeated), one
    # weight-0 repeat; a final pass over 2: 2 slots, two repeats
    for select, want in ((3, [1 / 3] * 3 + [0.0]), (-1, [0.5, 0.5, 0, 0])):
        jm, pm = _mappings(tmp_path, 2)
        jm.global_optimization(select)
        pm.global_optimization(select)
        (jf, jw, jkw), (pf, pw, pkw) = seen["jax"], seen["port"]
        np.testing.assert_allclose(pw, jw, rtol=1e-7)
        np.testing.assert_allclose(pw, want, rtol=1e-7)
        assert pkw["with_tile_mask"] == jkw["with_tile_mask"] == (select != -1)
        assert pkw["use_ssim"] == jkw["use_ssim"] == (select == -1)
        assert pkw["subset"] == jkw["subset"] == "stable"
        for k in ("w2c", "color", "depth", "render_mask", "tile_mask"):
            assert (pf[k] == jf[k]).all(), (select, k)
        # the scans drew their schedules alike (unused on this path)
        assert (pm._host_rng.bit_generator.state
                == jm._host_rng.bit_generator.state)


def test_shard_objects_refine_matches_unsharded_and_jax():
    from dqo_map_tpu.models.quadrics import MAX_OBJECTS, OBS_CAP
    from dqo_map_tpu_torch.models.quadrics import refine_objects
    O = MAX_OBJECTS
    rng = np.random.default_rng(3)
    axes = rng.uniform(0.1, 0.4, (O, 3)).astype(np.float32)
    # turned ellipsoids and boxes off the centre: every parameter has a
    # gradient well above rounding (at rounding level Adam's step is
    # lr x sign(g), whatever the sign)
    R = Rotation.random(O, random_state=4).as_matrix().astype(np.float32)
    center = np.concatenate([rng.uniform(-0.5, 0.5, (O, 2)),
                             rng.uniform(1.5, 2.5, (O, 1))], -1).astype(np.float32)
    corner = rng.uniform(4.0, 12.0, (O, OBS_CAP, 2))
    obs_bbox = np.concatenate([corner, corner + rng.uniform(
        10.0, 20.0, (O, OBS_CAP, 2))], -1).astype(np.float32)
    K = np.float32([[24.0, 0, 16.0], [0, 24.0, 16.0], [0, 0, 1]])
    obs_P = np.broadcast_to(K @ np.eye(4, dtype=np.float32)[:3],
                            (O, OBS_CAP, 3, 4)).copy()
    obs_valid = np.ones((O, OBS_CAP), bool)
    opt_mask = np.ones(O, bool)
    rand_idx = rng.integers(0, OBS_CAP, (6, O)).astype(np.int32)
    args = (axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask)
    targs = [torch.as_tensor(a) for a in args]
    sharded = dp.shard_objects_refine(dp.make_mesh(4, "cpu"), *targs,
                                      rand_idx, iters=6)
    whole = refine_objects(*targs, rand_idx, iters=6)
    jsharded = jdp.shard_objects_refine(
        jdp.make_mesh(4), *(jnp.asarray(a) for a in args),
        jnp.asarray(rand_idx), iters=6)
    for s, w, j in zip(sharded, whole, jsharded):
        assert np.isfinite(s.numpy()).all()
        np.testing.assert_allclose(s.numpy(), w.numpy(), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(j), atol=1e-5)
    assert not np.allclose(sharded[2].numpy(), center)     # it refined


def test_make_mesh_clips(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = dp.make_mesh(10**6, "cuda")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert "only 2 available" in capsys.readouterr().out
    assert dp.make_mesh(None, "cuda").size == 2
    assert dp.make_mesh(1, "cuda").size == 1
    assert dp.make_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    assert dp.make_mesh(None, "cpu").size == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.make_mesh(None, "cuda")


def _parallel_run(tmp_path, n_devices):
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    out = tmp_path / f"dev{n_devices}"
    cfg = default_config(
        type="Synthetic", save_path=str(out), use_object=False,
        use_gt_pose=True, capacity=8192, add_capacity=2048,
        uniform_sample_num=1200, gaussian_update_frame=2,
        gaussian_update_iter=6, stable_confidence_thres=6,
        # the keyframe scan from frame 2 on
        keyframe_trans_thes=0.0001, keyframe_theta_thes=0.01,
        global_keyframe_num=2, min_depth=0.1, max_depth=8.0, memory_length=3,
        final_global_iter=2, parallel_enabled=True,
        parallel_devices=n_devices)
    _, cams = synthetic_sequence(5, width=64, height=48)
    system = SLAMSystem(cfg, cameras=cams, device="cpu")
    assert system.mapping.mesh.size == n_devices
    result = system.run(eval_every=0, verbose=False, max_frames=5)
    return system, result, np.load(out / "save_traj" / "pose_es.npy")


def test_parallel_slam_4_devices_matches_1(tmp_path):
    sys4, res4, poses4 = _parallel_run(tmp_path, 4)
    sys1, res1, poses1 = _parallel_run(tmp_path, 1)
    sc = sys4.mapping.scan_counts
    assert sc["global"] >= 1 and sc["final"] == 1
    assert sc == sys1.mapping.scan_counts
    np.testing.assert_allclose(poses4, poses1, atol=1e-5)
    for k in ("xyz", "sh"):
        np.testing.assert_allclose(getattr(sys4.mapping.state, k).numpy(),
                                   getattr(sys1.mapping.state, k).numpy(),
                                   atol=1e-4)
    assert res4["psnr"] > 18, res4
    assert abs(res4["psnr"] - res1["psnr"]) < 0.1
