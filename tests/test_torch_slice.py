"""The port's forward slice of `SLAMSystem.step` against the JAX package:
four synthetic frames at 64x48 on the CPU, ICP tracking on every frame
(`use_gt_pose=False`), 1,200 samples, capacity 8192, 2048 adds a frame.

The JAX package cannot run `gaussian_update_iter=0` through its own `step`
(its optimize scan indexes an empty schedule), so its Tracker and Mapping
are driven through their per-frame methods in `step`'s order, with the
optimize branch of `Mapping.mapping` left out: map_preprocess -> tracking
-> _update_bucket, gaussians_add -> processed_frames -> (on the optimize
cadence) check_keyframe -> the end-of-frame render where `step` takes a
fresh one -> finalize_frame -> update_last_status -> time += 1. The port
runs its own `SLAMSystem.step` with `gaussian_update_iter=0`, fed the JAX
package's uniform draws for every densification.

Per frame: pose to 1e-4; alive / stable counts and the slot watermark
exact; the map field by field (positions, log-scales, rotations, SH to
1e-5, the rest exact); and every model render of the port against the JAX
package's render of the same map at the same camera (both carried across
with `convert.py`), at the rasterizer tolerances of
`test_torch_rasterize.py`.

The two packages' end-of-frame renders of their own maps are compared too,
but a render is ill-conditioned in the map: flat splats seen edge-on
amplify the last-bit differences of the KNN scale init (the log and the
distance sums round differently on the two sides, 1e-6 relative) into
per-mille changes of a few pixels' alpha. So there all but 0.1% of the
pixels must agree to 1e-5 and 99.9% of the index maps exactly.
"""

import dataclasses

import numpy as np
import jax
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence
from dqo_map_tpu.models.gaussian_map import MapState as JMapState
from dqo_map_tpu.slam.renderer import render_state as jrender_state
from dqo_map_tpu.slam.system import SLAMSystem as JSLAMSystem
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.convert import map_state_to_numpy
from dqo_map_tpu_torch.slam.system import SLAMSystem
from test_torch_rasterize import assert_maps_match, port_camera

W, H, FRAMES = 64, 48, 4
SETTINGS = dict(
    type="Synthetic", use_gt_pose=False, use_orb_backend=False,
    use_object=False, capacity=8192, add_capacity=2048,
    uniform_sample_num=1200, gaussian_update_frame=6,
    stable_confidence_thres=20, global_keyframe_num=3, min_depth=0.1,
    max_depth=8.0, memory_length=5,
    # the JAX render bucket spans the whole capacity, so its ladder never
    # compacts the map (the port has no ladder)
    initial_bucket=8192)


def _jax_draws(key, n):
    """The uniform draws of the JAX Mapping's next densification."""
    _, k = jax.random.split(key)
    k1, k2 = jax.random.split(k)
    return [torch.as_tensor(np.array(jax.random.uniform(kk, (n,))))
            for kk in (k1, k2)]


def _jax_render(mp, state_np: dict, cam_inputs: dict) -> dict:
    """The JAX package's model render of a map carried over from the port."""
    cam = {k: (np.float32(v) if np.ndim(v) == 0 else
               jax.numpy.asarray(v.cpu().numpy() if torch.is_tensor(v) else v))
           for k, v in cam_inputs.items()}
    st = JMapState(**{k: jax.numpy.asarray(v) for k, v in state_np.items()})
    out = jrender_state(st, cam, mp.settings, "global", bucket=mp.bucket)
    return {k: np.asarray(v) for k, v in out.items()}


def _counts(status):
    status = np.asarray(status)
    return int((status != 0).sum()), int((status == 2).sum())


def test_slice_matches_jax(tmp_path):
    _, cams = synthetic_sequence(FRAMES, width=W, height=H)
    jsys = JSLAMSystem(jax_default_config(save_path=str(tmp_path), **SETTINGS,
                                          gaussian_update_iter=50),
                       cameras=[dataclasses.replace(c, c2w=c.c2w.copy())
                                for c in cams])
    psys = SLAMSystem(default_config(save_path=str(tmp_path), **SETTINGS,
                                     gaussian_update_iter=0),
                      cameras=[port_camera(c) for c in cams], device="cpu")
    tr, mp = jsys.tracker, jsys.mapping
    renders = []           # every port model render: (map, camera, output)
    port_render = psys.mapping.get_render_output

    def recording_render(cam_inputs):
        state = map_state_to_numpy(psys.mapping.state)
        out = port_render(cam_inputs)
        renders.append((state, cam_inputs, out))
        return out

    psys.mapping.get_render_output = recording_render
    n_renders = 0
    for i in range(FRAMES):
        f = jsys.cameras[i]
        draws = _jax_draws(mp.key, W * H)
        fm = tr.map_preprocess(f, i)
        tr.tracking(f, fm)
        mp._update_bucket()
        mp.gaussians_add(f, fm, i)
        n_renders += i > 0
        mp.processed_frames.append((f.render_inputs(), fm))
        if len(mp.processed_frames) > mp.memory_length:
            mp.processed_frames.pop(0)
        optimize = (mp.time + 1) % mp.args.gaussian_update_frame == 0 or mp.time == 0
        if optimize:
            mp.check_keyframe(f, fm, i)
        if optimize or mp.model_map is None:
            out = mp.get_render_output(f.render_inputs())
            n_renders += 1
        else:
            out = mp.model_map
        mp.finalize_frame(out, fm)
        tr.update_last_status(f, out["depth"], fm["depth_map"], out["normal"],
                              fm["normal_map_w"])
        mp.time += 1

        psys.mapping._uniform_draws = lambda n, d=draws: d
        info = psys.step(psys.cameras[i], i)
        psys.mapping.time += 1

        np.testing.assert_allclose(psys.tracker.poses_np()[-1],
                                   np.asarray(tr.pose_es[-1], np.float64),
                                   atol=1e-4, err_msg=f"frame {i} pose")
        pst = map_state_to_numpy(psys.mapping.state)
        jst = {k: np.asarray(v) for k, v in mp.state._asdict().items()}
        assert _counts(pst["status"]) == _counts(jst["status"]), f"frame {i}"
        assert pst["count"] == jst["count"], f"frame {i}"
        for k in pst:
            if k in ("xyz", "sh", "scaling", "rotation"):
                np.testing.assert_allclose(pst[k], jst[k], atol=1e-5, rtol=0,
                                           err_msg=f"frame {i} {k}")
            else:
                assert (pst[k] == jst[k]).all(), f"frame {i} {k}"

        # the port's renders against the JAX package's of the same maps
        for state_np, cam_inputs, pout in renders:
            assert_maps_match(pout, _jax_render(mp, state_np, cam_inputs))
        assert renders and info["render"] is renders[-1][2]
        renders.clear()
        # ... and the two end-of-frame renders of the two maps
        got = {k: v.numpy() for k, v in info["render"].items() if torch.is_tensor(v)}
        bad = np.abs(got["render"] - np.asarray(out["render"])).max(-1) > 1e-5
        assert bad.mean() <= 1e-3, f"frame {i}: {bad.sum()} pixels"
        for k in ("depth_index_map", "color_index_map"):
            assert (got[k] == np.asarray(out[k])).mean() >= 0.999, k
        assert int(out["dropped_entries"]) == 0
    assert psys.mapping.renders == n_renders
    assert psys.mapping.keyframe_ids == mp.keyframe_ids
    assert mp.dropped_entries()[0] == 0
    assert _counts(mp.state.status)[0] > 1000   # the map really grew
