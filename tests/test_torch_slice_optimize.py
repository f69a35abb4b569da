"""The port's `SLAMSystem.step` with optimize steps against the JAX
package: four synthetic frames at 64x48 on the CPU, ICP tracking on every
frame, 8 Adam steps on every 2nd frame, for both local-scan modes
(`local_opt_mode` "bg", the default, and "global").

The keyframe angle is cut to 2.5 degrees (the path turns 1.7 degrees a
frame) and the promotion threshold to 5, so the four frames run every kind
of scan: frame 0 a local scan over an empty stable set, frame 1 a local
scan in front of a stable background, frame 3 (a keyframe) the keyframe
scan over frames 0 and 3. The JAX package is driven through its
`SLAMSystem.step` order with the port fed the JAX package's uniform draws,
as in `test_torch_slice.py`.

A scan's parameters are not comparable row by row here. The frame's new
Gaussians sit on the frame's own surface and colours, so the depth and
colour L1 terms are at their kinks: |render - frame| is at rounding level
at many pixels and its sign, the gradient, differs between the packages
(it differs between the JAX package's own two blend implementations
too). Adam turns such a gradient into a full step either way. So this test
holds what those steps cannot move far: poses to 1e-4, keyframes and the
scans run exactly, alive and stable counts to 1%, status and confidence
row by row on 99% of the slots, and the end-of-frame renders: PSNR
against the frame within 0.3 dB of the JAX package's, mean colour
difference under 1e-2 and 90% of the depth index map equal. The scans
themselves are held row by row in `test_torch_scans.py`, on a scene away
from those kinks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence
from dqo_map_tpu.slam.system import SLAMSystem as JSLAMSystem
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.convert import map_state_to_numpy
from dqo_map_tpu_torch.slam.system import SLAMSystem
from test_torch_rasterize import port_camera
from test_torch_slice import _counts, _jax_draws

W, H, FRAMES = 64, 48, 4
SETTINGS = dict(
    type="Synthetic", use_gt_pose=False, use_orb_backend=False,
    use_object=False, capacity=8192, add_capacity=2048,
    uniform_sample_num=1200, gaussian_update_frame=2, gaussian_update_iter=8,
    stable_confidence_thres=5, global_keyframe_num=3, min_depth=0.1,
    max_depth=8.0, memory_length=5, keyframe_theta_thes=2.5,
    keyframe_trans_thes=10.0, initial_bucket=8192)


def _psnr(img, gt):
    return float(20 * np.log10(1.0 / np.sqrt(np.mean((img - gt) ** 2))))


@pytest.mark.parametrize("mode", ["bg", "global"])
def test_slice_with_optimize_steps_matches_jax(tmp_path, mode):
    _, cams = synthetic_sequence(FRAMES, width=W, height=H)
    cfg = dict(SETTINGS, save_path=str(tmp_path), local_opt_mode=mode)
    jsys = JSLAMSystem(jax_default_config(**cfg),
                       cameras=[dataclasses.replace(c, c2w=c.c2w.copy())
                                for c in cams])
    psys = SLAMSystem(default_config(**cfg),
                      cameras=[port_camera(c) for c in cams], device="cpu")
    tr, mp = jsys.tracker, jsys.mapping
    pm = psys.mapping
    for i in range(FRAMES):
        f = jsys.cameras[i]
        draws = _jax_draws(mp.key, W * H)
        # SLAMSystem.step's order, without its frame-rate sleep
        fm = tr.map_preprocess(f, i)
        tr.tracking(f, fm)
        mp.mapping(f, fm, i, None, defer_finalize=True)
        if mp.did_optimize or mp.model_map is None:
            out = mp.get_render_output(f.render_inputs())
        else:
            out = mp.model_map
        mp.finalize_frame(out, fm)
        tr.update_last_status(f, out["depth"], fm["depth_map"], out["normal"],
                              fm["normal_map_w"])
        mp.time += 1

        pm._uniform_draws = lambda n, d=draws: d
        info = psys.step(psys.cameras[i], i)
        pm.time += 1

        np.testing.assert_allclose(psys.tracker.poses_np()[-1],
                                   np.asarray(tr.pose_es[-1], np.float64),
                                   atol=1e-4, err_msg=f"frame {i} pose")
        assert pm.keyframe_ids == mp.keyframe_ids, f"frame {i}"
        assert pm.did_optimize == mp.did_optimize, f"frame {i}"
        # the scans drew their frame schedules alike
        assert (pm._host_rng.bit_generator.state
                == mp._host_rng.bit_generator.state), f"frame {i}"
        pst = map_state_to_numpy(pm.state)
        jst = {k: np.asarray(v) for k, v in mp.state._asdict().items()}
        (pa, ps), (ja, js) = _counts(pst["status"]), _counts(jst["status"])
        assert abs(pa - ja) <= 0.01 * ja and abs(ps - js) <= 0.01 * max(js, 1), \
            f"frame {i}: alive/stable {pa}/{ps} vs {ja}/{js}"
        n = min(pst["count"], jst["count"])
        for k in ("status", "confidence"):
            assert (pst[k][:n] == jst[k][:n]).mean() >= 0.99, f"frame {i} {k}"

        got = {k: v.numpy() for k, v in info["render"].items() if torch.is_tensor(v)}
        ref = {k: np.asarray(v) for k, v in out.items()}
        gt = cams[i].image
        assert abs(_psnr(got["render"], gt) - _psnr(ref["render"], gt)) <= 0.3, f"frame {i}"
        assert np.abs(got["render"] - ref["render"]).mean() < 1e-2, f"frame {i}"
        assert (got["depth_index_map"] == ref["depth_index_map"]).mean() >= 0.9, f"frame {i}"

    assert mp.keyframe_ids == [0, 3]
    assert pm.scan_counts["local"] == 2 and pm.scan_counts["global"] == 1
    assert pm.scan_counts["iters"] == 3 * SETTINGS["gaussian_update_iter"]
    assert pm.scan_counts["range_renders"] == 2
    assert pm.scan_counts["bg_renders"] == (3 if mode == "bg" else 0)
    assert _counts(pst["status"])[1] > 100        # the scans promoted rows
