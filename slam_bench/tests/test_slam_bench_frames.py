"""The benchmark's frame generator against the port's synthetic sequence
(`dqo_map_tpu_torch/data/synthetic.py`), at a small size and one seed."""

import numpy as np
import pytest

from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from slam_bench.frames import FramePool, Scene, camera_path


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_frames_match_the_port_generator(seed):
    W, H, n = 64, 48, 5
    _, cams = synthetic_sequence(n, W, H, seed=seed, with_detections=True)
    camera = {"width": W, "height": H, "fx": 0.75 * W, "fy": 0.75 * W,
              "cx": W / 2, "cy": H / 2}
    traffic = {"path": {"kind": "orbit", "step_rad": 0.03, "radius": 0.9},
               "pool_frames": n, "depth_noise": None,
               "detections": {"objects": 3, "box_noise_px": 2.0}}
    pool = FramePool(camera, traffic, seed, "cpu")
    for i, c in enumerate(cams):
        np.testing.assert_allclose(pool.poses[i], c.c2w, atol=1e-12)
        np.testing.assert_allclose(pool.images[i], c.image, atol=1e-6)
        np.testing.assert_allclose(pool.depths[i], c.depth, atol=1e-5)
        assert len(pool.detections[i]) == len(c.detections)
        for a, b in zip(pool.detections[i], c.detections):
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-9)
            assert a["cat"] == b["cat"]


def test_kinect_noise_follows_the_seed_and_the_depth():
    camera = {"width": 40, "height": 30, "fx": 30.0, "fy": 30.0,
              "cx": 20.0, "cy": 15.0}
    traffic = {"path": {"kind": "orbit", "step_rad": 0.01355, "radius": 1.4},
               "pool_frames": 3, "depth_noise": "kinect", "detections": None}
    a = FramePool(camera, traffic, 3, "cpu")
    b = FramePool(camera, traffic, 3, "cpu")
    c = FramePool(camera, traffic, 4, "cpu")
    np.testing.assert_array_equal(a.depths, b.depths)
    assert not np.array_equal(a.depths, c.depths)
    d0 = Scene(3).render(a.poses, np.array([[30.0, 0, 20.0], [0, 30.0, 15.0],
                                            [0, 0, 1]]), 40, 30, "cpu")[1]
    d0 = d0.numpy()
    resid = (a.depths - d0)[d0 > 0] / (0.0012 + 0.0019 * (d0[d0 > 0] - 0.4) ** 2)
    assert abs(resid.std() - 1.0) < 0.1 and abs(resid.mean()) < 0.1


def test_layout_seed_fixes_the_geometry_and_the_seed_the_colours():
    a, b = Scene(5, layout_seed=0), Scene(6, layout_seed=0)
    ref = Scene(0)
    for oa, ob, o0 in zip(a.objects, b.objects, ref.objects):
        np.testing.assert_array_equal(oa["center"], o0["center"])
        np.testing.assert_array_equal(ob["axes"], o0["axes"])
    assert not np.array_equal(a.face_colors, b.face_colors)
    np.testing.assert_array_equal(a.face_colors, Scene(5).face_colors)
