"""The mapper's stage timers and its render receipts against the JAX
package's, on the CPU.

- The stage tags: each package's own `SLAMSystem.step` over four
  synthetic frames at 64x48 with the stage timers on (the feature backend,
  3 Adam steps on every 2nd frame, frame 3 a keyframe, so the local scans,
  the keyframe scan, the model renders and the tracker's backend phases
  all run): the same tags, each recorded as often, in both packages. The
  benchmark's `tracker_ms`, `densify_ms` and `scan_step_ms` read these
  tags.
- `Mapping.dropped_entries()`: the JAX 4-tuple from the host's receipts,
  its `dropped` 0, and its one warning where the per-tile cap cut.
"""

import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu.slam.system import SLAMSystem as JSLAMSystem
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.slam.system import SLAMSystem

W, H, FRAMES = 64, 48, 4
TAG_RUN = dict(
    type="Synthetic", use_gt_pose=False, use_orb_backend=True,
    use_object=False, capacity=8192, add_capacity=2048,
    uniform_sample_num=1200, gaussian_update_frame=2, gaussian_update_iter=3,
    stable_confidence_thres=2, global_keyframe_num=3, min_depth=0.1,
    max_depth=8.0, memory_length=5, keyframe_theta_thes=2.5,
    keyframe_trans_thes=10.0, initial_bucket=8192,
    sync_tracker2mapper_method="loose", sync_tracker2mapper_frames=2)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage_counts(pkg_mapper, system, cams) -> dict:
    """{tag: times recorded} over `system.step` of every frame, with the
    package's stage timers on."""
    pkg_mapper.profile_enable(True)
    pkg_mapper.stage_times(reset=True)
    try:
        for i, cam in enumerate(cams):
            system.step(cam, i)
            system.mapping.time += 1
        times = pkg_mapper.stage_times(reset=True)
    finally:
        pkg_mapper.profile_enable(False)
    assert all(all(ms >= 0 for ms in v) for v in times.values())
    return {tag: len(ms) for tag, ms in times.items()}


def test_stage_tags_match_jax(tmp_path, one_thread):
    _, jcams = jsequence(FRAMES, width=W, height=H)
    _, pcams = synthetic_sequence(FRAMES, width=W, height=H)
    cfg = dict(TAG_RUN, save_path=str(tmp_path))
    jsys = JSLAMSystem(jax_default_config(**cfg), cameras=jcams)
    psys = SLAMSystem(default_config(**cfg), cameras=pcams, device="cpu")
    jtags = _stage_counts(jmapper, jsys, jcams)
    ptags = _stage_counts(mapper, psys, pcams)
    assert ptags == jtags
    # every kind of stage ran: tracking with the backend, the model
    # renders, densification, the local scans and the keyframe scan
    for tag in ("tracker", "tracker/feature_detect", "tracker/pose_sync",
                "tracker/feature_backend", "render/_render_global",
                "add/densify", "gaussians_add", "local/range_0",
                "local/optimize_scan x3", "local/history_merge",
                "global_optimization", "get_render_output",
                "finalize(fix+err+del)"):
        assert ptags.get(tag, 0) > 0, tag
    assert psys.mapping.keyframe_ids == jsys.mapping.keyframe_ids == [0, 3]
    # the timers are off again: a stage records nothing
    psys.step(pcams[-1], FRAMES)
    assert mapper.stage_times() == {}

    # the receipts of the same run, as the JAX 4-tuple
    dropped, entries_max, clipped, tile_dropped = psys.mapping.dropped_entries()
    r = psys.mapping.receipts
    assert (dropped, entries_max, clipped, tile_dropped) == (
        0, r["num_entries"], r["clipped_cells"], r["tile_dropped"])
    assert entries_max > 0 and all(isinstance(x, int) for x in (
        dropped, entries_max, clipped, tile_dropped))


def test_dropped_entries_warns_once_on_tile_drops(capsys):
    m = mapper.Mapping(default_config(save_path="unused"), 32, 32, "cpu")
    assert m.dropped_entries() == (0, 0, 0, 0)
    m.receipts.update(num_entries=900, clipped_cells=7, tile_dropped=3)
    assert m.dropped_entries() == (0, 900, 7, 3)
    assert m.dropped_entries() == (0, 900, 7, 3)
    assert capsys.readouterr().err.count("truncation occurred") == 1

