"""The port's bench entry point and the mapper's stage timers against the
JAX package's, on the CPU.

- The stage tags: each package's own `SLAMSystem.step` over four
  synthetic frames at 64x48 with the stage timers on (the feature backend,
  3 Adam steps on every 2nd frame, frame 3 a keyframe, so the local scans,
  the keyframe scan, the model renders and the tracker's backend phases
  all run): the same tags, each recorded as often, in both packages.
- `Mapping.dropped_entries()`: the JAX 4-tuple from the host's receipts,
  its `dropped` 0, and its one warning where the per-tile cap cut.
- `python -m dqo_map_tpu_torch.bench`'s `main` on the CPU at
  BENCH_FRAMES=4, BENCH_WARMUP=2, BENCH_PROFILE_FRAMES=2 and 64x48: one
  JSON line with `bench.py`'s keys but `rungs` (read from `bench.py`
  itself), plus `device` and `card`; stages for both frame classes.
  The bench's map capacity (2^19), its densification budget (16,384
  points a frame, searched against every candidate) and its 50 Adam steps
  make one CPU frame take seconds even at 64x48, so this test cuts those
  three to 16,384, 1,024 and 4; the rest is the bench's configuration. The
  ladder knobs of the JAX bench have no counterpart and are refused.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dqo_map_tpu.config import default_config as jax_default_config
from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
from dqo_map_tpu.slam import mapper as jmapper
from dqo_map_tpu.slam.system import SLAMSystem as JSLAMSystem
from dqo_map_tpu_torch import bench
from dqo_map_tpu_torch.config import default_config
from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from dqo_map_tpu_torch.slam import mapper
from dqo_map_tpu_torch.slam.system import SLAMSystem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _bench_keys() -> set:
    """The keys of the JSON line the JAX package's `bench.py` prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no JSON dict")


def test_bench_main_on_cpu(tmp_path, monkeypatch, capsys, one_thread):
    for k, v in dict(BENCH_FRAMES=4, BENCH_WARMUP=2, BENCH_PROFILE_FRAMES=2,
                     BENCH_W=W, BENCH_H=H).items():
        monkeypatch.setenv(k, str(v))
    config = bench.bench_config

    def small(*a, **kw):
        cfg = config(*a, **kw)
        assert (cfg.map.capacity, cfg.map.add_capacity,
                cfg.map.gaussian_update_iter) == (1 << 19, 16384, 50)
        return dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, capacity=16384, add_capacity=1024,
            gaussian_update_iter=4))

    monkeypatch.setattr(bench, "bench_config", small)
    out = bench.main(["--device", "cpu", "--save-path", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == (_bench_keys() - {"rungs"}) | {"device", "card"}
    assert out["metric"] == ("tracking+mapping FPS (synthetic office0-scale "
                             "64x48, 40800 samples, full ICP, mean "
                             "post-warmup)")
    assert out["dropped_entries"] == 0 and out["entries_max"] > 0
    assert out["device"] == "cpu" and out["card"] is None
    assert out["eval_frame"] == 3 and out["unit"] == "fps"
    assert np.isfinite([out["value"], out["psnr"], out["ate_cm"],
                        out["psnr_final"], out["ate_full_cm"]]).all()
    # frames 2 and 3 timed: 3 is steady, frame 5 (profiled) optimizes
    assert out["steady_frame_ms"] > 0 and out["optimize_frame_ms"] is None
    steady, opt = out["stages"]["steady"], out["stages"]["optimize"]
    assert steady["tracker"]["n"] == 1 and "add/densify" in steady
    scan = opt["local/optimize_scan x4"]
    # per_iter_ms from the unrounded mean, mean_ms rounded to 0.1
    assert scan["n"] == 1 and abs(4 * scan["per_iter_ms"]
                                  - scan["mean_ms"]) <= 0.1


def test_bench_refuses_the_ladder_knobs(monkeypatch):
    monkeypatch.setenv("BENCH_ENTRY_RUNG", str(1 << 20))
    with pytest.raises(SystemExit, match="BENCH_ENTRY_RUNG"):
        bench.main(["--device", "cpu"])
