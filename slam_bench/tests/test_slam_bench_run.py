"""Whole runs of each cell, cut to a size the CPU holds (`tiny.py`), with
the card's look skipped: the check passes on the program as it is, and
comes out false when the timed path is broken underneath."""

import time

import pytest
import torch

from dqo_map_tpu_torch.models import quadrics as quadrics_mod
from dqo_map_tpu_torch.slam import mapper as mapper_mod
from dqo_map_tpu_torch.slam import tracker as tracker_mod
from slam_bench import harness
from slam_bench.tests.tiny import tiny_cell

SECONDS = {"office0-explore": 30.0, "fr1_desk-handheld": 40.0}


def _run(cell_name, seed=2**32 + 9):
    torch.set_num_threads(4)
    cell = tiny_cell(cell_name)
    return harness.run(cell, seed, SECONDS[cell_name], False,
                       time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_cell_runs_correct(cell):
    res, rows = _run(cell)
    assert res["correct"], rows
    assert 0 <= res["failed"] <= res["attempted"]
    assert set(res["metrics"]) >= {"setup_s", "fps", "psnr_db"}
    assert list(res)[-1] == "check"
    assert all(v is not None and v <= lim for _, v, lim in rows)


def _state_unchanged(monkeypatch):
    def adam_update(params, grads, st, lrs, mask, *a, **kw):
        return params, st._replace(step=st.step + 1)
    monkeypatch.setattr(mapper_mod, "adam_update", adam_update)


def _half_the_batch(monkeypatch):
    orig = mapper_mod.compute_loss

    def compute_loss(render_out, image_input, *a, **kw):
        m = image_input["render_mask"]
        every_other = (torch.arange(m.numel()) % 2 == 0).reshape(m.shape)
        m = m & every_other.to(m.device)
        return orig(render_out, dict(image_input, render_mask=m), *a, **kw)
    monkeypatch.setattr(mapper_mod, "compute_loss", compute_loss)


def _render_altered(monkeypatch):
    orig = mapper_mod.render_state

    def render_state(state, cam, settings, subset="global", *a, **kw):
        out = orig(state, cam, settings, subset, *a, **kw)
        if subset == "global" and not kw.get("tiled"):
            out["render"] = out["render"] * 1.01
        return out
    monkeypatch.setattr(mapper_mod, "render_state", render_state)


def _pose_altered(monkeypatch):
    orig = tracker_mod.icp_pyramid

    def icp_pyramid(*a, **kw):
        pose, p2p, vr = orig(*a, **kw)
        pose = pose.clone()
        pose[0, 3] += 2e-3
        return pose, p2p, vr
    monkeypatch.setattr(tracker_mod, "icp_pyramid", icp_pyramid)


def _objects_altered(monkeypatch):
    orig = quadrics_mod.refine_objects

    def refine_objects(*a, **kw):
        axes, R, center = orig(*a, **kw)
        return axes, R, center + 2e-3
    monkeypatch.setattr(quadrics_mod, "refine_objects", refine_objects)


def _objects_skipped(monkeypatch):
    monkeypatch.setattr(quadrics_mod.ObjectLayer, "optimize_objects",
                        lambda self: None)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_batch": _half_the_batch,
          "render_altered": _render_altered,
          "pose_altered": _pose_altered,
          "objects_altered": _objects_altered,
          "objects_skipped": _objects_skipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    # a seed whose window refines its objects (on frame 11)
    res, rows = _run("office0-explore", seed=5)
    assert not res["correct"], rows
